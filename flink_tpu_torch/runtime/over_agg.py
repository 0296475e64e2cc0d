"""OVER windowed aggregation — per-row frames over an event-time order
(port of ``flink_tpu/runtime/over_agg.py``: NumPy on both sides, so its
rows equal the reference's bit for bit and in emission order).

reference: StreamExecOverAggregate
(flink-table/flink-table-planner/.../stream/StreamExecOverAggregate.java)
lowering to the flink-table-runtime over-window functions:
RowTimeRowsBoundedPrecedingFunction (ROWS BETWEEN n PRECEDING),
RowTimeRangeBoundedPrecedingFunction (RANGE BETWEEN INTERVAL ... PRECEDING)
and RowTimeRangeUnboundedPrecedingFunction — each buffers rows per key
until the watermark passes their timestamp, then emits every input row
extended with aggregates over its frame.

Re-design: rows buffer in columnar batches; a watermark advance sorts the
ready rows ONCE by (key, rowtime) and computes every frame with
vectorized prefix scans per key segment (cumulative sums for SUM/COUNT/
AVG, per-segment accumulate/sliding windows for MIN/MAX) instead of the
reference's per-row state lookups. Frame context that future rows still
need — the last ``n`` rows (ROWS), rows within the interval (RANGE), or
a running accumulator (UNBOUNDED) — carries over per key.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.records import KEY_ID_FIELD, TIMESTAMP_FIELD, RecordBatch
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.runtime.operators import Operator

#: (func, arg_field or None for COUNT(*), output name)
OverSpec = Tuple[str, Optional[str], str]


def _seg_bounds(kid: np.ndarray) -> np.ndarray:
    """Start index of each key segment in a (key-sorted) array, plus the
    end sentinel."""
    n = len(kid)
    starts = np.flatnonzero(np.r_[True, kid[1:] != kid[:-1]])
    return np.r_[starts, n]


class OverAggOperator(Operator):
    """Event-time OVER aggregation, partitioned by ``key_field``."""

    name = "over_agg"

    def __init__(self, key_field: str, specs: List[OverSpec],
                 mode: str = "ROWS", preceding: Optional[int] = None):
        if mode not in ("ROWS", "RANGE"):
            raise ValueError(f"unsupported OVER mode {mode!r}")
        self.key_field = key_field
        self.specs = list(specs)
        self.mode = mode
        self.preceding = preceding
        #: buffered not-yet-ready batches
        self._pending: List[RecordBatch] = []
        #: ROWS/RANGE: per-key context rows (already emitted, still in
        #: frame reach): kid -> {"ts": array, spec index -> value array}
        self._context: Dict[int, Dict[str, np.ndarray]] = {}
        #: UNBOUNDED: kid -> per-spec accumulator tuples
        self._accs: Dict[int, List[Tuple[float, float]]] = {}
        self._emitted_wm = -(1 << 62)
        self.late_records_dropped = 0

    def open(self, ctx) -> None:
        self.max_parallelism = getattr(ctx, "max_parallelism", 128)

    # ------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch,
                      input_index: int = 0) -> List[RecordBatch]:
        if len(batch) == 0:
            return []
        if not batch.has_timestamps:
            raise RuntimeError(
                "OVER aggregation requires event-time rows (ORDER BY "
                "rowtime) — assign a watermark strategy")
        late = batch.timestamps <= self._emitted_wm
        if late.any():
            self.late_records_dropped += int(late.sum())
            batch = batch.filter(~late)
            if len(batch) == 0:
                return []
        self._pending.append(batch)
        return []

    # -------------------------------------------------------------- fire

    def process_watermark(self, watermark, input_index=0):
        if not self._pending:
            self._emitted_wm = max(self._emitted_wm, watermark)
            return []
        buf = RecordBatch.concat(self._pending)
        ready_mask = buf.timestamps <= watermark
        self._pending = ([buf.filter(~ready_mask)]
                         if (~ready_mask).any() else [])
        ready = buf.filter(ready_mask)
        self._emitted_wm = max(self._emitted_wm, watermark)
        if len(ready) == 0:
            return []
        out = self._compute(ready)
        return [out] if out is not None and len(out) else []

    def close(self) -> List[RecordBatch]:
        return self.process_watermark(MAX_WATERMARK)

    # ------------------------------------------------------------ compute

    def _key_ids(self, batch: RecordBatch) -> np.ndarray:
        if KEY_ID_FIELD in batch.columns:
            return np.asarray(batch[KEY_ID_FIELD], dtype=np.int64)
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        return hash_keys_to_i64(batch[self.key_field])

    def _arg_values(self, batch: RecordBatch, n: int) -> List[np.ndarray]:
        vals = []
        for func, field, _ in self.specs:
            if field is None:
                vals.append(np.ones(n, dtype=np.float64))
            else:
                vals.append(np.asarray(batch[field], dtype=np.float64))
        return vals

    def _compute(self, ready: RecordBatch) -> Optional[RecordBatch]:
        n = len(ready)
        kid = self._key_ids(ready)
        ts = np.asarray(ready.timestamps, dtype=np.int64)
        order = np.lexsort((ts, kid))
        ready = ready.take(order)
        kid, ts = kid[order], ts[order]
        vals = self._arg_values(ready, n)
        if self.preceding is None:
            # UNBOUNDED PRECEDING; RANGE includes rowtime peers, ROWS
            # counts physical rows only
            outs = self._compute_unbounded(
                kid, ts, vals, peers=self.mode == "RANGE")
        else:
            outs = self._compute_bounded(kid, ts, vals)
        out = ready
        for (_, _, out_name), col in zip(self.specs, outs):
            out = out.with_column(out_name, col)
        return out

    # -- UNBOUNDED PRECEDING: running accumulators per key

    def _compute_unbounded(self, kid, ts, vals,
                           peers: bool = True) -> List[np.ndarray]:
        bounds = _seg_bounds(kid)
        outs = [np.empty(len(kid), dtype=np.float64)
                for _ in self.specs]
        for s in range(len(bounds) - 1):
            lo, hi = bounds[s], bounds[s + 1]
            k = int(kid[lo])
            seg_ts = ts[lo:hi]
            # SQL RANGE frames include the current row's PEERS (equal
            # rowtime): every row takes the value at its peer group's
            # last row (reference: RowTimeRangeUnboundedPrecedingFunction
            # aggregates per-timestamp groups); ROWS frames end at the
            # current physical row
            peer_last = (np.searchsorted(seg_ts, seg_ts, side="right")
                         - 1) if peers \
                else np.arange(hi - lo)
            accs = self._accs.get(k)
            if accs is None:
                accs = [(0.0, 0.0)] * len(self.specs)
            new_accs = []
            for i, (func, _, _) in enumerate(self.specs):
                seg = vals[i][lo:hi]
                a_sum, a_cnt = accs[i]
                if func in ("SUM", "AVG", "COUNT"):
                    cs = np.cumsum(seg) + a_sum
                    cn = np.arange(1, hi - lo + 1, dtype=np.float64) \
                        + a_cnt
                    row = (cs if func == "SUM"
                           else cn if func == "COUNT"
                           else cs / cn)
                    outs[i][lo:hi] = row[peer_last]
                    new_accs.append((float(cs[-1]), float(cn[-1])))
                elif func == "MIN":
                    init = a_sum if a_cnt else np.inf
                    acc = np.minimum.accumulate(np.minimum(seg, init))
                    outs[i][lo:hi] = acc[peer_last]
                    new_accs.append((float(acc[-1]), 1.0))
                else:  # MAX
                    init = a_sum if a_cnt else -np.inf
                    acc = np.maximum.accumulate(np.maximum(seg, init))
                    outs[i][lo:hi] = acc[peer_last]
                    new_accs.append((float(acc[-1]), 1.0))
            self._accs[k] = new_accs
        return outs

    # -- ROWS n / RANGE interval PRECEDING: context rows per key

    def _compute_bounded(self, kid, ts, vals) -> List[np.ndarray]:
        bounds = _seg_bounds(kid)
        outs = [np.empty(len(kid), dtype=np.float64)
                for _ in self.specs]
        for s in range(len(bounds) - 1):
            lo, hi = bounds[s], bounds[s + 1]
            k = int(kid[lo])
            ctx = self._context.get(k)
            c = 0 if ctx is None else len(ctx["ts"])
            seg_ts = (ts[lo:hi] if c == 0
                      else np.concatenate([ctx["ts"], ts[lo:hi]]))
            m = len(seg_ts)
            # frame [start, end) for each NEW row (positions c..m-1):
            # ROWS counts physical rows; RANGE is timestamp-bounded and
            # includes the current row's PEERS (equal rowtime — SQL
            # frame semantics, reference:
            # RowTimeRangeBoundedPrecedingFunction)
            pos = np.arange(c, m)
            if self.mode == "ROWS":
                starts = np.maximum(pos - self.preceding, 0)
                ends = pos + 1
            else:
                starts = np.searchsorted(
                    seg_ts, seg_ts[c:] - self.preceding, side="left")
                ends = np.searchsorted(seg_ts, seg_ts[c:], side="right")
            segs = [vals[i][lo:hi] if c == 0 else np.concatenate(
                [ctx[f"v{i}"], vals[i][lo:hi]])
                for i in range(len(self.specs))]
            for i, (func, _, _) in enumerate(self.specs):
                seg = segs[i]
                if func in ("SUM", "AVG", "COUNT"):
                    cs = np.r_[0.0, np.cumsum(seg)]
                    tot = cs[ends] - cs[starts]
                    cnt = (ends - starts).astype(np.float64)
                    outs[i][lo:hi] = (tot if func == "SUM"
                                      else cnt if func == "COUNT"
                                      else tot / cnt)
                else:
                    red = np.minimum if func == "MIN" else np.maximum
                    ident = np.inf if func == "MIN" else -np.inf
                    # per-row reduce over [starts[j], ends[j]); reduceat
                    # on interleaved boundaries does all frames in one
                    # pass. A sentinel identity element keeps every
                    # index < len (ends may equal m), and start == end
                    # cannot occur (a frame always holds its own row).
                    seg_p = np.r_[seg, ident]
                    idx = np.empty(2 * len(pos), dtype=np.int64)
                    idx[0::2] = starts
                    idx[1::2] = ends
                    outs[i][lo:hi] = red.reduceat(seg_p, idx)[0::2]
            # retain context for future rows of this key
            if self.mode == "ROWS":
                keep_from = max(m - self.preceding, 0)
            else:
                keep_from = int(np.searchsorted(
                    seg_ts, seg_ts[-1] - self.preceding, side="left"))
            new_ctx = {"ts": seg_ts[keep_from:]}
            for i, seg in enumerate(segs):
                new_ctx[f"v{i}"] = seg[keep_from:]
            if len(new_ctx["ts"]):
                self._context[k] = new_ctx
            else:
                self._context.pop(k, None)
        return outs

    # --------------------------------------------------------------- state

    def snapshot_state(self) -> Dict[str, Any]:
        pending = (RecordBatch.concat(self._pending).to_pydict()
                   if self._pending else None)
        return {
            "over_pending": pending,
            "over_context": {str(k): {kk: np.asarray(v)
                                      for kk, v in ctx.items()}
                             for k, ctx in self._context.items()},
            "over_accs": {str(k): [list(a) for a in accs]
                          for k, accs in self._accs.items()},
            "over_emitted_wm": self._emitted_wm,
        }

    def restore_state(self, state: Dict[str, Any],
                      key_group_filter=None) -> None:
        from flink_tpu_torch.state.keygroups import assign_key_groups

        def _keep(kid_int: int) -> bool:
            if key_group_filter is None:
                return True
            g = assign_key_groups(
                np.asarray([kid_int], dtype=np.int64),
                self.max_parallelism)[0]
            return g in key_group_filter

        pending = state.get("over_pending")
        self._pending = []
        if pending:
            batch = RecordBatch.from_pydict(
                {k: np.asarray(v) for k, v in pending.items()
                 if k != TIMESTAMP_FIELD},
                timestamps=np.asarray(pending[TIMESTAMP_FIELD])
                if TIMESTAMP_FIELD in pending else None)
            if key_group_filter is not None and len(batch):
                kid = self._key_ids(batch)
                groups = assign_key_groups(kid, self.max_parallelism)
                mask = np.isin(groups,
                               np.asarray(sorted(key_group_filter)))
                batch = batch.filter(mask)
            if len(batch):
                self._pending = [batch]
        self._context = {
            int(k): {kk: np.asarray(v) for kk, v in ctx.items()}
            for k, ctx in state.get("over_context", {}).items()
            if _keep(int(k))}
        self._accs = {
            int(k): [tuple(a) for a in accs]
            for k, accs in state.get("over_accs", {}).items()
            if _keep(int(k))}
        self._emitted_wm = state.get("over_emitted_wm", -(1 << 62))
