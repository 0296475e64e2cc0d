"""Device OVER aggregation — every frame of every key in one torch program
per fire (port of ``flink_tpu/runtime/over_device.py``).

The reference's program (``_build_kernel``, a jitted XLA program, not a
Pallas kernel) becomes plain torch ops on the operator's device:

- segments ride a boundary-flag column (no key values enter the program);
- SUM / COUNT / AVG: global prefix sums (``torch.cumsum`` in float64),
  frame totals by gather (``cs[end] - cs[start]``) — segment bases cancel;
- ROWS MIN/MAX: a segmented running min/max (log-step doubling with the
  reference's ``(flag, value)`` combiner, since eager torch has no
  associative scan) covers frames clipped at the segment start;
  full-width frames use the two-overlapping-power-of-two-block trick
  (static window => static shifts filled with +-inf, then one gather);
- RANGE bounds: timestamps are monotonicized across segments
  (``g = seg_idx * 2^41 + ts_rel``) so ONE global ``searchsorted`` on the
  host yields every per-segment frame bound; peers (equal rowtime) fall
  out of the right-bound search;
- UNBOUNDED accumulators are synthetic context rows (value = running
  aggregate, weight = running count) prepended to their segment.

Context rows live in FLAT host arrays, filtered per fire with ``np.isin``
and merged back vectorized, exactly as the reference keeps them, so a
snapshot of either package restores in the other.

Deviations from the reference, both deliberate:

- the prefix sums run in float64 on every device. The reference's
  program runs float32 unless JAX has x64 on, and its planner's ``auto``
  picks it only under x64; the port's ``auto`` picks it wherever
  ``device_supported`` holds. SUM/AVG are held to the reference's own
  tolerance against the host engine (``rtol=2e-4, atol=1e-5``): the
  cumulative sums associate differently from NumPy's per-segment ones;
  COUNT, MIN and MAX, keys, timestamps and row order are exact;
- a fire whose RANGE span reaches 2^41 or whose segments reach 2M moves
  to the host engine for good, as the reference's does, but the port
  counts it (``degrades``, in ``counters()``), never silently.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.over_agg import OverAggOperator, OverSpec

#: per-segment timestamp offset for the monotonicized RANGE search; spans
#: (ts range + preceding) must stay below it — guarded at fire time
_TS_OFFSET = np.int64(1) << 41

#: timestamp sentinel of synthetic accumulator context rows (UNBOUNDED
#: carry-over) — below every real timestamp so they sort to their
#: segment's head
_SYNTH_TS = -(np.int64(1) << 60)

#: segments per fire at which the monotonicized search gives way
_MAX_SEGMENTS = 1 << 21

_SUMLIKE = ("SUM", "AVG", "COUNT")


def device_supported(specs: List[OverSpec], mode: str,
                     preceding: Optional[int]) -> bool:
    """Bounded RANGE MIN/MAX needs variable-width window reductions —
    the one frame family without a clean scan/gather form; keep it on
    the host engine."""
    if mode == "RANGE" and preceding is not None:
        return all(f in _SUMLIKE for f, _, _ in specs)
    return True


def _floor_log2(w: int) -> int:
    return max(w.bit_length() - 1, 0)


def seg_scan(op, boundary: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Segmented running reduce: ``op`` over each segment's prefix, by
    log-step doubling (Hillis–Steele) with the reference's combiner
    ``(f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2))``. MIN and MAX
    are exact in any association order."""
    f, v = boundary, x
    n = x.shape[0]
    sh = 1
    while sh < n:
        f_prev, v_prev = f[:-sh], v[:-sh]
        f_cur, v_cur = f[sh:], v[sh:]
        v = torch.cat([v[:sh], torch.where(f_cur, v_cur,
                                           op(v_prev, v_cur))])
        f = torch.cat([f[:sh], f_prev | f_cur])
        sh <<= 1
    return v


def over_program(funcs: Tuple[str, ...], mode: str,
                 preceding: Optional[int], boundary: torch.Tensor,
                 index: torch.Tensor, vals: torch.Tensor,
                 wts: torch.Tensor):
    """The fire's device program: ``index`` is the ``[4, n]`` int64 stack
    (seg_start, starts, ends, peer_last) built on the host, ``vals`` and
    ``wts`` are ``[S, n]`` float64. Returns ``[3, S, n]``: the per-row
    outputs, the running sums and the running counts (the context
    upkeep's inputs)."""
    seg_start, starts, ends, peer_last = index
    n = boundary.shape[0]
    idx1 = torch.arange(1, n + 1, device=boundary.device)
    zero = torch.zeros(1, dtype=vals.dtype, device=vals.device)
    outs, run_sums, run_cnts = [], [], []
    for i, func in enumerate(funcs):
        v, w = vals[i], wts[i]
        cs = torch.cat([zero, torch.cumsum(v, 0)])
        cw = torch.cat([zero, torch.cumsum(w, 0)])
        op = torch.minimum if func == "MIN" else torch.maximum
        if preceding is None:
            run_s = cs[idx1] - cs[seg_start]
            run_c = cw[idx1] - cw[seg_start]
            if func in _SUMLIKE:
                row = (run_s if func == "SUM"
                       else run_c if func == "COUNT"
                       else run_s / run_c)
            else:
                row = seg_scan(op, boundary, v)
            outs.append(row[peer_last])
            run_sums.append(row if func in ("MIN", "MAX") else run_s)
            run_cnts.append(run_c)
            continue
        if func in _SUMLIKE:
            tot = cs[ends] - cs[starts]
            cnt = cw[ends] - cw[starts]
            outs.append(tot if func == "SUM"
                        else cnt if func == "COUNT" else tot / cnt)
        else:  # ROWS MIN/MAX (RANGE MIN/MAX is host-only)
            ident = math.inf if func == "MIN" else -math.inf
            run = seg_scan(op, boundary, v)
            wwin = preceding + 1
            k = _floor_log2(wwin)
            # m covers [j - 2^k + 1, j] after k doubling steps
            m = v
            for step in range(k):
                sh = 1 << step
                if sh >= n:
                    m = op(m, torch.full_like(m, ident))
                    continue
                m = op(m, torch.cat([torch.full((sh,), ident,
                                                dtype=m.dtype,
                                                device=m.device),
                                     m[:-sh]]))
            rest = wwin - (1 << k)
            idx = idx1 - 1
            two_block = op(m, m[torch.clamp(idx - rest, min=0)])
            pos = idx - seg_start
            outs.append(torch.where(pos >= wwin - 1, two_block, run))
        run_sums.append(cs[idx1])
        run_cnts.append(cw[idx1])
    return torch.stack([torch.stack(outs), torch.stack(run_sums),
                        torch.stack(run_cnts)])


class DeviceOverAggOperator(OverAggOperator):
    """OverAggOperator with the device compute path.

    Inherits ingest/late-row/watermark handling; replaces ``_compute``
    and keeps context in flat arrays (kid, ts, per-spec val/weight)
    instead of per-key dicts. ``device``: the operator's device (default
    ``execution.device`` from the operator context, else the card)."""

    name = "over_agg_device"

    def __init__(self, key_field: str, specs: List[OverSpec],
                 mode: str = "ROWS", preceding: Optional[int] = None,
                 device=None):
        super().__init__(key_field, specs, mode=mode, preceding=preceding)
        if not device_supported(specs, mode, preceding):
            raise ValueError(
                "bounded RANGE MIN/MAX has no device form — use the "
                "host engine (table.exec.over.engine=host)")
        S = len(specs)
        self._ctx_kid = np.empty(0, dtype=np.int64)
        self._ctx_ts = np.empty(0, dtype=np.int64)
        self._ctx_val = [np.empty(0) for _ in range(S)]
        self._ctx_wt = [np.empty(0) for _ in range(S)]
        self._fallback = False
        self._funcs = tuple(f for f, _, _ in specs)
        self._device_arg = device
        self.device = None
        #: fires computed by the device program / by the host engine after
        #: a degrade, and the degrades themselves (0 or 1)
        self.device_fires = 0
        self.host_fires = 0
        self.degrades = 0

    def open(self, ctx) -> None:
        super().open(ctx)
        self.device = resolve_device(
            self._device_arg if self._device_arg is not None
            else getattr(ctx, "device", None))

    def counters(self) -> Dict[str, int]:
        return {"over_device_fires": self.device_fires,
                "over_host_fires": self.host_fires,
                "over_degrades": self.degrades,
                "over_late_records_dropped": self.late_records_dropped}

    def _degrade_to_host(self) -> None:
        if not self._fallback:
            self._fallback = True
            self.degrades += 1
            for k in np.unique(self._ctx_kid).tolist():
                mask = self._ctx_kid == k
                if self.preceding is None:
                    self._accs[int(k)] = [
                        (float(self._ctx_val[i][mask][0]),
                         float(self._ctx_wt[i][mask][0]))
                        for i in range(len(self.specs))]
                else:
                    o = np.argsort(self._ctx_ts[mask], kind="stable")
                    ctx = {"ts": self._ctx_ts[mask][o]}
                    for i in range(len(self.specs)):
                        ctx[f"v{i}"] = self._ctx_val[i][mask][o]
                    self._context[int(k)] = ctx
            self._ctx_kid = np.empty(0, dtype=np.int64)
            self._ctx_ts = np.empty(0, dtype=np.int64)
            self._ctx_val = [np.empty(0) for _ in self.specs]
            self._ctx_wt = [np.empty(0) for _ in self.specs]

    # ------------------------------------------------------------ compute

    def _compute(self, ready: RecordBatch) -> Optional[RecordBatch]:
        n = len(ready)
        S = len(self.specs)
        kid = self._key_ids(ready)
        ts = np.asarray(ready.timestamps, dtype=np.int64)
        order = np.lexsort((ts, kid))
        ready = ready.take(order)
        kid, ts = kid[order], ts[order]
        vals = self._arg_values(ready, n)
        wts = [np.ones(n) for _ in range(S)]

        # pull context rows of the keys present in this fire
        hit = np.isin(self._ctx_kid, kid)
        c_kid, c_ts = self._ctx_kid[hit], self._ctx_ts[hit]
        c_val = [v[hit] for v in self._ctx_val]
        c_wt = [w[hit] for w in self._ctx_wt]

        all_kid = np.concatenate([c_kid, kid])
        all_ts = np.concatenate([c_ts, ts])
        is_new = np.r_[np.zeros(len(c_kid), bool), np.ones(n, bool)]
        # context ts <= emitted watermark < new-row ts, so a stable sort
        # by (kid, ts) lands context first and keeps the emitted rows in
        # ready order
        o2 = np.lexsort((all_ts, all_kid))
        all_kid, all_ts, is_new = all_kid[o2], all_ts[o2], is_new[o2]
        all_val = [np.concatenate([cv, v])[o2]
                   for cv, v in zip(c_val, vals)]
        all_wt = [np.concatenate([cw, w])[o2] for cw, w in zip(c_wt, wts)]

        m = len(all_kid)
        boundary = np.r_[True, all_kid[1:] != all_kid[:-1]]
        # synthetic accumulator rows sit at their segment head; clamping
        # them to ts_rel = 0 keeps the span guard on REAL timestamps
        synth = all_ts == _SYNTH_TS
        real_ts = all_ts[~synth]
        base = real_ts.min() if len(real_ts) else np.int64(0)
        ts_rel = np.where(synth, np.int64(0), all_ts - base + 1)
        if self._fallback or (self.mode == "RANGE" and (
                int(ts_rel.max()) + (self.preceding or 0) >= _TS_OFFSET
                or int(boundary.sum()) >= _MAX_SEGMENTS)):
            # the fire exceeds the monotonicized search's span budget:
            # degrade PERMANENTLY to the host engine (the reference's
            # semantics), converting flat context to its per-key form
            # first so no frame history is lost; counted in degrades
            self._degrade_to_host()
            self.host_fires += 1
            return super()._compute(ready)

        # host-side index arrays (vectorized int64)
        idx = np.arange(m, dtype=np.int64)
        seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
        if self.mode == "RANGE":
            g = np.cumsum(boundary.astype(np.int64)) * _TS_OFFSET + ts_rel
            ends = np.searchsorted(g, g, side="right")
            starts = (np.searchsorted(
                g, g - np.int64(self.preceding), side="left")
                if self.preceding is not None else idx * 0)
            peer_last = ends - 1
        else:
            ends = idx + 1
            starts = (np.maximum(idx - self.preceding, seg_start)
                      if self.preceding is not None else idx * 0)
            peer_last = idx

        # pad to a power of two; the pad is its own trailing segment and
        # never emitted
        mp = max(1 << math.ceil(math.log2(max(m, 16))), 16)
        pad = mp - m

        def p(a, fill=0):
            return np.r_[a, np.full(pad, fill, dtype=a.dtype)] \
                if pad else a

        boundary_p = np.r_[boundary, np.zeros(pad, bool)]
        if pad:
            boundary_p[m] = True
        pad_idx = np.arange(m, mp, dtype=np.int64)
        index = np.stack([np.r_[seg_start, pad_idx], np.r_[starts, pad_idx],
                          np.r_[ends, pad_idx + 1],
                          np.r_[peer_last, pad_idx]])
        vw = np.stack([p(np.asarray(v, np.float64)) for v in all_val]
                      + [p(np.asarray(w, np.float64)) for w in all_wt])
        dev = self.device
        # one put for the index stack, one for values and weights, and
        # ONE device-to-host copy of the three outputs
        vw_t = torch.from_numpy(vw).to(dev, non_blocking=True)
        res = over_program(
            self._funcs, self.mode, self.preceding,
            torch.from_numpy(boundary_p).to(dev, non_blocking=True),
            torch.from_numpy(index).to(dev, non_blocking=True),
            vw_t[:S], vw_t[S:]).cpu().numpy()
        self.device_fires += 1
        outs, run_s, run_c = res[0, :, :m], res[1, :, :m], res[2, :, :m]

        out = ready
        for (_, _, out_name), col in zip(self.specs, outs):
            out = out.with_column(out_name, col[is_new])

        self._update_context(all_kid, all_ts, all_val, boundary,
                             run_s, run_c, hit)
        return out

    # ------------------------------------------------------- context upkeep

    def _update_context(self, all_kid, all_ts, all_val, boundary,
                        run_s, run_c, hit) -> None:
        m = len(all_kid)
        seg_last = np.r_[np.flatnonzero(boundary)[1:] - 1, m - 1]
        if self.preceding is None:
            # one accumulator row per key: value = running aggregate at
            # the segment's last row, weight = running count
            keep_kid = all_kid[seg_last]
            keep_ts = np.full(len(seg_last), _SYNTH_TS, dtype=np.int64)
            keep_val = [run_s[i][seg_last] for i in range(len(self.specs))]
            keep_wt = [run_c[i][seg_last] for i in range(len(self.specs))]
        else:
            starts = np.flatnonzero(boundary)
            lengths = np.diff(np.r_[starts, m])
            seg_end = np.repeat(seg_last, lengths)
            if self.mode == "ROWS":
                keep = (seg_end - np.arange(m)) < self.preceding
            else:
                keep = all_ts >= all_ts[seg_end] - self.preceding
            keep_kid = all_kid[keep]
            keep_ts = all_ts[keep]
            keep_val = [v[keep] for v in all_val]
            keep_wt = [np.ones(int(keep.sum()))
                       for _ in range(len(self.specs))]
        miss = ~hit
        self._ctx_kid = np.concatenate([self._ctx_kid[miss], keep_kid])
        self._ctx_ts = np.concatenate([self._ctx_ts[miss], keep_ts])
        self._ctx_val = [np.concatenate([cv[miss], kv])
                         for cv, kv in zip(self._ctx_val, keep_val)]
        self._ctx_wt = [np.concatenate([cw[miss], kw])
                        for cw, kw in zip(self._ctx_wt, keep_wt)]

    # --------------------------------------------------------------- state

    def snapshot_state(self) -> Dict[str, Any]:
        snap = super().snapshot_state()
        snap["over_device_ctx"] = {
            "kid": self._ctx_kid.copy(),
            "ts": self._ctx_ts.copy(),
            "val": [v.copy() for v in self._ctx_val],
            "wt": [w.copy() for w in self._ctx_wt],
        }
        return snap

    def restore_state(self, state: Dict[str, Any],
                      key_group_filter=None) -> None:
        super().restore_state(state, key_group_filter=key_group_filter)
        ctx = state.get("over_device_ctx")
        if ctx is None:
            return
        kid = np.asarray(ctx["kid"], dtype=np.int64)
        keep = np.ones(len(kid), bool)
        if key_group_filter is not None and len(kid):
            from flink_tpu_torch.state.keygroups import assign_key_groups

            groups = assign_key_groups(kid, self.max_parallelism)
            keep = np.isin(groups, np.asarray(sorted(key_group_filter)))
        self._ctx_kid = kid[keep]
        self._ctx_ts = np.asarray(ctx["ts"], dtype=np.int64)[keep]
        self._ctx_val = [np.asarray(v, np.float64)[keep]
                         for v in ctx["val"]]
        self._ctx_wt = [np.asarray(w, np.float64)[keep] for w in ctx["wt"]]
