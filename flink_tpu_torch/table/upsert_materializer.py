"""SinkUpsertMaterializer — collapse a changelog before an upsert sink (port of
``flink_tpu/table/upsert_materializer.py``).

reference: flink-table/flink-table-runtime/src/main/java/org/apache/flink/
table/runtime/operators/sink/SinkUpsertMaterializer.java:1 — an operator
keyed on the sink's upsert key that turns the upstream changelog
(+I / -U / +U / -D rows) into a last-row-wins UPSERT stream: at most one
row per key per emission, either the key's new current image (+I first
time, +U after) or a DELETE tombstone. This is what lets
``INSERT INTO kafka_table SELECT k, COUNT(*) FROM t GROUP BY k`` — a
plain updating aggregate written to an external table — run at all.

Re-design: the upstream changelog is columnar and per-key ordered (the
GroupAgg operator emits -U(prev) immediately before +U(new)), so the
collapse is vectorized where it counts: drop UPDATE_BEFORE pre-images,
take the LAST effective row per key in the batch, diff against the
materialized current image, and emit one row per touched key. Restore is
key-group filtered so the operator re-shards across subtask counts like
every keyed state here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from flink_tpu_torch.core.records import (
    ROWKIND_DELETE,
    ROWKIND_FIELD,
    ROWKIND_INSERT,
    ROWKIND_UPDATE_AFTER,
    ROWKIND_UPDATE_BEFORE,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.runtime.operators import Operator


class UpsertMaterializeOperator(Operator):
    """Keyed changelog materialization (SinkUpsertMaterializer).

    Per sink key, the operator keeps the LIST of row images currently
    contributing to that key — the reference's exact algorithm, which is
    what makes a changelog whose own key differs from the sink PRIMARY
    KEY (e.g. a global aggregate written into a value-keyed table)
    materialize correctly: an add appends its row, a retraction removes
    the matching row, and the key's emitted image is the list's last
    row (or a DELETE tombstone when the list drains). Emission is
    collapsed per key per batch: one row per touched key — the new
    current image (+I first time, +U after) or -D."""

    name = "sink_upsert_materializer"

    def __init__(self, upsert_keys: List[str],
                 ttl_ms: Optional[int] = None, clock=None):
        if not upsert_keys:
            raise ValueError("upsert materializer requires upsert keys")
        from flink_tpu_torch.state.ttl import SweepGate, default_clock

        self.upsert_keys = list(upsert_keys)
        #: table.exec.state.ttl: a sink key untouched this long drops its
        #: image list (reference: SinkUpsertMaterializer registers a
        #: state-retention cleanup timer per key)
        self.ttl_ms = ttl_ms
        self._clock = clock or default_clock
        self._sweep_gate = SweepGate(ttl_ms) if ttl_ms else None
        #: sink-key tuple -> last-touch processing time (TTL only)
        self._access: Dict[Tuple, int] = {}
        #: sink-key tuple -> list of contributing row-value tuples
        self._rows: Dict[Tuple, List[Tuple]] = {}
        #: column order of the row-value tuples (fixed at first batch)
        self._cols: List[str] = []
        #: positions of _cols compared when matching a retraction —
        #: everything except the event-time stamp. Upstream GroupAgg
        #: re-stamps every emission (including -U pre-images) with its
        #: CURRENT watermark-side max_ts, so a -U's __ts__ never equals
        #: the stored image's once event time advances; matching on the
        #: full tuple would then fall to the drop-oldest path and remove
        #: the WRONG image when several changelog keys feed one sink key
        #: (the reference removes by row equality over VALUES —
        #: SinkUpsertMaterializer.java's equaliser compares row fields,
        #: not system timestamps).
        self._match_idx: List[int] = []

    def open(self, ctx) -> None:
        self.max_parallelism = getattr(ctx, "max_parallelism", 128)

    # ------------------------------------------------------------- process

    def process_batch(self, batch: RecordBatch,
                      input_index: int = 0) -> List[RecordBatch]:
        n = len(batch)
        if n == 0:
            return []
        missing = [k for k in self.upsert_keys if k not in batch.columns]
        if missing:
            raise RuntimeError(
                f"upsert materializer: key columns {missing} missing "
                f"from changelog batch (columns: {batch.names()})")
        value_cols = [c for c in batch.names() if c != ROWKIND_FIELD]
        if not self._cols:
            self._cols = value_cols
        if not self._match_idx:
            self._match_idx = [i for i, c in enumerate(self._cols)
                               if c != TIMESTAMP_FIELD]
        kinds = (np.asarray(batch[ROWKIND_FIELD])
                 if ROWKIND_FIELD in batch.columns
                 else np.full(n, ROWKIND_INSERT, dtype=np.int8))
        col_lists = [batch[c].tolist() for c in self._cols]
        rows = list(zip(*col_lists))
        key_idx = [self._cols.index(k) for k in self.upsert_keys]
        now = self._clock() if self.ttl_ms else 0
        #: key -> image before this batch (None = absent), captured at
        #: the key's first touch so the batch collapses to one emission
        before: Dict[Tuple, Any] = {}
        for row, kind in zip(rows, kinds):
            k = tuple(row[i] for i in key_idx)
            lst = self._rows.get(k)
            if self.ttl_ms:
                self._access[k] = now
            if k not in before:
                before[k] = lst[-1] if lst else None
            if int(kind) in (ROWKIND_INSERT, ROWKIND_UPDATE_AFTER):
                if lst is None:
                    lst = self._rows[k] = []
                lst.append(row)
                continue
            # retraction (-U / -D): remove the LAST matching image
            # (reference: SinkUpsertMaterializer removes by row
            # equality; a miss means an upstream inconsistency and is
            # tolerated by dropping the oldest)
            if not lst:
                continue
            probe = tuple(row[i] for i in self._match_idx)
            for i in range(len(lst) - 1, -1, -1):
                if tuple(lst[i][j] for j in self._match_idx) == probe:
                    del lst[i]
                    break
            else:
                del lst[0]
            if not lst:
                del self._rows[k]
        out_rows: List[Tuple] = []
        out_kinds: List[int] = []
        for k, prev in before.items():
            lst = self._rows.get(k)
            cur = lst[-1] if lst else None
            if cur is None:
                if prev is not None:
                    out_rows.append(prev)
                    out_kinds.append(ROWKIND_DELETE)
                continue
            if prev is None:
                out_rows.append(cur)
                out_kinds.append(ROWKIND_INSERT)
            elif (tuple(cur[j] for j in self._match_idx)
                  != tuple(prev[j] for j in self._match_idx)):
                # value columns changed (the restamped __ts__ alone is
                # not a change — same masking as retraction matching)
                out_rows.append(cur)
                out_kinds.append(ROWKIND_UPDATE_AFTER)
            # unchanged: suppress the duplicate upsert
        if not out_rows:
            return []
        cols = {c: np.asarray([r[i] for r in out_rows])
                for i, c in enumerate(self._cols)}
        cols[ROWKIND_FIELD] = np.asarray(out_kinds, dtype=np.int8)
        ts = cols.pop("__ts__", None)
        return [RecordBatch.from_pydict(cols, timestamps=ts)]

    # ------------------------------------------------------------------ TTL

    def process_watermark(self, watermark, input_index=0):
        self._maybe_sweep_ttl()
        return []

    def _maybe_sweep_ttl(self) -> None:
        if not self.ttl_ms:
            return
        now = self._clock()
        if not self._sweep_gate.should_sweep(now):
            return
        dead = [k for k, s in self._access.items()
                if now - s > self.ttl_ms]
        for k in dead:
            del self._access[k]
            self._rows.pop(k, None)

    # --------------------------------------------------------------- state

    def _key_ids(self, keys: List[Tuple]) -> np.ndarray:
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        first = np.asarray([k[0] for k in keys])
        return hash_keys_to_i64(first)

    def snapshot_state(self) -> Dict[str, Any]:
        keys = list(self._rows.keys())
        snap = {
            "um_cols": list(self._cols),
            "um_keys": keys,
            "um_rows": [self._rows[k] for k in keys],
        }
        if self.ttl_ms:
            snap["um_access"] = [self._access.get(k, 0) for k in keys]
        return snap

    def restore_state(self, state: Dict[str, Any],
                      key_group_filter=None) -> None:
        self._cols = list(state.get("um_cols", []))
        self._match_idx = [i for i, c in enumerate(self._cols)
                           if c != TIMESTAMP_FIELD]
        keys = [tuple(k) if isinstance(k, (list, tuple)) else (k,)
                for k in state.get("um_keys", [])]
        rows = [[tuple(r) for r in lst]
                for lst in state.get("um_rows", [])]
        access = list(state.get("um_access", []))
        if key_group_filter is not None and keys:
            from flink_tpu_torch.state.keygroups import assign_key_groups

            groups = assign_key_groups(self._key_ids(keys),
                                       self.max_parallelism)
            keep = [g in key_group_filter for g in groups]
            keys = [k for k, ok in zip(keys, keep) if ok]
            rows = [r for r, ok in zip(rows, keep) if ok]
            if access:
                access = [a for a, ok in zip(access, keep) if ok]
        self._rows = dict(zip(keys, rows))
        self._access = dict(zip(keys, access)) if access else {}

    def close(self) -> List[RecordBatch]:
        return []
