"""Event-time Top-N / rank operator (port of
``flink_tpu/runtime/rank_operator.py``).

reference: flink-table-runtime rank operators
(flink-table-runtime/.../operators/rank/ — AppendOnlyTopNFunction et al.),
which back the SQL Top-N idiom
``SELECT ... FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY p ORDER BY s)
AS rn FROM t) WHERE rn <= N`` — the pattern Nexmark Q5 uses to pick the
hot item per window.

Re-design for the micro-batch engine: rows are buffered per partition key on
the host; when the watermark passes a partition's timestamp (for window-fired
rows the partition is complete at ts = window_end - 1), the partition is
sorted vectorized (np.lexsort over the order-by columns) and the top-N rows
are emitted with their rank attached. Late-arriving rows for an already
emitted partition are dropped (append-only streams).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.operators import Operator
from flink_tpu_torch.table.expressions import Expr


class RankOperator(Operator):
    name = "rank"

    def __init__(self, partition_by: Tuple[Expr, ...],
                 order_by: Tuple[Tuple[Expr, bool], ...],
                 rank_field: str = "rownum",
                 top_n: Optional[int] = None,
                 rank_kind: str = "ROW_NUMBER"):
        self.partition_by = partition_by
        self.order_by = order_by
        self.rank_field = rank_field
        self.top_n = top_n
        self.rank_kind = rank_kind
        # partition tuple -> (max_ts, [RecordBatch...])
        self._buffers: Dict[tuple, List[RecordBatch]] = {}
        self._buffer_ts: Dict[tuple, int] = {}
        self._emitted: set = set()

    def process_batch(self, batch: RecordBatch, input_index: int = 0
                      ) -> List[RecordBatch]:
        if len(batch) == 0:
            return []
        part_cols = [np.asarray(e.eval(batch)) for e in self.partition_by]
        if not part_cols:
            keys = [()] * len(batch)
        else:
            keys = list(zip(*[c.tolist() for c in part_cols]))
        ts = batch.timestamps if batch.has_timestamps else \
            np.zeros(len(batch), dtype=np.int64)
        uniq = {}
        for i, k in enumerate(keys):
            uniq.setdefault(k, []).append(i)
        for k, idxs in uniq.items():
            if k in self._emitted:
                continue  # late for an already-ranked partition
            sub = batch.take(np.asarray(idxs, dtype=np.int64))
            self._buffers.setdefault(k, []).append(sub)
            self._buffer_ts[k] = max(self._buffer_ts.get(k, 0),
                                     int(ts[idxs].max()))
        return []

    def process_watermark(self, watermark: int, input_index: int = 0
                          ) -> List[RecordBatch]:
        ready = [k for k, t in self._buffer_ts.items() if t <= watermark]
        out: List[RecordBatch] = []
        for k in ready:
            batches = self._buffers.pop(k)
            del self._buffer_ts[k]
            self._emitted.add(k)
            merged = RecordBatch.concat(batches)
            ranked = self._rank(merged)
            if ranked is not None and len(ranked):
                out.append(ranked)
        return out

    def _rank(self, batch: RecordBatch) -> Optional[RecordBatch]:
        n = len(batch)
        if n == 0:
            return None
        sort_cols = []
        for e, desc in reversed(self.order_by):
            v = np.asarray(e.eval(batch))
            if v.dtype == object:
                v = np.array([str(x) for x in v])
            sort_cols.append(-v if desc and v.dtype.kind in "iuf" else v)
        order = np.lexsort(sort_cols) if sort_cols else np.arange(n)
        ranked = batch.take(order)
        if self.rank_kind == "RANK" and self.order_by:
            vals = np.stack([np.asarray(e.eval(ranked), dtype=np.float64)
                             for e, _ in self.order_by], axis=1)
            new_group = np.any(vals[1:] != vals[:-1], axis=1)
            # RANK with gaps: a row's rank = 1 + index of the first row of
            # its tie group
            group_start = np.concatenate([[0], np.flatnonzero(new_group) + 1])
            starts = np.zeros(n, dtype=np.int64)
            starts[group_start] = group_start
            rank = np.maximum.accumulate(starts) + 1
        else:
            rank = np.arange(1, n + 1, dtype=np.int64)
        ranked = ranked.with_column(self.rank_field, rank)
        if self.top_n is not None:
            ranked = ranked.filter(rank <= self.top_n)
        return ranked

    def close(self) -> List[RecordBatch]:
        # end of stream: flush everything still buffered
        return self.process_watermark(np.iinfo(np.int64).max)

    def snapshot_state(self):
        return {
            "buffers": {k: [b.columns for b in v]
                        for k, v in self._buffers.items()},
            "buffer_ts": dict(self._buffer_ts),
            "emitted": list(self._emitted),
        }

    def restore_state(self, state):
        self._buffers = {k: [RecordBatch(c) for c in v]
                         for k, v in state.get("buffers", {}).items()}
        self._buffer_ts = dict(state.get("buffer_ts", {}))
        self._emitted = set(tuple(e) if isinstance(e, list) else e
                            for e in state.get("emitted", []))
