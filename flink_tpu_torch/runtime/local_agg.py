"""Local (pre-shuffle) window aggregation — the two-phase agg's local half
(port of ``flink_tpu/runtime/local_agg.py``).

The reference splits hot aggregations into a local pre-aggregation before
the keyed exchange and a global aggregation after it (reference:
flink-table-runtime/.../aggregate/MiniBatchLocalGroupAggFunction.java +
MiniBatchGlobalGroupAggFunction.java; enabled by the
table.optimizer.agg-phase-strategy TWO_PHASE rule). The local side shrinks
the shuffle to at most one row per (key, window-slice) per batch and
defuses key skew: a hot key's records collapse on every source subtask
before they converge on the one keyed subtask that owns the key (SURVEY
§2.9 local/global row; hard-part (e)).

Re-design: the combiner runs on the *source* stage over columnar batches —
one lexsort + one ufunc.reduceat per accumulator leaf, no per-record code.
Its output rows carry explicit per-leaf partial values in reserved
``__agg_leaf_{i}__`` columns; the window operator detects those columns and
folds them with each leaf's own reduce method (slot_table.scatter_valued)
instead of re-running ``map_input``. Because each output row stays inside
its source records' window slice (it carries their max timestamp), window
assignment downstream is unchanged.
"""

from __future__ import annotations

from typing import List

import numpy as np

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.state.keygroups import hash_keys_to_i64
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner

#: reserved column prefix marking a batch as locally pre-aggregated
PARTIAL_LEAF_PREFIX = "__agg_leaf_"

# host-side reduceat per reduce kind
_REDUCEAT = {
    "sum": np.add.reduceat,
    "max": np.maximum.reduceat,
    "min": np.minimum.reduceat,
}


def is_partial_batch(batch: RecordBatch) -> bool:
    return (PARTIAL_LEAF_PREFIX + "0") in batch.columns


def partial_leaf_values(batch: RecordBatch,
                        agg: AggregateFunction) -> tuple:
    """The per-leaf partial value columns of a combined batch."""
    return tuple(
        np.asarray(batch[PARTIAL_LEAF_PREFIX + str(i)], dtype=l.dtype)
        for i, l in enumerate(agg.leaves))


class LocalWindowCombiner:
    """Collapses a batch to one row per (key, slice) with per-leaf partial
    aggregates. Stateless across batches (state lives only in the keyed
    stage, so checkpoints need nothing from the combiner — same property
    the reference's local agg gets from flushing on every mini-batch)."""

    def __init__(self, assigner: WindowAssigner, agg: AggregateFunction,
                 key_field: str):
        if assigner.is_merging:
            raise ValueError("local combine requires an aligned (slicing) "
                             "window assigner")
        self.assigner = assigner
        self.agg = agg
        self.key_field = key_field

    def combine(self, batch: RecordBatch) -> RecordBatch:
        n = len(batch)
        if n == 0 or is_partial_batch(batch):
            return batch
        key_ids = hash_keys_to_i64(batch[self.key_field])
        slice_ends = self.assigner.assign_slice_ends(batch.timestamps)
        order = np.lexsort((slice_ends, key_ids))
        k_s = key_ids[order]
        s_s = slice_ends[order]
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        np.logical_or(k_s[1:] != k_s[:-1], s_s[1:] != s_s[:-1],
                      out=boundary[1:])
        starts = np.nonzero(boundary)[0]
        values = self.agg.map_input_valued(batch)
        cols = {
            # representative original key value per group (all rows in a
            # group share the key, so the first is exact)
            self.key_field: np.asarray(batch[self.key_field])[order][starts],
            # already-computed key identities: the partitioner reuses them
            # instead of re-hashing the combined rows
            KEY_ID_FIELD: k_s[starts],
            # max source timestamp per group: stays inside the slice and
            # never runs ahead of the batch's watermark contribution
            TIMESTAMP_FIELD: np.maximum.reduceat(
                np.asarray(batch.timestamps)[order], starts),
        }
        for i, (leaf, v) in enumerate(zip(self.agg.leaves, values)):
            cols[PARTIAL_LEAF_PREFIX + str(i)] = _REDUCEAT[leaf.reduce](
                np.asarray(v)[order], starts).astype(leaf.dtype)
        return RecordBatch(cols)
