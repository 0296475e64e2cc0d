"""Locally pre-aggregated batches (the parts of
``flink_tpu/runtime/local_agg.py`` the window engine reads).

A two-phase aggregation's local half collapses a batch to one row per
(key, slice) and carries each accumulator leaf's partial value in a
reserved ``__agg_leaf_{i}__`` column; the window engine folds those with
each leaf's own reduce instead of re-running ``map_input``. The combiner
itself (``LocalWindowCombiner``) is not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import numpy as np

from flink_tpu_torch.core.records import RecordBatch

#: reserved column prefix marking a batch as locally pre-aggregated
PARTIAL_LEAF_PREFIX = "__agg_leaf_"


def is_partial_batch(batch: RecordBatch) -> bool:
    return (PARTIAL_LEAF_PREFIX + "0") in batch.columns


def partial_leaf_values(batch: RecordBatch, agg) -> tuple:
    """The per-leaf partial value columns of a combined batch."""
    return tuple(
        np.asarray(batch[PARTIAL_LEAF_PREFIX + str(i)], dtype=l.dtype)
        for i, l in enumerate(agg.leaves))
