"""The flat state-plane programs of the single-device engine (port of the
flat builders of ``flink_tpu/stateplane/families.py``).

Each builder returns a plain function over flat ``[capacity]``
accumulator tensors, one per aggregate leaf, on the accumulators' own
device. Programs that the reference donated update the accumulators IN
PLACE and return them. Slot 0 is the identity slot: padded lanes target
it with the identity, and fires read it for missing slices.

- A float leaf folds through ``ordered_fold_planes`` on a ``[1, cap]``
  view: the reference's stream-order ``.at[].add/max/min`` bit for bit,
  by the hand-written kernel on the card (``segment_ops.scatter_fold``).
  An integer leaf folds through ``scatter_add_``/``scatter_reduce_``,
  exact in any order.
- A merge across a window's slices is ``segment_ops.MERGE_FN``.

Builders are keyed, as the reference's are, on what they compute —
reduce kinds, identities, dtypes, the aggregate's ``cache_key`` — and
kept in one table, so two tables with the same layout share a program.

The pane layout's programs are ``stateplane/pane.py``'s (the
``delta-harvest`` kind of this table), with :func:`pane_fence` here.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops.segment_ops import (
    MERGE_FN,
    fold_slots,
    scatter_fold,
    torch_dtype,
)
from flink_tpu_torch.runtime.pending import Fence

_PROGRAMS: Dict[tuple, Callable] = {}


def _get_or_build(kind: str, key: tuple, build: Callable) -> Callable:
    prog = _PROGRAMS.get((kind, key))
    if prog is None:
        prog = _PROGRAMS[(kind, key)] = build()
    return prog


def _layout(leaves) -> tuple:
    return tuple((l.reduce, l.dtype.str, None if l.const is None
                  else (l.const, l.dtype.str)) for l in leaves)


def _idents(leaves) -> Tuple[object, ...]:
    return tuple(np.asarray(l.identity).item() for l in leaves)


def _folds(leaves):
    """(torch dtypes, in-place fold per leaf) — the ``[P, cap]`` plane
    folds of ``segment_ops``, applied to ``[1, cap]`` views."""
    tds = tuple(torch_dtype(l.dtype) for l in leaves)
    return tds, tuple(scatter_fold(l.reduce, td)
                      for l, td in zip(leaves, tds))


def _fold_flat(accs, leaves, tds, folds, slots, values):
    """Fold one value tensor per leaf into flat accumulators at int32
    ``slots``."""
    s = slots.view(1, -1)
    for a, fold, idx, v in zip(accs, folds, fold_slots(s, tds), values):
        fold(a.view(1, -1), idx, v.reshape(1, -1).contiguous())
    return accs


# ------------------------------------------------------------ scatter-combine


def flat_scatter_combine(leaves):
    """``(accs, slots int32 [n], values) -> accs``: fold a batch; ``values``
    holds one tensor per input leaf. A const leaf broadcasts its constant
    on the device, masked to the identity at the reserved slot 0."""
    return _get_or_build("scatter-combine", ("const", _layout(leaves)),
                         lambda: _build_scatter_combine(leaves))


def _build_scatter_combine(leaves):
    tds, folds = _folds(leaves)
    idents = _idents(leaves)

    def scatter(accs, slots, values):
        vit = iter(values)
        vals = []
        for l, td, ident in zip(leaves, tds, idents):
            if l.const is not None:
                v = torch.full(slots.shape, l.const, dtype=td,
                               device=slots.device)
                vals.append(v.masked_fill_(slots == 0, ident))
            else:
                vals.append(next(vit))
        return _fold_flat(accs, leaves, tds, folds, slots, vals)

    return scatter


def flat_scatter_valued(leaves):
    """``(accs, slots, values) -> accs`` where EVERY leaf takes a value
    tensor, each folded by its own reduce — the merge of locally
    pre-aggregated partials. Pad lanes carry each leaf's identity at the
    reserved slot 0."""
    return _get_or_build("scatter-combine", ("valued", _layout(leaves)),
                         lambda: _build_scatter_valued(leaves))


def _build_scatter_valued(leaves):
    tds, folds = _folds(leaves)

    def scatter_valued(accs, slots, values):
        return _fold_flat(accs, leaves, tds, folds, slots, values)

    return scatter_valued


def flat_scatter_signed(leaves):
    """``(accs, slots, values) -> accs``: the retraction fold. Every leaf
    takes a sign-applied value tensor (+v accumulates, -v retracts); only
    additive layouts are retractable, so this is the valued scatter of
    sum leaves (pad lanes add 0 into slot 0): float leaves through the
    ordered fold, the reference's stream-order ``.at[].add``, integer
    leaves through ``scatter_add_``."""
    return flat_scatter_valued(leaves)


# ------------------------------------------------------------- segment-reduce


def _merged(accs, merges, slot_matrix):
    idx = slot_matrix.to(torch.int64)
    return tuple(m(a[idx]) for a, m in zip(accs, merges))


def flat_segment_fire(agg):
    """``(accs, slot_matrix [w, k]) -> {name: [w]}``: merge each row's
    slice slots, then ``finish``."""
    return _get_or_build("segment-reduce", ("fire", agg.cache_key()),
                         lambda: _build_segment_fire(agg))


def _build_segment_fire(agg):
    merges = tuple(MERGE_FN[l.reduce] for l in agg.leaves)
    finish = agg.finish

    def fire(accs, slot_matrix):
        return finish(_merged(accs, merges, slot_matrix))

    return fire


def flat_segment_fire_projected(agg, projector):
    """``(accs, slot_matrix [wp, k], w) -> (row indices [n], cols [n],
    valid [n])``: the fire's merge and finish fused with a FireProjector,
    so only its n rows leave the device; validity is ``row < w``."""
    key = ("fire-proj", agg.cache_key(), projector.cache_key())
    return _get_or_build("segment-reduce", key,
                         lambda: _build_segment_fire_projected(agg,
                                                               projector))


def _build_segment_fire_projected(agg, projector):
    merges = tuple(MERGE_FN[l.reduce] for l in agg.leaves)
    finish = agg.finish
    project = projector.project

    def fire_proj(accs, slot_matrix, w):
        valid = torch.arange(slot_matrix.shape[0],
                             device=slot_matrix.device) < w
        return project(finish(_merged(accs, merges, slot_matrix)), valid)

    return fire_proj


def flat_segment_merge(leaves):
    """``(accs, slot_matrix [w, k]) -> merged leaves [w]`` WITHOUT finish —
    the hybrid fire: resident slices merge on the device, spilled ones on
    the host, and finish runs on the host over the union."""
    key = ("merge", tuple((l.reduce, l.dtype.str) for l in leaves))
    return _get_or_build("segment-reduce", key,
                         lambda: _build_segment_merge(leaves))


def _build_segment_merge(leaves):
    merges = tuple(MERGE_FN[l.reduce] for l in leaves)

    def merge(accs, slot_matrix):
        return _merged(accs, merges, slot_matrix)

    return merge


def flat_merge_pairs(leaves):
    """``(accs, dst int32 [n], src int32 [n]) -> accs``: the session merge,
    ``acc[dst] op= acc[src]`` then ``acc[src] = identity``, in place. Every
    lane's ``acc[src]`` is read before any write; the adds into one ``dst``
    (duplicates allowed) run in lane order — through the ordered fold for
    float leaves (the kernel on the card), ``scatter_add_``/
    ``scatter_reduce_`` for integer ones. Padded lanes have ``src == dst ==
    0``: the reserved slot ends as the identity."""
    key = ("merge-pairs", _layout(leaves))
    return _get_or_build("segment-reduce", key,
                         lambda: _build_merge_pairs(leaves))


def _build_merge_pairs(leaves):
    tds, folds = _folds(leaves)
    idents = _idents(leaves)

    def merge(accs, dst, src):
        idx = src.to(torch.int64)
        moved = [a[idx] for a in accs]
        _fold_flat(accs, leaves, tds, folds, dst, moved)
        for a, i in zip(accs, idents):
            a.index_fill_(0, idx, i)
        return accs

    return merge


# --------------------------------------------------------------------- gather


def flat_gather(leaves):
    """``(accs, slots) -> per-leaf values``: only the addressed slots
    leave the device (the eviction read)."""
    return _get_or_build("gather", (tuple(l.dtype.str for l in leaves),),
                         lambda: _gather)


def _gather(accs, slots):
    idx = slots.to(torch.int64)
    return tuple(a[idx] for a in accs)


# --------------------------------------------------------------- evict-cohort


def flat_put(leaves):
    """``(accs, slots, values) -> accs`` with ``a[slots] = v`` — the spill
    reload: values gathered at eviction are placed back as they were,
    masked to the identity at the reserved slot 0 (the pad target)."""
    idents = _idents(leaves)
    key = ("put", idents, tuple(l.dtype.str for l in leaves))
    return _get_or_build("evict-cohort", key, lambda: _build_put(idents))


def _build_put(idents):
    def put(accs, slots, values):
        idx = slots.to(torch.int64)
        pad = slots == 0
        for a, v, i in zip(accs, values, idents):
            a[idx] = v.masked_fill(pad, i)
        return accs

    return put


def flat_reset(leaves):
    """``(accs, slots) -> accs``: an eviction cohort's or freed slice's
    slots back to their identities."""
    idents = _idents(leaves)
    key = ("reset", idents, tuple(l.dtype.str for l in leaves))
    return _get_or_build("evict-cohort", key, lambda: _build_reset(idents))


def _build_reset(idents):
    def reset(accs, slots):
        idx = slots.to(torch.int64)
        for a, i in zip(accs, idents):
            a.index_fill_(0, idx, i)
        return accs

    return reset


# -------------------------------------------------------------- snapshot-lift


def flat_fence(dtype_str: str):
    """``a -> Fence`` holding ``a[:1]``: a tiny read enqueued after
    everything dispatched so far, and the event that proves the device got
    there (dispatch-depth bounding)."""
    return _get_or_build("snapshot-lift", ("fence", dtype_str),
                         lambda: _fence)


def _fence(a):
    return Fence(a.device, a[:1].clone())


def pane_fence(dtype_str: str):
    """``a [R, C] -> Fence`` holding ``a[:1, :1]``: the pane table's
    dispatch-depth fence."""
    return _get_or_build("snapshot-lift", ("pane-fence", dtype_str),
                         lambda: _pane_fence)


def _pane_fence(a):
    return Fence(a.device, a[:1, :1].clone())
