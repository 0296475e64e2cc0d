"""The delta-harvest family: programs over ``[R, C]`` pane rings (port of
``flink_tpu/stateplane/pane.py``).

The pane layout (``state/pane_table.py``) keeps window state as a ring of
R rows (live slices and window partials) by C key columns, one tensor per
aggregate leaf, plus an int8 presence plane that rides as the trailing
tensor of ``accs``: it tells "identity because empty" from "identity
because the values folded to it", which a fire's validity needs. The six
programs — the flat scatter (const and valued), the fire's merge, finish
and projection, the row reset and put, and the window-partial fold — are
plain functions on the accumulators' own device; those the reference
donated update ``accs`` in place and return it.

- A float leaf folds through ``ordered_fold_planes`` on a ``[1, R * C]``
  view with the int32 flat index: stream order, the reference's NaN bits,
  the hand-written kernel on the card. Its identity slot 0 is row 0,
  column 0, the padding lanes' target. An integer leaf folds through
  ``scatter_add_``/``scatter_reduce_``, exact in any order.
- The merge of a window's rows is ``MERGE_ROWS_FN`` in the fire and
  ``FOLD_ROWS_FN`` in the partial fold: the two orders the reference's CPU
  reduce takes over the leading axis (``ops/segment_ops.py``).
- Both read only the columns below ``used_n``: the others are identity
  and never valid, so a fire's rows (and the top-k's) are the same.

Programs are cached under the ``delta-harvest`` kind, keyed on the
aggregate's layout and the projector, as the reference's are.
"""

from __future__ import annotations

import torch

from flink_tpu_torch.ops.segment_ops import (
    FOLD_ROWS_FN,
    MERGE_ROWS_FN,
    fold_slots,
    scatter_fold,
    torch_dtype,
)
from flink_tpu_torch.stateplane.families import _get_or_build, _idents


def pane_programs(agg, projector=None):
    """``(scatter2d, scatter2d_valued, fire_rows, reset_row, put_row,
    fold_rows)`` for ``[R, C]`` pane tensors; the presence plane is the
    trailing tensor of ``accs``."""
    key = ("pane", agg.cache_key(),
           None if projector is None else projector.cache_key())
    return _get_or_build("delta-harvest", key,
                         lambda: _build_pane_programs(agg, projector))


def _build_pane_programs(agg, projector):
    leaves = agg.leaves
    n = len(leaves)
    tds = tuple(torch_dtype(l.dtype) for l in leaves)
    folds = tuple(scatter_fold(l.reduce, td) for l, td in zip(leaves, tds))
    merges = tuple(MERGE_ROWS_FN[l.reduce] for l in leaves)
    fold_merges = tuple(FOLD_ROWS_FN[l.reduce] for l in leaves)
    idents = _idents(leaves)
    finish = agg.finish

    def _fold(accs, flat, values):
        """Fold one value tensor per leaf at the int32 ``flat`` indices of
        the ``[1, R * C]`` views, and mark presence: 1 at every lane off
        column 0 (the reference's int8 max of ``where(pad, 0, 1)``; a
        column-0 cell is never present, so writing its 0 changes
        nothing)."""
        C = accs[0].shape[1]
        f = flat.view(1, -1)
        for a, fold, idx, v in zip(accs[:n], folds, fold_slots(f, tds),
                                   values):
            fold(a.view(1, -1), idx, v.reshape(1, -1).contiguous())
        accs[n].view(-1).scatter_(0, flat.to(torch.int64),
                                  (flat % C != 0).to(torch.int8))
        return accs

    def scatter2d(accs, flat, values):
        C = accs[0].shape[1]
        pad = flat % C == 0   # column 0 is the reserved identity column
        vit = iter(values)
        vals = []
        for l, td, ident in zip(leaves, tds, idents):
            if l.const is not None:
                v = torch.full(flat.shape, l.const, dtype=td,
                               device=flat.device)
                vals.append(v.masked_fill_(pad, ident))
            else:
                vals.append(next(vit))
        return _fold(accs, flat, vals)

    def scatter2d_valued(accs, flat, values):
        # every leaf valued (locally pre-aggregated partials); pad lanes
        # carry the leaf identities at flat 0
        return _fold(accs, flat, values)

    def fire_rows(accs, rows, used_n):
        idx = rows.to(torch.int64)
        merged = tuple(m(a[idx, :used_n]) for a, m in zip(accs[:n], merges))
        present = accs[n][idx, :used_n].amax(dim=0)
        cols = finish(merged)
        valid = present > 0   # column 0 is never present
        if projector is None:
            return cols, valid
        return projector.project(cols, valid)

    def reset_row(accs, row):
        for a, i in zip(accs[:n], idents):
            a[row].fill_(i)
        accs[n][row].zero_()
        return accs

    def put_row(accs, row, cols, values):
        idx = cols.to(torch.int64)
        for a, v in zip(accs[:n], values):
            a[row].index_copy_(0, idx, v.to(a.dtype))
        accs[n][row].index_copy_(0, idx, (cols != 0).to(torch.int8))
        return accs

    def fold_rows(accs, dst, rows, used_n):
        # a window partial (re)built from its pane rows: dst is freshly
        # taken (identity) or being rebuilt from the authoritative panes
        idx = rows.to(torch.int64)
        for a, m in zip(accs[:n], fold_merges):
            a[dst, :used_n] = m(a[idx, :used_n])
        accs[n][dst, :used_n] = accs[n][idx, :used_n].amax(dim=0)
        return accs

    return (scatter2d, scatter2d_valued, fire_rows, reset_row, put_row,
            fold_rows)

