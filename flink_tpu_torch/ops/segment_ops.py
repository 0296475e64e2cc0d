"""Segment/scatter helpers for keyed state (port of
``flink_tpu/ops/segment_ops.py``).

Conventions kept from the reference: slot 0 is the identity slot (padded
lanes point at it with identity values), and batch dimensions are padded to
power-of-two buckets so the set of shapes stays small.

The reduce maps are recast for torch, in the ``[P, cap]`` plane layout
the engines keep. A scatter reduce of an integer leaf is ``scatter_add_``
(sum) or ``scatter_reduce_`` with ``amax``/``amin`` along the slot axis:
integer folds are exact in any order. A float leaf folds through
``stateplane/fold.py`` (:func:`scatter_fold`), in stream order on the card
as on the CPU, with the reference's NaN bits for sums and its NaN and
signed-zero rules for max/min. A merge across the slice axis (the last
dim of a gathered ``[..., k]`` slot matrix) is, for sum, a left fold
``((0 + x0) + x1) + ...`` — the order XLA's CPU reduce takes, which
``torch.sum`` does not keep — and for float max/min a reduction over
order keys.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.stateplane.fold import (
    from_order_key,
    nan_bits,
    order_key,
    ordered_fold_planes,
)


def _scatter_add(acc: torch.Tensor, idx: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    return acc.scatter_add_(1, idx, v)


def _scatter_max(acc: torch.Tensor, idx: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    return acc.scatter_reduce_(1, idx, v, reduce="amax")


def _scatter_min(acc: torch.Tensor, idx: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    return acc.scatter_reduce_(1, idx, v, reduce="amin")


#: scatter reduce -> in-place fold ``(acc [P, cap], slots int64 [P, L],
#: v [P, L]) -> acc`` per plane, for integer leaves (exact in any order);
#: see :func:`scatter_fold`
SCATTER_METHOD: Dict[str, Callable] = {
    "sum": _scatter_add,
    "max": _scatter_max,
    "min": _scatter_min,
}


def scatter_fold(reduce: str, dtype: torch.dtype) -> Callable:
    """The in-place fold ``(acc [P, cap], slots [P, L], v [P, L]) -> acc``
    of one leaf, plane by plane: float leaves keep the reference's order
    and semantics through the ordered fold on int32 slots (its CUDA kernel
    on the card, which drops the lanes at each plane's identity slot 0);
    integer leaves keep ``scatter_add_``/``scatter_reduce_`` on int64
    slots, whose atomics cannot change an integer result.
    :func:`fold_slots` gives each leaf its slots."""
    if not dtype.is_floating_point:
        return SCATTER_METHOD[reduce]
    return functools.partial(ordered_fold_planes, reduce=reduce)


def fold_slots(slots: torch.Tensor,
               dtypes: Sequence[torch.dtype]) -> Tuple[torch.Tensor, ...]:
    """The slots each leaf's :func:`scatter_fold` takes: the int32
    ``slots`` for a float leaf, and one int64 copy of them, made once and
    shared, for the integer leaves."""
    wide = None
    out = []
    for td in dtypes:
        if not td.is_floating_point and wide is None:
            wide = slots.to(torch.int64)
        out.append(slots if td.is_floating_point else wide)
    return tuple(out)


def _merge_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU reduce of the slice axis: one slice is returned as it is;
    k > 1 slices are added left to right from 0 (the reference's fire does
    so up to k = 27: ROADMAP Queue C item 7). A NaN sum takes the NaN
    that came first — the earliest NaN slice, quieted, or the default NaN
    of an inf - inf met before any — as ``jnp.sum`` and the reference's
    fire programs give it (where one add meets two NaNs, some of the
    fire's compiled loops keep the later one: ROADMAP Queue C item 6). The
    card's adds give another NaN, so the rule is applied on every
    device."""
    k = x.shape[-1]
    if k == 1:
        return x[..., 0].clone()
    acc = x[..., 0] + 0
    if not x.dtype.is_floating_point:
        for j in range(1, k):
            acc = acc + x[..., j]
        return acc
    first = torch.where(torch.isnan(acc), nan_bits(x[..., 0], True),
                        nan_bits(acc, False))
    seen = torch.isnan(acc)
    for j in range(1, k):
        xj = x[..., j]
        acc = acc + xj
        became = torch.isnan(acc) & ~seen
        first = torch.where(became & torch.isnan(xj), nan_bits(xj, True),
                            first)
        seen |= became
    return torch.where(seen, first, acc)


def _merge_extreme(x: torch.Tensor, reduce: str) -> torch.Tensor:
    if not x.dtype.is_floating_point:
        return torch.amax(x, dim=-1) if reduce == "max" \
            else torch.amin(x, dim=-1)
    k = order_key(x)
    k = torch.amax(k, dim=-1) if reduce == "max" else torch.amin(k, dim=-1)
    return from_order_key(k, x.dtype).masked_fill(
        torch.isnan(x).any(dim=-1), float("nan"))


#: merge across the slice axis (the last dim) of gathered partials
MERGE_FN: Dict[str, Callable] = {
    "sum": _merge_sum,
    "max": lambda x: _merge_extreme(x, "max"),
    "min": lambda x: _merge_extreme(x, "min"),
}

_MIN_BUCKET = 256


def pad_bucket_size(n: int, minimum: int = _MIN_BUCKET) -> int:
    """Next power-of-two >= n (>= minimum)."""
    if n <= minimum:
        return minimum
    return 1 << (int(n - 1).bit_length())


def sticky_bucket(n: int, cached: int, minimum: int = _MIN_BUCKET) -> int:
    """Bucket size reusing ``cached`` when it covers ``n`` with at most 4x
    padding, else the exact bucket."""
    need = pad_bucket_size(n, minimum)
    if need <= cached <= 4 * need:
        return cached
    return need


def identity_for(reduce: str, dtype) -> float:
    """Identity element of a scatter reduce for ``dtype``."""
    dtype = np.dtype(dtype)
    if reduce == "sum":
        return dtype.type(0)
    if reduce == "max":
        if np.issubdtype(dtype, np.floating):
            return dtype.type(-np.inf)
        return np.iinfo(dtype).min
    if reduce == "min":
        if np.issubdtype(dtype, np.floating):
            return dtype.type(np.inf)
        return np.iinfo(dtype).max
    raise ValueError(f"unknown reduce {reduce!r}")


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype -> torch dtype (through an empty array)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype
