"""Segment/scatter helpers for keyed state (port of
``flink_tpu/ops/segment_ops.py``).

Conventions kept from the reference: slot 0 is the identity slot (padded
lanes point at it with identity values), and batch dimensions are padded to
power-of-two buckets so the set of shapes stays small.

The reduce maps are recast for torch. A scatter reduce of an integer
leaf is ``index_add_`` (sum) or ``scatter_reduce_`` with ``amax``/``amin``:
integer folds are exact in any order. A float leaf folds through
``stateplane/fold.py`` (:func:`scatter_fold`), in stream order on the card
as on the CPU, with the reference's NaN and signed-zero rules for max/min.
A merge across the slice axis (the last dim of a gathered ``[..., k]``
slot matrix) is, for sum, a left fold ``((0 + x0) + x1) + ...`` — the
order XLA's CPU reduce takes, which ``torch.sum`` does not keep — and for
float max/min a reduction over order keys.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from flink_tpu_torch.stateplane.fold import (
    from_order_key,
    order_key,
    ordered_scatter_reduce,
)


def _scatter_add(acc: torch.Tensor, idx: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    return acc.index_add_(0, idx, v)


def _scatter_max(acc: torch.Tensor, idx: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    return acc.scatter_reduce_(0, idx, v, reduce="amax")


def _scatter_min(acc: torch.Tensor, idx: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    return acc.scatter_reduce_(0, idx, v, reduce="amin")


#: scatter reduce -> in-place fold ``(acc[flat], idx int64, v) -> acc``
#: for integer leaves (exact in any order); see :func:`scatter_fold`
SCATTER_METHOD: Dict[str, Callable] = {
    "sum": _scatter_add,
    "max": _scatter_max,
    "min": _scatter_min,
}


def scatter_fold(reduce: str, dtype: torch.dtype) -> Callable:
    """The in-place fold ``(acc_flat, idx int64, v, identity_stride) ->
    acc_flat`` of one leaf: float leaves keep the reference's order and
    semantics through the ordered fold (its CUDA kernel on the card, which
    skips the identity slot every ``identity_stride`` lanes of the plane);
    integer leaves keep ``index_add_``/``scatter_reduce_``, whose atomics
    cannot change an integer result."""
    if not dtype.is_floating_point:
        method = SCATTER_METHOD[reduce]
        return lambda acc, idx, v, identity_stride=0: method(acc, idx, v)
    return functools.partial(ordered_scatter_reduce, reduce=reduce)


def _merge_sum(x: torch.Tensor) -> torch.Tensor:
    # XLA's CPU reduce: start from 0, add the slices left to right
    acc = x[..., 0] + 0
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


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
