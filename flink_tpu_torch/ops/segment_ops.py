"""Segment/scatter helpers for keyed state (port of
``flink_tpu/ops/segment_ops.py``).

Conventions kept from the reference: slot 0 is the identity slot (padded
lanes point at it with identity values), and batch dimensions are padded to
power-of-two buckets so the set of shapes stays small.

The reduce maps are recast for torch: a scatter reduce becomes
``index_add_`` (sum) or ``scatter_reduce_`` with ``amax``/``amin``; a merge
across the slice axis becomes ``sum``/``amax``/``amin`` over that axis (the
last dim of a gathered ``[..., k]`` slot matrix).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


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
SCATTER_METHOD: Dict[str, Callable] = {
    "sum": _scatter_add,
    "max": _scatter_max,
    "min": _scatter_min,
}

#: merge across the slice axis (the last dim) of gathered partials
MERGE_FN: Dict[str, Callable] = {
    "sum": lambda x: torch.sum(x, dim=-1, dtype=x.dtype),
    "max": lambda x: torch.amax(x, dim=-1),
    "min": lambda x: torch.amin(x, dim=-1),
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
