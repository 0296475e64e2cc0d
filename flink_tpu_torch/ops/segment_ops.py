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


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` with the NaN an x86 add gives: a's NaN quieted, else b's,
    else the default NaN of an ``inf - inf``. The card's adds give another
    NaN, so the rule is applied on every device."""
    s = a + b
    return torch.where(torch.isnan(s), torch.where(
        torch.isnan(a), nan_bits(a, True),
        torch.where(torch.isnan(b), nan_bits(b, True), nan_bits(s, False))),
        s)


def _fold_rows(x: torch.Tensor) -> torch.Tensor:
    """``x [..., m, c]`` added along axis -2 from 0, left to right, for
    each of the c columns at once: ``[..., c]``."""
    acc = torch.zeros_like(x[..., 0, :])
    for j in range(x.shape[-2]):
        acc = _add(acc, x[..., j, :])
    return acc


def _lanes(x: torch.Tensor, lanes: int, width: int) -> torch.Tensor:
    """The vectorised form of XLA's CPU reduce over the last dim: ``lanes``
    accumulators from 0, lane i adding slices i, i + lanes, ... of the
    first ``lanes * (k // lanes)``; the accumulators taken as vectors of
    ``width`` and added vector by vector, left to right; that vector
    halved (lane i + lane i + width/2, ..., then i + i+1); the last
    ``k % lanes`` slices added to it left to right."""
    k = x.shape[-1]
    m = k // lanes * lanes
    acc = _fold_rows(x[..., :m].unflatten(-1, (m // lanes, lanes)))
    vec = acc[..., :width]
    for j in range(width, lanes, width):
        vec = _add(vec, acc[..., j:j + width])
    w = width
    while w > 1:
        w //= 2
        vec = _add(vec[..., :w], vec[..., w:2 * w])
    acc = vec[..., 0]
    for j in range(m, k):
        acc = _add(acc, x[..., j])
    return acc


def _merge_sum(x: torch.Tensor) -> torch.Tensor:
    """The order in which XLA's CPU reduce adds the slice axis (the last
    dim) of a fire. The reference's fire takes it from its CPU backend,
    whose loop follows the host's vector width (256 bits: 8 float32 or 4
    float64 lanes a vector), so the port emulates the order that backend
    takes on an AVX host, measured by ``tests/reference_fire_order.py``
    over float32 and float64 Sum and float32 Avg, in the single-device
    and the mesh fire:

    - k = 1: the slice as it is (a signalling NaN stays signalling, -0.0
      stays -0.0);
    - 2 <= k <= 27: left to right from 0, ``((0 + x0) + x1) + ...``;
    - 28 <= k <= 32 (:func:`_lanes`): 8 lanes in one float32 vector of 8,
      or in two float64 vectors of 4; float64 at k = 32: 16 lanes in four
      vectors of 4;
    - k > 32: the slices cut into chunks (:func:`_chunk_sizes`), each
      chunk added left to right from 0, then the chunk sums left to right
      from 0.

    That is the reference's sum bit for bit at every k measured, 1 to 300
    (ROADMAP Queue C item 7). A NaN sum takes the NaN of the add where it
    first appeared, the earlier operand's when both are NaN (where one add
    meets two NaNs the reference's compiled loops keep either: Queue C
    item 6). Integer sums are exact in any order."""
    k = x.shape[-1]
    if k == 1:
        return x[..., 0].clone()
    if not x.dtype.is_floating_point:
        return x.sum(dim=-1, dtype=x.dtype)
    if k <= 27:
        return _fold_rows(x.unsqueeze(-1))[..., 0]
    if k <= 32:
        width = 32 // x.element_size()
        lanes = 16 if (width, k) == (4, 32) else 8
        return _lanes(x, lanes, width)
    # chunk j's slices as row j of an [n, 32] index, padded with column
    # k, a +0.0: a sum from +0.0 is never -0.0, so the pads leave it as
    # it is, NaN bits included
    sizes = _chunk_sizes(k)
    idx = torch.full((len(sizes), 32), k, dtype=torch.int64)
    start = 0
    for j, size in enumerate(sizes):
        idx[j, :size] = torch.arange(start, start + size)
        start += size
    xp = torch.nn.functional.pad(x, (0, 1))
    chunks = _fold_rows(xp[..., idx.to(x.device)].transpose(-1, -2))
    return _fold_rows(chunks.unsqueeze(-1))[..., 0]


def _chunk_sizes(k: int) -> list:
    """How XLA's CPU reduce cuts k > 32 slices: n = ceil(k / 32) chunks,
    the middle n - 2 of 32 slices, the first and the last halving the
    r = k - 32 (n - 2) others (the first taking the odd one)."""
    n = -(-k // 32)
    r = k - 32 * (n - 2)
    return [-(-r // 2)] + [32] * (n - 2) + [r // 2]


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

#: host-side elementwise combine of two partial-aggregate arrays (the
#: spill tier merges spilled slice values into device-fired results on
#: the host)
HOST_COMBINE: Dict[str, Callable] = {
    "sum": np.add,
    "max": np.maximum,
    "min": np.minimum,
}

_MIN_BUCKET = 256


def pad_i32(a: np.ndarray, size: int, fill: int = 0) -> np.ndarray:
    """Pad an int index array up to ``size`` with ``fill`` (slot 0)."""
    a = np.asarray(a, dtype=np.int32)
    if len(a) == size:
        return a
    out = np.full(size, fill, dtype=np.int32)
    out[: len(a)] = a
    return out


def pad_values(a: np.ndarray, size: int, fill) -> np.ndarray:
    a = np.asarray(a)
    if len(a) == size:
        return a
    out = np.full((size,) + a.shape[1:], fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


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
