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
dim of a gathered ``[..., k]`` slot matrix, :data:`MERGE_FN`; or the
leading dim of a pane ring's ``[k, C]`` rows, :data:`MERGE_ROWS_FN` and
:data:`FOLD_ROWS_FN`) is, for sum, the order XLA's CPU reduce takes — a
left fold ``((0 + x0) + x1) + ...`` for few slices, vector lanes and
chunks for more, none of which ``torch.sum`` keeps — and for float
max/min a reduction over order keys with x86's NaN rule.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.stateplane.fold import (
    from_order_key,
    nan_bits,
    nan_priority,
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


def _fold_rows(x: torch.Tensor, new_first: bool = False) -> torch.Tensor:
    """``x [..., m, c]`` added along axis -2 from 0, left to right, for
    each of the c columns at once: ``[..., c]``. ``new_first``: each add
    takes the row as its first operand (``x_j + acc``): the same finite
    sum, but where both are NaN the row's NaN, the LATER one, is kept."""
    acc = torch.zeros_like(x[..., 0, :])
    for j in range(x.shape[-2]):
        acc = _add(x[..., j, :], acc) if new_first else \
            _add(acc, x[..., j, :])
    return acc


def _lanes(x: torch.Tensor, lanes: int, width: int,
           pane: bool = False) -> torch.Tensor:
    """The vectorised form of XLA's CPU reduce over the last dim: ``lanes``
    accumulators from 0, lane i adding slices i, i + lanes, ... of the
    first ``lanes * (k // lanes)``; the accumulators taken as vectors of
    ``width`` and added vector by vector, left to right; that vector
    halved (lane i + lane i + width/2, ..., then i + i+1); the last
    ``k % lanes`` slices added to it left to right.

    ``pane``: the operand order of the pane fire, which shows only in which
    of two NaNs a sum keeps (``tests/reference_fire_order.py --program
    pane``, 4,096 and 7 columns): float64 adds each further vector as the
    FIRST operand, and float32 at 32 rows adds each row of a lane as the
    first operand (:func:`_fold_rows`'s ``new_first``)."""
    k = x.shape[-1]
    m = k // lanes * lanes
    acc = _fold_rows(x[..., :m].unflatten(-1, (m // lanes, lanes)),
                     new_first=pane and (width, k) == (8, 32))
    vec = acc[..., :width]
    for j in range(width, lanes, width):
        vec = _add(acc[..., j:j + width], vec) if pane and width == 4 \
            else _add(vec, acc[..., j:j + width])
    w = width
    while w > 1:
        w //= 2
        vec = _add(vec[..., :w], vec[..., w:2 * w])
    acc = vec[..., 0]
    for j in range(m, k):
        acc = _add(acc, x[..., j])
    return acc


def _lane_shape(x: torch.Tensor, k: int) -> Tuple[int, int]:
    """(lanes, vector width) of XLA's vectorised reduce of k <= 32 slices
    on a 256-bit host: 8 lanes, in one float32 vector or two float64
    vectors; float64 at k = 32: 16 lanes in four vectors."""
    width = 32 // x.element_size()
    return (16 if (width, k) == (4, 32) else 8), width


def _merge_sum(x: torch.Tensor, lanes_from: int = 28,
               pane: bool = False) -> torch.Tensor:
    """The order in which XLA's CPU reduce adds the slice axis (the last
    dim) of a fire. The reference's fire takes it from its CPU backend,
    whose loop follows the host's vector width (256 bits: 8 float32 or 4
    float64 lanes a vector), so the port emulates the order that backend
    takes on an AVX host, measured by ``tests/reference_fire_order.py``
    over float32 and float64 Sum and float32 Avg, in the single-device,
    the mesh and the pane fire:

    - k = 1: the slice as it is (a signalling NaN stays signalling, -0.0
      stays -0.0);
    - 2 <= k < ``lanes_from``: left to right from 0, ``((0 + x0) + x1) +
      ...``; ``lanes_from`` is 28 in the slot fires (a reduce of the last
      axis), 25 in the pane fire (a reduce of the leading axis, with the
      columns as the vector axis), and 33 — a left fold to 32 — in the pane
      table's window-partial fold;
    - ``lanes_from`` <= k <= 32 (:func:`_lanes`, :func:`_lane_shape`);
    - k > 32: the slices cut into chunks (:func:`_chunk_sizes`), each
      chunk added left to right from 0, then the chunk sums left to right
      from 0.

    That is the reference's sum bit for bit at every k measured, 1 to 300
    (closed ROADMAP Queue C entries; pinned by
    ``tests/test_torch_merge_order.py``). A NaN sum takes the NaN of the add
    where it first appeared, the earlier operand's when both are NaN
    (where one add meets two NaNs the reference's compiled loops keep
    either) — ``pane``: the pane fire's operand order in
    the lanes form (:func:`_lanes`). Integer sums are exact in any
    order."""
    k = x.shape[-1]
    if k == 1:
        return x[..., 0].clone()
    if not x.dtype.is_floating_point:
        return x.sum(dim=-1, dtype=x.dtype)
    if k < lanes_from and k <= 32:
        return _fold_rows(x.unsqueeze(-1))[..., 0]
    if k <= 32:
        return _lanes(x, *_lane_shape(x, k), pane=pane)
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


def _merge_extreme(x: torch.Tensor, reduce: str,
                   last: bool = True) -> torch.Tensor:
    """Max/min over the last dim as XLA's x86 reduce gives them: -0.0
    below +0.0, and where the slices hold a NaN its bits — for max the
    first negative NaN, else the last NaN; for min the first positive NaN,
    else the last NaN (the ingest fold's rule, ``nan_priority``), the
    slices met left to right (the fires meet 23 to 32 slices in another
    order: :func:`_extreme_order`). ``last=False`` keeps the FIRST NaN
    where no NaN of the priority sign is met (how the pane fire joins two
    partials at 23 rows: :func:`_merge_pane_extreme_23`)."""
    red = torch.amax if reduce == "max" else torch.amin
    if not x.dtype.is_floating_point:
        return red(x, dim=-1)
    out = from_order_key(red(order_key(x), dim=-1), x.dtype)
    nan = torch.isnan(x)
    if not nan.any():
        return out
    k = x.shape[-1]
    pos = torch.arange(k, device=x.device)
    first = torch.where(nan_priority(x, reduce), pos, k).amin(dim=-1)
    other = (torch.where(nan, pos, -1).amax(dim=-1) if last else
             torch.where(nan, pos, k).amin(dim=-1).masked_fill_(
                 ~nan.any(dim=-1), -1))
    keep = torch.where(first < k, first, other)
    picked = x.gather(-1, keep.clamp(min=0).unsqueeze(-1)).squeeze(-1)
    return torch.where(keep >= 0, picked, out)


def _extreme_order(k: int, width: int, lanes_from: int):
    """The order in which a fire's max/min — XLA's CPU reduce of k slices —
    meets them, where it is not 0, 1, ..., k - 1 (None): from
    ``lanes_from`` to 32 slices the reduce runs in vector lanes (measured
    by ``tests/reference_fire_order.py``).
    ``lanes_from`` is 25 in the slot layout's fires (a reduce of the last
    axis) and 23 in the pane fire (the leading axis of ``[k, C]``, which
    meets 23 rows in a tree of its own: :func:`_merge_pane_extreme_23`);
    ``width``: lanes of one 256-bit vector, 8 for float32, 4 for float64.
    Lane i of the accumulators takes slices i, i + lanes, ...; the x86 NaN
    rule is associative, so the reduce keeps the NaN that the sequential
    rule keeps over the slices in the returned order."""
    if not lanes_from <= k <= 32:
        return None
    lanes = 16 if (width, k) == (4, 32) else 8
    m = k // lanes * lanes
    if width == 8:   # one vector, halved once, then in order
        lane_order = [0, 4, 1, 5, 2, 6, 3, 7]
    else:            # vectors of 4 added left to right, then halved
        lane_order = [p + 4 * j for p in (0, 2, 1, 3)
                      for j in range(lanes // 4)]
    return [r for lane in lane_order for r in range(lane, m, lanes)] + \
        list(range(m, k))


def _merge_pane_extreme_23(x: torch.Tensor, reduce: str) -> torch.Tensor:
    """The pane fire's max/min over 23 rows (the last dim of ``x``), a
    tree measured by ``tests/reference_fire_order.py --program pane`` from
    pairs of NaNs of the priority sign (which one is met first) and of
    the other sign (which one is met last): rows 0-15 in four lanes
    (float32 lanes 0, 1, 2, 3 in turn; float64 0, 2, 1, 3), rows 16-18
    on their own (float64: 16, 18, 17), the two partials joined keeping
    the first NaN of either kind — rows 0-15 before 16-18 —, then rows
    19-22 one by one."""
    pos = [0, 1, 2, 3] if x.element_size() == 4 else [0, 2, 1, 3]
    head = _merge_extreme(x[..., [r for p in pos for r in range(p, 16, 4)]],
                          reduce)
    mid = _merge_extreme(x[..., [16, 17, 18] if x.element_size() == 4
                            else [16, 18, 17]], reduce)
    joined = _merge_extreme(torch.stack([head, mid], dim=-1), reduce,
                            last=False)
    return _merge_extreme(torch.cat([joined.unsqueeze(-1), x[..., 19:23]],
                                    dim=-1), reduce)


def _merge_fire_extreme(x: torch.Tensor, reduce: str,
                        lanes_from: int = 25) -> torch.Tensor:
    """A fire's max/min over the last dim of ``x [..., k]``; the pane fire
    (``lanes_from`` 23) meets 23 rows in :func:`_merge_pane_extreme_23`'s
    tree."""
    if (lanes_from, x.shape[-1]) == (23, 23) and x.dtype.is_floating_point:
        return _merge_pane_extreme_23(x, reduce)
    order = _extreme_order(x.shape[-1], 32 // x.element_size(), lanes_from) \
        if x.dtype.is_floating_point else None
    if order is not None:
        x = x[..., order]
    return _merge_extreme(x, reduce)


#: merge across the slice axis (the last dim) of gathered partials — the
#: slot layout's fires. The orders follow XLA's CPU vector width (256
#: bits): a host with other vectors orders the reference's reduce
#: otherwise.
MERGE_FN: Dict[str, Callable] = {
    "sum": _merge_sum,
    "max": functools.partial(_merge_fire_extreme, reduce="max"),
    "min": functools.partial(_merge_fire_extreme, reduce="min"),
}


def _rows(merge: Callable, **kw) -> Callable:
    return lambda a: merge(a.movedim(0, -1), **kw)


#: merge across the LEADING axis of a pane ring's gathered rows ``[k, C]``
#: (the pane fire, ``fire_rows``): XLA's CPU reduce takes the vector
#: lanes form from k = 25 there for sums, and meets 23 to 32 rows out of
#: order for max/min (measured by
#: ``tests/reference_fire_order.py``). The emulation follows XLA's
#: CPU vector width (256 bits): a host with other vectors orders the
#: reference's reduce otherwise.
MERGE_ROWS_FN: Dict[str, Callable] = {
    "sum": _rows(_merge_sum, lanes_from=25, pane=True),
    "max": _rows(_merge_fire_extreme, reduce="max", lanes_from=23),
    "min": _rows(_merge_fire_extreme, reduce="min", lanes_from=23),
}

#: the same merge as the pane table's window-partial fold (``fold_rows``)
#: compiles it: a left fold up to 32 rows, chunks past it
FOLD_ROWS_FN: Dict[str, Callable] = {
    "sum": _rows(_merge_sum, lanes_from=33),
    "max": _rows(_merge_extreme, reduce="max"),
    "min": _rows(_merge_extreme, reduce="min"),
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
