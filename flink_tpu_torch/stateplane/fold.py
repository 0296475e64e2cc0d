"""Stream-ordered scatter folds for float accumulators.

The reference folds a batch into its planes with XLA scatters — per shard
``a.at[0, recv_s].add/max/min`` on int32 ``recv_s`` — which on the CPU apply
the updates in index order: for a float sum that order is part of the
result. torch's CPU ``index_add_`` adds in the same order, with the same
NaN bits (a later NaN lane replaces an earlier NaN, the starting value's
NaN survives lanes that are not NaN, an ``inf - inf`` gives the x86
default NaN ``0xffc00000``); torch's CUDA ``index_add_`` does not keep the
order (atomics). The reference's float max/min propagate NaN and order
-0.0 below +0.0; torch's ``scatter_reduce_("amax"/"amin")`` keeps whichever
signed zero came first.

- :func:`ordered_fold_planes` is the entry in the callers' own layout:
  ``acc [P, cap]``, ``slots`` int32 ``[P, L]``, ``values [P, L]``. Slot 0 of
  each plane is the identity slot (padding lanes land there with the
  identity); the kernel drops those lanes at its first read.
- The ``*_plain`` functions are ``index_add_`` and an order-key
  ``scatter_reduce_`` on a flat accumulator and int64 targets, and
  :func:`ordered_fold_planes_plain` on top of them — the CPU path and the
  kernel's parity oracles (run on the CPU). :func:`group_planes_plain` is
  the grouping's oracle: per plane, the kept lanes stably sorted by slot.

A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel ``flink_tpu_torch/csrc/ordered_fold.cu`` (a stable LSD
radix grouping over int32 slots that carries the values, then one warp per
short run and one block per long run fold each run in lane order) or
raises. ``ordered_fold_planes.launches`` counts the calls that launched
it. All update the accumulator in place and return it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flink_tpu_torch.stateplane import cuda_build
from flink_tpu_torch.stateplane.rank import claim_status

_SOURCE = "ordered_fold.cu"
_OPS = {"sum": 0, "max": 1, "min": 2}
_FLOATS = {torch.float32: 4, torch.float64: 8}
_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.ordered_fold_passes.restype = c.c_int32
    lib.ordered_fold_passes.argtypes = [c.c_int64]
    lib.ordered_fold_max_lanes.restype = c.c_int64
    lib.ordered_fold_max_lanes.argtypes = []
    lib.ordered_fold_scratch_bytes.restype = c.c_int64
    lib.ordered_fold_scratch_bytes.argtypes = [c.c_int64, c.c_int64,
                                               c.c_int64, c.c_int32,
                                               c.POINTER(c.c_int64)]
    lib.ordered_fold_status_elems.restype = c.c_int64
    lib.ordered_fold_status_elems.argtypes = [c.c_int64, c.c_int64]
    lib.ordered_fold_launch.restype = c.c_int
    lib.ordered_fold_launch.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_uint32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_void_p]


cuda_build.register(_SOURCE, _declare)


def build_fold_kernel():
    """Build (if stale) and load the kernel library: ``(lib, log)``."""
    return cuda_build.load(_SOURCE)


def order_key(x: torch.Tensor) -> torch.Tensor:
    """Float -> signed integer of the same width whose order is the float
    order with -0.0 < +0.0 (NaNs land beyond ±inf by sign). Its own
    inverse: ``order_key(order_key(x).view(float))`` gives back x's bits."""
    b = x.view(_INT_OF[x.dtype])
    return b ^ ((b >> (8 * x.element_size() - 1))
                & torch.iinfo(b.dtype).max)


def from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (k ^ ((k >> (8 * k.element_size() - 1))
                 & torch.iinfo(k.dtype).max)).view(dtype)


def nan_bits(x: torch.Tensor, quiet: bool) -> torch.Tensor:
    """x's NaN quieted (``quiet``: its payload and sign kept), or else the
    x86 default NaN of an ``inf - inf`` (``0xffc00000``; float64
    ``0xfff8000000000000``), as x's dtype: the two NaNs a sum on the CPU
    gives."""
    b = x.view(_INT_OF[x.dtype])
    if x.dtype == torch.float32:
        mask, default = 0x00400000, -0x00400000
    else:
        mask, default = 0x0008000000000000, -0x0008000000000000
    return (b | mask if quiet else torch.full_like(b, default)).view(x.dtype)


# ---------------------------------------------------------------- plain

def ordered_scatter_add_plain(acc_flat: torch.Tensor, target: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """``acc_flat[t] += v[i]`` in lane order: torch's ``index_add_``,
    which is that order on the CPU (and bit for bit XLA's ``.at[].add``,
    NaN bits included)."""
    return acc_flat.index_add_(0, target, v)


def ordered_scatter_reduce_plain(acc_flat: torch.Tensor,
                                 target: torch.Tensor, v: torch.Tensor,
                                 reduce: str) -> torch.Tensor:
    """Plain version of :func:`ordered_scatter_reduce` (any device, exact
    for max/min on any device, stream-ordered for sum on the CPU)."""
    if reduce == "sum":
        return ordered_scatter_add_plain(acc_flat, target, v)
    nan = torch.isnan(acc_flat) | torch.zeros(
        acc_flat.shape, dtype=torch.int32, device=acc_flat.device
    ).index_add_(0, target, torch.isnan(v).to(torch.int32)).bool()
    keys = order_key(acc_flat).clone()
    keys.scatter_reduce_(0, target, order_key(v),
                         reduce="amax" if reduce == "max" else "amin")
    acc_flat.copy_(from_order_key(keys, acc_flat.dtype))
    return acc_flat.masked_fill_(nan, float("nan"))


def ordered_fold_planes_plain(acc: torch.Tensor, slots: torch.Tensor,
                              values: torch.Tensor,
                              reduce: str) -> torch.Tensor:
    """Plain version of :func:`ordered_fold_planes`: the reference's
    per-shard ``a.at[0, recv_s]`` — each plane folded on its own, every
    lane (slot 0 included) in lane order."""
    for p in range(acc.shape[0]):
        ordered_scatter_reduce_plain(acc[p], slots[p].to(torch.int64),
                                     values[p], reduce)
    return acc


def group_planes_plain(slots: torch.Tensor, values: torch.Tensor, cap: int):
    """The grouping the kernel does before it folds: per plane, the lanes
    whose slot is kept (in ``[1, cap)``: slot 0 is the identity slot)
    stably sorted by slot. Returns a list of ``(slots int32, values)``
    pairs, one per plane."""
    out = []
    for s, v in zip(slots.to(torch.int64), values):
        kept = (s > 0) & (s < cap)
        s, v = s[kept], v[kept]
        order = torch.sort(s, stable=True).indices
        out.append((s[order].to(torch.int32), v[order]))
    return out


# --------------------------------------------------------------- kernel

def _launch(acc: torch.Tensor, slots: torch.Tensor, values: torch.Tensor,
            reduce: str, cap: int, fold: bool):
    """Check, allocate scratch, launch. Returns ``(scratch, layout)`` or
    None when there is nothing to fold."""
    if slots.dtype != torch.int32:
        raise TypeError(f"ordered fold: int32 slots, got {slots.dtype}")
    if slots.dim() != 2 or slots.shape != values.shape:
        raise ValueError("ordered fold: slots and values [P, L], got "
                         f"{tuple(slots.shape)}, {tuple(values.shape)}")
    if reduce not in _OPS:
        raise ValueError(f"ordered fold: unknown reduce {reduce!r}")
    if values.dtype not in _FLOATS or (acc is not None
                                       and acc.dtype != values.dtype):
        raise TypeError(f"ordered fold: float32/float64 acc and values of "
                        f"one dtype, got {values.dtype}"
                        f"{'' if acc is None else f' and {acc.dtype}'}")
    tensors = [slots, values] + ([acc] if acc is not None else [])
    if any(t.device != values.device for t in tensors):
        raise ValueError("ordered fold: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ordered fold: acc, slots and values must be "
                         "contiguous")
    P, L = slots.shape
    if not 1 <= cap <= 0x7FFFFFFF:
        raise ValueError(f"ordered fold: plane width {cap} outside "
                         "[1, 2**31 - 1]")
    if P > 65535:
        raise ValueError(f"ordered fold: {P} planes; the kernel takes at "
                         "most 65535")
    lib, _ = build_fold_kernel()
    if P == 0 or L == 0:
        return None
    eb = _FLOATS[values.dtype]
    nbytes, layout, passes, status_elems = _plan(lib, P, L, cap, eb)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=values.device)
    dev, stream, words, epoch = claim_status(values.device, status_elems,
                                             epochs=passes)
    rc = lib.ordered_fold_launch(
        slots.data_ptr(), values.data_ptr(),
        acc.data_ptr() if acc is not None else None, P, L, cap,
        scratch.data_ptr(), words.data_ptr(), epoch, eb, _OPS[reduce],
        1 if fold else 0, dev, stream)
    if rc != 0:
        raise RuntimeError(f"ordered fold launch failed: cudaError_t {rc}")
    return scratch, layout


@functools.lru_cache(maxsize=64)
def _plan(lib: ctypes.CDLL, P: int, L: int, cap: int, eb: int):
    """Per shape: scratch bytes, the grouped output's layout in the
    scratch, radix passes, status words. Raises on a shape the kernel
    cannot take."""
    if L > lib.ordered_fold_max_lanes():
        raise ValueError(f"ordered fold: {L} lanes per plane; the kernel's "
                         f"status words hold {lib.ordered_fold_max_lanes()}")
    out = (ctypes.c_int64 * 4)()
    nbytes = lib.ordered_fold_scratch_bytes(P, L, cap, eb, out)
    return (nbytes, tuple(out), lib.ordered_fold_passes(cap),
            lib.ordered_fold_status_elems(P, L))


def ordered_fold_planes(acc: torch.Tensor, slots: torch.Tensor,
                        values: torch.Tensor, reduce: str) -> torch.Tensor:
    """``acc[p, s] = reduce(acc[p, s], values[p, i])`` over the lanes i of
    plane p with ``slots[p, i] == s``, in lane order; ``reduce`` is sum,
    max or min. Lanes at slot 0 (each plane's identity slot) carry the
    identity: the kernel drops them, the plain version folds them, and
    both leave the slot's bits as they were. A CUDA tensor launches the
    kernel once per call that has lanes (``ordered_fold_planes.launches``)
    or raises."""
    if acc.device.type == "cpu":
        return ordered_fold_planes_plain(acc, slots, values, reduce)
    if acc.device.type != "cuda":
        raise ValueError(f"ordered fold: unsupported device {acc.device}")
    if acc.dim() != 2 or slots.shape[:1] != acc.shape[:1]:
        raise ValueError("ordered fold: acc [P, cap], slots and values "
                         f"[P, L], got {tuple(acc.shape)}, "
                         f"{tuple(slots.shape)}, {tuple(values.shape)}")
    if _launch(acc, slots, values, reduce, acc.shape[1],
               fold=True) is not None:
        ordered_fold_planes.launches += 1
    return acc


ordered_fold_planes.launches = 0


def group_planes(slots: torch.Tensor, values: torch.Tensor, cap: int):
    """The kernel's grouping alone (its histogram and radix passes, no
    fold), for holding it against :func:`group_planes_plain`: the same
    list of per-plane ``(slots int32, values)``. CUDA tensors only; not
    counted in ``ordered_fold_planes.launches``."""
    if slots.device.type != "cuda":
        raise ValueError("group_planes: CUDA slots and values [P, L]")
    got = _launch(None, slots, values, "sum", int(cap), fold=False)
    P = slots.shape[0]
    if got is None:
        return [(slots.new_empty(0, dtype=torch.int32), values.new_empty(0))
                for _ in range(P)]
    scratch, (ld, v_off, k_off, n_off) = got
    eb = values.element_size()
    vals = scratch[v_off:v_off + P * ld * eb].view(values.dtype).view(P, ld)
    keys = scratch[k_off:k_off + P * ld * 4].view(torch.int32).view(P, ld)
    counts = scratch[n_off:n_off + 4 * P].view(torch.int32).tolist()
    return [(keys[p, :n], vals[p, :n]) for p, n in enumerate(counts)]
