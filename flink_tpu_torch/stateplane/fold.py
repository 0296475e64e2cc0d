"""Stream-ordered scatter folds for float accumulators.

The reference folds a batch into its planes with XLA scatters, which on the
CPU apply the updates in index order — for a float sum that order is part
of the result. torch's CPU ``index_add_`` adds in the same order, torch's
CUDA ``index_add_`` does not (atomics). The reference's float max/min
(``.at[].max/min``) propagate NaN and order -0.0 below +0.0; torch's
``scatter_reduce_("amax"/"amin")`` keeps whichever signed zero came first.

- :func:`ordered_scatter_add_plain` is ``index_add_`` — the CPU path and
  the kernel's parity oracle (run on the CPU).
- :func:`ordered_scatter_reduce_plain` adds max/min with the reference's
  semantics, through an integer key whose order is the float order with
  -0.0 < +0.0 (exact, order-free).
- :func:`ordered_scatter_add` / :func:`ordered_scatter_reduce` are the
  wrappers: a CPU tensor takes the plain version; a CUDA tensor launches
  the hand-written kernel ``flink_tpu_torch/csrc/ordered_fold.cu`` (the
  targets grouped by a stable ``torch.sort``, then one warp per run folds
  it in lane order) or raises. ``ordered_scatter_add.launches`` counts the
  kernel's launches, whichever wrapper made them.

All update ``acc_flat`` in place and return it. ``identity_stride`` (the
plane capacity of the ``[P, cap]`` callers) names the reserved identity
slot 0 of each shard plane, where padded lanes land with the identity: the
kernel skips those lanes, the plain version folds them, and both leave the
slot's bits as they were.
"""

from __future__ import annotations

import ctypes

import torch

from flink_tpu_torch.stateplane import cuda_build

_SOURCE = "ordered_fold.cu"
_OPS = {"sum": 0, "max": 1, "min": 2}
_FLOATS = {torch.float32: 4, torch.float64: 8}
_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.ordered_fold_launch.restype = c.c_int
    lib.ordered_fold_launch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                        c.c_void_p, c.c_void_p, c.c_int64,
                                        c.c_int64, c.c_int64, c.c_int32,
                                        c.c_int32, c.c_int32, c.c_void_p]


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


def ordered_scatter_add_plain(acc_flat: torch.Tensor, target: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """``acc_flat[t] += v[i]`` in lane order: torch's ``index_add_``,
    which is that order on the CPU (and bit for bit XLA's ``.at[].add``)."""
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


def ordered_scatter_reduce(acc_flat: torch.Tensor, target: torch.Tensor,
                           v: torch.Tensor, reduce: str,
                           identity_stride: int = 0) -> torch.Tensor:
    """``acc_flat[t] = reduce(acc_flat[t], v[i])`` over the lanes i with
    ``target[i] == t``, in lane order; ``reduce`` is sum, max or min."""
    if acc_flat.device.type == "cpu":
        return ordered_scatter_reduce_plain(acc_flat, target, v, reduce)
    if acc_flat.device.type != "cuda":
        raise ValueError(f"ordered fold: unsupported device {acc_flat.device}")
    if reduce not in _OPS:
        raise ValueError(f"ordered fold: unknown reduce {reduce!r}")
    if acc_flat.dtype not in _FLOATS or v.dtype != acc_flat.dtype:
        raise TypeError(f"ordered fold: float32/float64 acc and values of "
                        f"one dtype, got {acc_flat.dtype} and {v.dtype}")
    if target.dtype != torch.int64:
        raise TypeError(f"ordered fold: int64 targets, got {target.dtype}")
    if acc_flat.dim() != 1 or target.dim() != 1 or v.dim() != 1 \
            or target.shape != v.shape:
        raise ValueError("ordered fold: 1-D acc, and targets and values of "
                         f"one length, got {tuple(acc_flat.shape)}, "
                         f"{tuple(target.shape)}, {tuple(v.shape)}")
    if not (acc_flat.is_contiguous() and v.is_contiguous()):
        raise ValueError("ordered fold: acc and values must be contiguous")
    if target.device != acc_flat.device or v.device != acc_flat.device:
        raise ValueError("ordered fold: tensors on different devices")
    lib, _ = build_fold_kernel()
    n = target.numel()
    if n == 0:
        return acc_flat
    keys, perm = torch.sort(target, stable=True)
    scratch = torch.empty_like(v)
    dev = acc_flat.device.index if acc_flat.device.index is not None \
        else torch.cuda.current_device()
    rc = lib.ordered_fold_launch(
        keys.data_ptr(), perm.data_ptr(), v.data_ptr(), scratch.data_ptr(),
        acc_flat.data_ptr(), n, acc_flat.numel(), int(identity_stride),
        _FLOATS[acc_flat.dtype], _OPS[reduce], dev,
        torch.cuda.current_stream(acc_flat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ordered fold launch failed: cudaError_t {rc}")
    ordered_scatter_add.launches += 1
    return acc_flat


def ordered_scatter_add(acc_flat: torch.Tensor, target: torch.Tensor,
                        v: torch.Tensor,
                        identity_stride: int = 0) -> torch.Tensor:
    """``acc_flat[t] += v[i]`` over the lanes hitting t, in lane order —
    on the card as on the CPU."""
    return ordered_scatter_reduce(acc_flat, target, v, "sum",
                                  identity_stride)


ordered_scatter_add.launches = 0
