"""The exchange-rank program family: rank within destination (port of
``flink_tpu/stateplane/rank.py``).

For a staged matrix of destination indices ``d`` (int32 ``[R, C]``, one
independent row per source shard, or a single row ``[C]``) the rank of
record ``i`` is the count of PRIOR records of its row with the same
destination:

    rank(i) = #{j < i : 0 <= d_j < D and d_j == clip(d_i, 0, D-1)}

Out-of-range lanes read the clipped bucket's count and never add to it.
Ranks flatten to bucket offsets ``d * W + rank`` so the exchange keeps
stream order per destination (what keeps float folds in the reference's
order).

- :func:`rank_plain` is the one-hot-cumsum form of the reference's
  ``xla_rank`` in torch, and :func:`exchange_rank_flat_plain` the
  reference's ``exchange_rank_flat`` on top of it — the CPU path and the
  kernel's parity oracles.
- :func:`rank` and :func:`exchange_rank_flat` are the wrappers: a CPU
  tensor goes to the plain version; a CUDA tensor goes to the one-pass
  counting-sort kernel (``flink_tpu_torch/csrc/rank.cu``, built with
  ``nvcc`` for ``sm_90a`` at first use) or raises. There is no fallback
  between the two. Both launch the same kernel once per call; the flat
  form writes its int64 offsets directly.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from flink_tpu_torch.stateplane import cuda_build

_SOURCE = "rank.cu"


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.rank_max_dests.restype = c.c_int
    lib.rank_max_dests.argtypes = []
    lib.rank_max_lanes.restype = c.c_int64
    lib.rank_max_lanes.argtypes = []
    lib.rank_status_elems.restype = c.c_int64
    lib.rank_status_elems.argtypes = [c.c_int64, c.c_int64, c.c_int32]
    lib.rank_launch.restype = c.c_int
    lib.rank_launch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                c.c_int64, c.c_int64, c.c_int32, c.c_int64,
                                c.c_uint32, c.c_int32, c.c_int32,
                                c.c_void_p]


cuda_build.register(_SOURCE, _declare)


def build_rank_kernel() -> Tuple[ctypes.CDLL, str]:
    """Build (if its source-hash stamp is stale) and load the kernel
    library. Returns ``(library, compiler log)``; the log is empty when the
    cached build was current. Raises when the build fails."""
    return cuda_build.load(_SOURCE)


class _StatusBuffer:
    """The look-back status words of one (device, stream): zeroed once
    when (re)allocated, then tagged per launch by a new epoch."""

    def __init__(self) -> None:
        self.words = None
        self.epoch = 0

    def claim(self, n: int, device: torch.device,
              epochs: int = 1) -> Tuple[torch.Tensor, int]:
        """``n`` words and the first of ``epochs`` fresh epochs, one for
        each launch that will use them."""
        if self.words is None or self.words.numel() < n \
                or self.epoch + epochs > 0xFFFFFFFF:
            # stream-ordered: a kernel still reading the old buffer runs
            # before this memset on the same stream
            self.words = torch.zeros(max(n, 1), dtype=torch.int64,
                                     device=device)
            self.epoch = 0
        first = self.epoch + 1
        self.epoch += epochs
        return self.words, first


_status_lock = threading.Lock()
_status: Dict[Tuple[int, int], _StatusBuffer] = {}


def claim_status(device: torch.device, n: int, epochs: int = 1
                 ) -> Tuple[int, int, torch.Tensor, int]:
    """The look-back status words of ``device``'s current stream, shared
    by the port's kernels (launches on one stream run in order, and every
    launch gets epochs of its own): ``(device index, stream handle, at
    least n words, the first of ``epochs`` fresh epochs)``."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    with _status_lock:
        buf = _status.setdefault((dev, stream), _StatusBuffer())
        words, epoch = buf.claim(n, device, epochs)
    return dev, stream, words, epoch


def rank_plain(d: torch.Tensor, num_dests: int) -> torch.Tensor:
    """Rank within destination via one-hot + cumsum over the lane axis
    (the reference's ``xla_rank``); works on ``[C]`` and ``[R, C]``.
    O(C * D) memory — the plain version, not a fast one."""
    D = int(num_dests)
    dests = torch.arange(D, dtype=d.dtype, device=d.device)
    oh = (d.unsqueeze(-1) == dests).to(torch.int32)  # out of range: 0 row
    before = torch.cumsum(oh, dim=-2, dtype=torch.int32) - oh
    bucket = d.clamp(0, D - 1).to(torch.int64).unsqueeze(-1)
    return torch.gather(before, -1, bucket).squeeze(-1)


def exchange_rank_flat_plain(d: torch.Tensor, num_dests: int,
                             width: int) -> torch.Tensor:
    """The reference's ``exchange_rank_flat`` on :func:`rank_plain`, as
    int64: ``d * width + rank`` where ``d < num_dests`` and the rank fits
    the bucket, else the sentinel ``num_dests * width``."""
    r = rank_plain(d, num_dests)
    ok = (d < num_dests) & (r < width)
    d64 = d.to(torch.int64)
    return torch.where(ok, d64 * int(width) + r,
                       torch.full_like(d64, int(num_dests) * int(width)))


def _launch(d: torch.Tensor, num_dests: int, width: int,
            flat: bool) -> torch.Tensor:
    if d.device.type != "cuda":
        raise ValueError(f"rank: unsupported device {d.device}")
    if d.dtype != torch.int32:
        raise TypeError(f"rank: d must be int32, got {d.dtype}")
    if d.dim() not in (1, 2):
        raise ValueError(f"rank: d must be [C] or [R, C], got {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("rank: d must be contiguous")
    lib, _ = build_rank_kernel()
    D, max_dests = int(num_dests), lib.rank_max_dests()
    if not 1 <= D <= max_dests:
        raise ValueError(
            f"rank: {D} destinations; the kernel's shared-memory counts "
            f"hold 1..{max_dests}")
    R, C = (1, d.shape[0]) if d.dim() == 1 else d.shape
    if R > 65535:
        raise ValueError(f"rank: {R} rows; the kernel takes at most 65535")
    if C > lib.rank_max_lanes():
        raise ValueError(f"rank: {C} lanes per row; the kernel's status "
                         f"words hold at most {lib.rank_max_lanes()}")
    if flat and int(width) < 1:
        raise ValueError(f"exchange_rank_flat: width {width} < 1")
    out = torch.empty(d.shape, dtype=torch.int64 if flat else torch.int32,
                      device=d.device)
    if d.numel() == 0:
        return out
    dev, stream, words, epoch = claim_status(
        d.device, lib.rank_status_elems(R, C, D))
    rc = lib.rank_launch(d.data_ptr(), out.data_ptr(), words.data_ptr(),
                         R, C, D, int(width) if flat else 0, epoch,
                         1 if flat else 0, dev, stream)
    if rc != 0:
        raise RuntimeError(f"rank kernel launch failed: cudaError_t {rc}")
    rank.launches += 1
    return out


def rank(d: torch.Tensor, num_dests: int) -> torch.Tensor:
    """Rank within destination: :func:`rank_plain` for a CPU tensor, the
    CUDA kernel for a CUDA tensor. ``rank.launches`` counts the kernel's
    launches (one per call that reaches the card, whichever of ``rank``
    and :func:`exchange_rank_flat` made it)."""
    if d.device.type == "cpu":
        return rank_plain(d, num_dests)
    return _launch(d, num_dests, 0, flat=False)


rank.launches = 0


def exchange_rank_flat(d: torch.Tensor, num_dests: int,
                       width: int) -> torch.Tensor:
    """Destination indices -> int64 flat bucket offsets, same contract as
    the reference: ``d * width + rank`` where ``d < num_dests`` and the
    rank fits the bucket, else the sentinel ``num_dests * width``. One
    kernel launch on a CUDA tensor."""
    if d.device.type == "cpu":
        return exchange_rank_flat_plain(d, num_dests, width)
    return _launch(d, num_dests, width, flat=True)
