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
  ``xla_rank`` in torch — the CPU path and the kernel's parity oracle.
- :func:`rank` is the wrapper: a CPU tensor goes to :func:`rank_plain`; a
  CUDA tensor goes to the hand-written counting-sort kernel
  (``flink_tpu_torch/csrc/rank.cu``, built with ``nvcc`` for ``sm_90a`` at
  first use) or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "rank.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "csrc", "build")
_SO = os.path.join(_BUILD_DIR, "librank.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("the exchange-rank CUDA kernel needs nvcc "
                       "(not on PATH, not in /usr/local/cuda/bin)")


def build_rank_kernel() -> Tuple[ctypes.CDLL, str]:
    """Build (if its source-hash stamp is stale) and load the kernel
    library. Returns ``(library, compiler log)``; the log is empty when the
    cached build was current. Raises when the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib, ""
        from flink_tpu_torch.native import build_cached

        nvcc = _nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
        ok, log = build_cached(
            _SRC, _SO, lambda tmp: [nvcc, *NVCC_FLAGS, "-o", tmp, _SRC],
            provenance=f"{version};{' '.join(NVCC_FLAGS)}", timeout=600)
        if not ok:
            raise RuntimeError(f"nvcc failed to build {_SRC}:\n{log}")
        lib = ctypes.CDLL(_SO)
        c = ctypes
        lib.rank_max_dests.restype = c.c_int
        lib.rank_max_dests.argtypes = []
        lib.rank_scratch_elems.restype = c.c_int64
        lib.rank_scratch_elems.argtypes = [c.c_int64, c.c_int64, c.c_int32]
        lib.rank_launch.restype = c.c_int
        lib.rank_launch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                    c.c_int64, c.c_int64, c.c_int32,
                                    c.c_int32, c.c_void_p]
        _lib = lib
        return lib, log


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


def rank(d: torch.Tensor, num_dests: int) -> torch.Tensor:
    """Rank within destination: :func:`rank_plain` for a CPU tensor, the
    CUDA kernel for a CUDA tensor. ``rank.launches`` counts the kernel's
    launches (one per call that reaches the card)."""
    if d.device.type == "cpu":
        return rank_plain(d, num_dests)
    if d.device.type != "cuda":
        raise ValueError(f"rank: unsupported device {d.device}")
    if d.dtype != torch.int32:
        raise TypeError(f"rank: d must be int32, got {d.dtype}")
    if d.dim() not in (1, 2):
        raise ValueError(f"rank: d must be [C] or [R, C], got {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("rank: d must be contiguous")
    lib, _ = build_rank_kernel()
    D = int(num_dests)
    if not 1 <= D <= lib.rank_max_dests():
        raise ValueError(
            f"rank: {D} destinations; the kernel's shared-memory histogram "
            f"holds 1..{lib.rank_max_dests()}")
    R, C = (1, d.shape[0]) if d.dim() == 1 else d.shape
    if R > 65535:
        raise ValueError(f"rank: {R} rows; the kernel takes at most 65535")
    out = torch.empty_like(d)
    if d.numel() == 0:
        return out
    scratch = torch.empty(lib.rank_scratch_elems(R, C, D),
                          dtype=torch.int32, device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = lib.rank_launch(d.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                         R, C, D, d.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"rank kernel launch failed: cudaError_t {rc}")
    rank.launches += 1
    return out


rank.launches = 0


def exchange_rank_flat(d: torch.Tensor, num_dests: int,
                       width: int) -> torch.Tensor:
    """Destination indices -> flat bucket offsets, same contract as the
    reference: ``d * width + rank`` for in-range lanes whose rank fits the
    bucket, else the sentinel ``num_dests * width``."""
    r = rank(d, num_dests)
    ok = (d < num_dests) & (r < width)
    return torch.where(ok, d * int(width) + r,
                       torch.full_like(d, int(num_dests) * int(width)))
