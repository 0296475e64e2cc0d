"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (``flink_tpu_torch/csrc/build/``, ignored by
git), stamped by the hash of its source and the compiler's version, and
loaded with ``ctypes``. A build happens at first use, never at import:
this module imports nothing that needs a card or a compiler.

:func:`build_all` starts one ``nvcc`` per source at once, so a cold start
pays for the slowest build, not for the sum of them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_SRC_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_declares: Dict[str, Callable[[ctypes.CDLL], None]] = {}
_nvcc_version: Dict[str, str] = {}


def register(source: str, declare: Callable[[ctypes.CDLL], None]) -> None:
    """Name a kernel source under ``csrc/`` and the function that declares
    its C symbols' ``argtypes``/``restype`` once it is loaded."""
    _declares[source] = declare


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("the port's CUDA kernels need nvcc "
                       "(not on PATH, not in /usr/local/cuda/bin)")


def _compile(source: str) -> str:
    """Build ``csrc/<source>`` unless its stamp is current; returns the
    compiler's log (empty for a current build). Raises on failure."""
    from flink_tpu_torch.native import build_cached

    nvcc = _nvcc()
    with _lock:
        if nvcc not in _nvcc_version:
            _nvcc_version[nvcc] = subprocess.run(
                [nvcc, "--version"], capture_output=True, text=True,
                timeout=60).stdout
    src = os.path.join(_SRC_DIR, source)
    so = _so_path(source)
    ok, log = build_cached(
        src, so, lambda tmp: [nvcc, *NVCC_FLAGS, "-o", tmp, src],
        provenance=f"{_nvcc_version[nvcc]};{' '.join(NVCC_FLAGS)}",
        timeout=600)
    if not ok:
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    return log


def _so_path(source: str) -> str:
    return os.path.join(_BUILD_DIR,
                        "lib" + os.path.splitext(source)[0] + ".so")


def load(source: str) -> Tuple[ctypes.CDLL, str]:
    """The loaded library of ``csrc/<source>``, built first if needed.
    Returns ``(library, compiler log)``; the log is empty when nothing was
    compiled."""
    with _lock:
        lib = _libs.get(source)
    if lib is not None:
        return lib, ""
    log = _compile(source)
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(_so_path(source))
            _declares[source](lib)
            _libs[source] = lib
        return _libs[source], log


def build_all() -> Dict[str, str]:
    """Build every registered kernel source, one ``nvcc`` each, all
    started together; returns ``{source: compiler log}``. Raises the
    first build failure."""
    import flink_tpu_torch.stateplane.fold  # noqa: F401  (registers)
    import flink_tpu_torch.stateplane.rank  # noqa: F401  (registers)

    sources = sorted(_declares)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(load, sources))
    return {s: log for s, (_, log) in zip(sources, logs)}
