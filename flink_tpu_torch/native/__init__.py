"""The port's loader for the repo's C++ host components (``native/*.cpp``).

Mirrors ``flink_tpu/native/__init__.py``'s ``load_native``: compile on
demand with ``g++`` into this package's own build directory
(``flink_tpu_torch/native/build/``, ignored by git), next to a
``.srchash`` stamp holding the sha256 of the source plus the build
provenance (compiler version, machine, CPU model — the build uses
``-march=native``). A stamp mismatch forces a rebuild; the build is
flock-guarded and lands through a temp name and ``os.replace``.

Every function fetched off a loaded library declares ``argtypes`` and
``restype`` before its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_PKG_DIR))
_SRC_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")

_lock = threading.Lock()
_libs = {}
_build_token: Optional[str] = None


def _build_provenance() -> str:
    global _build_token
    if _build_token is None:
        try:
            gxx = subprocess.run(["g++", "-dumpfullversion"],
                                 capture_output=True, timeout=10,
                                 text=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            gxx = "unknown"
        cpu = ""
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.startswith("model name"):
                        cpu = line.split(":", 1)[1].strip()
                        break
        except OSError:
            pass
        _build_token = f"g++={gxx};arch={platform.machine()};cpu={cpu}"
    return _build_token


def source_hash(src: str, provenance: str) -> str:
    """sha256 of a source file plus the toolchain token it is built with."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(b"\x00" + provenance.encode())
    return h.hexdigest()


def build_cached(src: str, so_path: str, cmd_for, provenance: str,
                 timeout: float = 300.0) -> Tuple[bool, str]:
    """Build ``src`` into ``so_path`` unless its stamp is current.

    ``cmd_for(tmp_path)`` returns the compiler command writing to
    ``tmp_path``. Returns ``(ok, compiler output)`` — the output is empty
    when the cached build was current; the caller decides whether a failed
    build is fatal."""
    stamp_path = so_path + ".srchash"
    want = source_hash(src, provenance)

    def stale() -> bool:
        if not os.path.exists(so_path):
            return True
        try:
            with open(stamp_path) as f:
                return f.read().strip() != want
        except OSError:
            return True

    if not stale():
        return True, ""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    import fcntl

    with open(so_path + ".lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if not stale():  # a racing process built while we waited
            return True, ""
        tmp = so_path + f".tmp.{os.getpid()}"
        r = subprocess.run(cmd_for(tmp), capture_output=True, text=True,
                           timeout=timeout)
        log = r.stdout + r.stderr
        if r.returncode != 0 or not os.path.exists(tmp):
            return False, log or f"rc={r.returncode}"
        os.replace(tmp, so_path)
        stamp_tmp = stamp_path + f".tmp.{os.getpid()}"
        with open(stamp_tmp, "w") as f:
            f.write(want)
        os.replace(stamp_tmp, stamp_path)
    return True, log


def load_native(src_basename: str, so_basename: str) -> Optional[ctypes.CDLL]:
    """Compile-on-demand ctypes loader for ``native/<src_basename>``.
    Returns None when the source or the toolchain is unavailable (the
    callers keep the reference's pure-Python fallbacks)."""
    src = os.path.join(_SRC_DIR, src_basename)
    so_path = os.path.join(_BUILD_DIR, so_basename)
    if not os.path.exists(src):
        return None
    try:
        ok, _ = build_cached(
            src, so_path,
            lambda tmp: ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                         "-std=c++17", src, "-o", tmp],
            _build_provenance(), timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    if not ok:
        return None
    try:
        return ctypes.CDLL(so_path)
    except OSError:
        return None


def _load_once(name: str, src: str, so: str, declare):
    with _lock:
        if name not in _libs:
            lib = load_native(src, so)
            if lib is not None:
                declare(lib)
            _libs[name] = lib
        return _libs[name]


def _declare_slotmap(lib) -> None:
    c = ctypes
    i64, i32, u8, vp = c.c_int64, c.c_int32, c.c_uint8, c.c_void_p
    P = c.POINTER
    lib.sm_create.restype = vp
    lib.sm_create.argtypes = [i64, i64]
    lib.sm_destroy.restype = None
    lib.sm_destroy.argtypes = [vp]
    lib.sm_capacity.restype = i64
    lib.sm_capacity.argtypes = [vp]
    lib.sm_used.restype = i64
    lib.sm_used.argtypes = [vp]
    lib.sm_slot_keys.restype = P(i64)
    lib.sm_slot_keys.argtypes = [vp]
    lib.sm_slot_namespaces.restype = P(i64)
    lib.sm_slot_namespaces.argtypes = [vp]
    lib.sm_slot_used.restype = P(u8)
    lib.sm_slot_used.argtypes = [vp]
    lib.sm_lookup_or_insert.restype = i32
    lib.sm_lookup_or_insert.argtypes = [vp, i64, P(i64), P(i64), P(i32),
                                        P(u8)]
    lib.sm_erase.restype = i64
    lib.sm_erase.argtypes = [vp, i64, P(i64), P(i64), P(i32)]
    lib.sm_lookup.restype = None
    lib.sm_lookup.argtypes = [vp, i64, P(i64), P(i64), P(i32)]


def _declare_datagen(lib) -> None:
    c = ctypes
    i64 = c.c_int64
    P = c.POINTER
    lib.ngen_bids.restype = None
    lib.ngen_bids.argtypes = [i64, i64, i64, i64, i64, i64, i64, i64,
                              P(i64), P(i64), P(c.c_float), P(i64)]


def load_slotmap() -> Optional[ctypes.CDLL]:
    """The native key->slot index (native/slotmap.cpp), or None."""
    return _load_once("slotmap", "slotmap.cpp", "_slotmap.so",
                      _declare_slotmap)


def load_datagen() -> Optional[ctypes.CDLL]:
    """The native bid generator (native/datagen.cpp), or None."""
    return _load_once("datagen", "datagen.cpp", "_datagen.so",
                      _declare_datagen)
