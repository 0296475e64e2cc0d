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
    lib.sm_verify.restype = None
    lib.sm_verify.argtypes = [vp, i64, P(i64), P(i64), P(i32), P(i32)]
    lib.sm_group_rows.restype = i64
    lib.sm_group_rows.argtypes = [P(i64), i64, P(i64), P(i32)]
    lib.sm_pane_ingest.restype = i32
    lib.sm_pane_ingest.argtypes = [vp, i64, P(i64), P(i64), i64, i64, i64,
                                   P(i32), P(u8), P(i32), P(i64), P(i64),
                                   P(i64)]
    lib.sm_flat_fuse.restype = None
    lib.sm_flat_fuse.argtypes = [i64, P(i32), P(i32), P(i64), i64, P(i32)]


def _declare_datagen(lib) -> None:
    c = ctypes
    i64 = c.c_int64
    P = c.POINTER
    lib.ngen_bids.restype = None
    lib.ngen_bids.argtypes = [i64, i64, i64, i64, i64, i64, i64, i64,
                              P(i64), P(i64), P(c.c_float), P(i64)]


def _declare_sessions(lib) -> None:
    c = ctypes
    i64, i32, u8, vp = c.c_int64, c.c_int32, c.c_uint8, c.c_void_p
    P = c.POINTER
    lib.sx_create.restype = vp
    lib.sx_create.argtypes = [i64, i64]
    lib.sx_destroy.restype = None
    lib.sx_destroy.argtypes = [vp]
    lib.sx_capacity.restype = i64
    lib.sx_capacity.argtypes = [vp]
    lib.sx_used.restype = i64
    lib.sx_used.argtypes = [vp]
    for name in ("sx_keys", "sx_starts", "sx_ends", "sx_sids"):
        getattr(lib, name).restype = P(i64)
        getattr(lib, name).argtypes = [vp]
    lib.sx_dslots.restype = P(i32)
    lib.sx_dslots.argtypes = [vp]
    lib.sx_used_mask.restype = P(u8)
    lib.sx_used_mask.argtypes = [vp]
    lib.sx_lookup.restype = None
    lib.sx_lookup.argtypes = [vp, i64, P(i64), P(i32)]
    lib.sx_insert.restype = i32
    lib.sx_insert.argtypes = [vp, i64, P(i64), P(i32)]
    lib.sx_erase_rows.restype = None
    lib.sx_erase_rows.argtypes = [vp, i64, P(i32)]
    lib.sx_lookup1.restype = i32
    lib.sx_lookup1.argtypes = [vp, i64]
    lib.sx_insert1.restype = i32
    lib.sx_insert1.argtypes = [vp, i64]
    lib.sx_erase1.restype = None
    lib.sx_erase1.argtypes = [vp, i32]
    lib.sx_multi_add.restype = None
    lib.sx_multi_add.argtypes = [vp, i64]
    lib.sx_multi_remove.restype = None
    lib.sx_multi_remove.argtypes = [vp, i64]
    lib.sx_multi_count.restype = i64
    lib.sx_multi_count.argtypes = [vp]
    lib.sx_absorb.restype = i64
    lib.sx_absorb.argtypes = [vp, i64, P(i64), P(i64),  # n, keys, ts
                              i64, i64, i64, i64,  # gap, late, mfw, sid
                              P(i64), P(i64),      # order, rec_to_sess
                              P(i64), P(i64), P(i64), P(i64),  # k/s/e/sid
                              P(i32), P(i32), P(u8),  # slot/row/flags
                              P(i64)]              # out n_fast
    lib.sx_fold.restype = None
    lib.sx_fold.argtypes = [vp, i64, P(i64), P(i64), P(i32)]
    lib.sx_fold_rows.restype = None
    lib.sx_fold_rows.argtypes = [vp, i64, P(i32), P(i64), P(i32)]
    lib.sx_push_chunk.restype = None
    lib.sx_push_chunk.argtypes = [vp, i64, P(i64), P(i64), P(i64)]
    lib.sx_min_pending.restype = i64
    lib.sx_min_pending.argtypes = [vp]
    lib.sx_pop.restype = i64
    lib.sx_pop.argtypes = [vp, i64, P(i64)]
    lib.sx_pop_fetch.restype = None
    lib.sx_pop_fetch.argtypes = [vp, P(i64), P(i64), P(i64), P(i64), P(i32)]
    lib.sx_pop_fetch_rest.restype = None
    lib.sx_pop_fetch_rest.argtypes = [vp, P(i64), P(i64), P(i64)]
    # the mesh session engine's sweeps (the mesh session engine): declared
    # with the rest of the library, called by nothing yet
    lib.sx_shard_group.restype = i64
    lib.sx_shard_group.argtypes = [i64, P(i64), P(i64), P(u8), P(i32),
                                   P(i32), i64, i64, i64, i64,
                                   P(i64), P(i64), P(i64),
                                   P(i64), P(i64), P(u8), P(i32), P(i32)]
    lib.sx_route.restype = None
    lib.sx_route.argtypes = [i64, i64, P(i64), P(i64), i64, P(i64),
                             P(i32), P(i64), P(i32), P(i64)]
    lib.sx_rec_shard_max.restype = i64
    lib.sx_rec_shard_max.argtypes = [i64, P(i64), i64, i64, i64, i64]


def load_slotmap() -> Optional[ctypes.CDLL]:
    """The native key->slot index (native/slotmap.cpp), or None."""
    return _load_once("slotmap", "slotmap.cpp", "_slotmap.so",
                      _declare_slotmap)


def load_sessions() -> Optional[ctypes.CDLL]:
    """The native session-metadata plane (native/sessions.cpp), or None:
    sessionize, absorb and fire-candidate upkeep in one C sweep per batch
    (``windowing/session_native.py``)."""
    return _load_once("sessions", "sessions.cpp", "_sessions.so",
                      _declare_sessions)


def native_disabled() -> bool:
    """The reference's blanket opt-outs (``FLINK_TPU_NO_NATIVE=1`` or
    ``FLINK_TPU_NATIVE=0``); the hot-row cache's selection reads them
    (``tenancy/hot_cache.py``)."""
    return (os.environ.get("FLINK_TPU_NO_NATIVE") == "1"
            or os.environ.get("FLINK_TPU_NATIVE") == "0")


#: hc_stat counter indices (must match the Stat enum in hotcache.cpp)
HC_STAT_HITS = 0
HC_STAT_MISSES = 1
HC_STAT_EVICTIONS = 2
HC_STAT_PRIMES = 3
HC_STAT_PUTS = 4
HC_STAT_TORN_RETRIES = 5
HC_STAT_TORN_MISSES = 6
HC_STAT_OVERSIZE_DROPS = 7

#: per-frontend counter indices (must match the FeStat enum in
#: hotcache.cpp) — accumulated IN the shared arena header by attached
#: frontend processes (hc_fe_note), read owner-side without IPC
HC_FE_STAT_PROBES = 0
HC_FE_STAT_HITS = 1
HC_FE_STAT_TORN_RETRIES = 2
HC_FE_STAT_MISS_CROSSINGS = 3
HC_FE_STAT_NAMES = ("probes", "hits", "torn_retries", "miss_crossings")
#: fe_stats rows reserved in the arena header (kMaxFrontends)
HC_MAX_FRONTENDS = 64


def _declare_hotcache(lib) -> None:
    c = ctypes
    i64, i32, u8, u64, vp = (c.c_int64, c.c_int32, c.c_uint8,
                             c.c_uint64, c.c_void_p)
    P = c.POINTER
    lib.hc_create.restype = vp
    lib.hc_create.argtypes = [i64, i64, i64]
    # shared-memory arena family (r21): the owner creates the table
    # as a MAP_SHARED file arena; frontend processes attach the SAME
    # table and probe it lock-free (seqlock readers are address-free)
    lib.hc_create_shared.restype = vp
    lib.hc_create_shared.argtypes = [c.c_char_p, i64, i64, i64]
    lib.hc_attach.restype = vp
    lib.hc_attach.argtypes = [c.c_char_p]
    lib.hc_epoch.restype = i64
    lib.hc_epoch.argtypes = [vp]
    lib.hc_arena_bytes.restype = i64
    lib.hc_arena_bytes.argtypes = [vp]
    lib.hc_is_attached.restype = i64
    lib.hc_is_attached.argtypes = [vp]
    lib.hc_fe_note.restype = None
    lib.hc_fe_note.argtypes = [vp, i32, i64, i64, i64, i64]
    lib.hc_fe_stat.restype = i64
    lib.hc_fe_stat.argtypes = [vp, i32, i32]
    lib.hc_destroy.restype = None
    lib.hc_destroy.argtypes = [vp]
    lib.hc_len.restype = i64
    lib.hc_len.argtypes = [vp]
    lib.hc_capacity.restype = i64
    lib.hc_capacity.argtypes = [vp]
    lib.hc_stat.restype = i64
    lib.hc_stat.argtypes = [vp, i32]
    lib.hc_add_stat.restype = None
    lib.hc_add_stat.argtypes = [vp, i32, i64]
    lib.hc_clear.restype = None
    lib.hc_clear.argtypes = [vp]
    lib.hc_get_batch.restype = i64
    lib.hc_get_batch.argtypes = [vp, i64, P(i64), i64, P(u8),
                                 P(i32), P(i64), P(i64), P(i64),
                                 P(u64)]
    # the frontend variant: same probe + per-frontend attribution
    # folded in the same GIL-released call
    lib.hc_get_batch_fe.restype = i64
    lib.hc_get_batch_fe.argtypes = [vp, i32, i64, P(i64), i64,
                                    P(u8), P(i32), P(i64), P(i64),
                                    P(i64), P(u64)]
    lib.hc_put_batch.restype = i64
    lib.hc_put_batch.argtypes = [vp, i64, P(i64), P(i64), P(i64),
                                 P(i64), P(i64), P(u64)]
    lib.hc_prime_batch.restype = i64
    lib.hc_prime_batch.argtypes = [vp, i64, P(i64), i64, P(i64),
                                   P(i64), P(i64), P(u64), P(i64),
                                   P(i64), P(u8)]
    lib.hc_drop.restype = None
    lib.hc_drop.argtypes = [vp, i64]
    lib.hc_migrate.restype = i64
    lib.hc_migrate.argtypes = [vp, vp]
    # test-only: freeze/unfreeze a slot's seqlock stamp so the
    # torn-read retry path is deterministically coverable
    lib.hc_debug_lock_slot.restype = i64
    lib.hc_debug_lock_slot.argtypes = [vp, i64]
    lib.hc_debug_unlock_slot.restype = i64
    lib.hc_debug_unlock_slot.argtypes = [vp, i64]


def load_hotcache() -> Optional[ctypes.CDLL]:
    """The native hot-row probe table (native/hotcache.cpp), or None: one
    GIL-released C call probes or primes a whole key batch against an
    open-addressing, seqlock-stamped table of packed composed results
    (``tenancy/hot_cache_native.py``; ``tenancy/hot_cache.py`` is the
    bit-identical Python plane)."""
    return _load_once("hotcache", "hotcache.cpp", "_hotcache.so",
                      _declare_hotcache)


def hotcache_available() -> bool:
    return load_hotcache() is not None


#: degradations from a wanted native plane to its Python counterpart
#: (a build or load failure): 0 on a healthy host
_fallbacks = 0
_fallback_reasons: set = set()


def note_fallback(reason: str) -> None:
    """Record one native -> Python degradation LOUDLY: a warning per
    distinct reason and a bump of :func:`native_fallbacks` (a silent
    fallback would hide a host-path slowdown behind a green suite)."""
    global _fallbacks
    _fallbacks += 1
    if reason not in _fallback_reasons:
        _fallback_reasons.add(reason)
        import warnings

        warnings.warn(f"flink_tpu_torch native plane degraded to its "
                      f"Python fallback: {reason}", RuntimeWarning,
                      stacklevel=3)


def native_fallbacks() -> int:
    """Native -> Python degradations in this process."""
    return _fallbacks


def load_datagen() -> Optional[ctypes.CDLL]:
    """The native bid generator (native/datagen.cpp), or None."""
    return _load_once("datagen", "datagen.cpp", "_datagen.so",
                      _declare_datagen)


def group_matrix(keys, slots, sidx, n_slices: int):
    """(distinct keys in first-seen order, ``[K, n_slices]`` int32 slot
    matrix) by the native hash grouping (``sm_group_rows``): row r holds
    key r's slot in each slice, 0 (the identity slot) where it has none.
    A fire's row order is this order, and top-k ties are broken by row,
    so the fire needs it exactly: raises when the library is missing."""
    import numpy as np

    lib = load_slotmap()
    if lib is None:
        raise RuntimeError("the native slotmap library (native/slotmap.cpp) "
                           "did not build; the window fire's key grouping "
                           "needs it")
    n = len(keys)
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    out_keys = np.empty(n, dtype=np.int64)
    row_of = np.empty(n, dtype=np.int32)
    c = ctypes
    rows = lib.sm_group_rows(
        keys.ctypes.data_as(c.POINTER(c.c_int64)), n,
        out_keys.ctypes.data_as(c.POINTER(c.c_int64)),
        row_of.ctypes.data_as(c.POINTER(c.c_int32)))
    matrix = np.zeros((rows, n_slices), dtype=np.int32)
    matrix[row_of, np.asarray(sidx)] = slots
    return out_keys[:rows], matrix
