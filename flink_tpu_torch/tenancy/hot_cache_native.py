"""Native hot-row probe table: the GIL-free serving cache wrapper (port of
``flink_tpu/tenancy/hot_cache_native.py``, the whole module; host code
over ``native/hotcache.cpp``, built by the port's own loader into
``flink_tpu_torch/native/build/``).

The ctypes face of ``native/hotcache.cpp`` with the exact interface of
:class:`flink_tpu_torch.tenancy.hot_cache.HotRowCache` (its bit-identical
Python fallback — selected by ``make_hot_row_cache`` the way
``make_session_meta`` picks the session-metadata plane). The cost model
it changes: a batched probe is ONE C call that releases the GIL — an
open-addressing probe plus a memcpy per hit — instead of N locked
Python dict accesses, so concurrent serving clients stop serializing
on the interpreter lock at cache-hit QPS, and the publish harvest
primes a whole boundary delta in ONE call instead of N ``put()``\\ s.

Layout: one native table per (job, operator). Entries hold PACKED
composed results — per namespace, the operator's finished value
columns as raw int64 bit patterns with a per-entry dtype tag bitmask,
so ``int64`` and ``float64`` round-trip EXACTLY. Results whose shape
cannot pack (join row lists, object columns, oversize compositions)
ride a Python :class:`HotRowCache` overflow store with identical
semantics; the batched probe falls through to it only for keys the
native table missed, and only when the (job, operator) ever routed a
value there.

Seqlock discipline (the C side): writers flip an entry's stamp odd,
write, flip it even; readers re-check the stamp around the copy and a
torn read RETRIES then falls to the miss path — a probe can never
return a mixed-generation row, and readers never block behind the
publish writer.

Tables start small and GROW (a fresh, larger table swapped in; the old
one parks in a graveyard so in-flight readers stay safe) when the live
count presses the capacity — growth loses the cached entries, which
re-prime within a publish interval.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.native import (
    HC_FE_STAT_NAMES,
    HC_MAX_FRONTENDS,
    HC_STAT_EVICTIONS,
    HC_STAT_HITS,
    HC_STAT_MISSES,
    HC_STAT_OVERSIZE_DROPS,
    HC_STAT_PRIMES,
    HC_STAT_PUTS,
    HC_STAT_TORN_MISSES,
    HC_STAT_TORN_RETRIES,
    load_hotcache,
)
from flink_tpu_torch.tenancy.hot_cache import HotRowCache, PrimeDelta

#: the owner's table registry inside ``shm_dir`` — frontends read it to
#: know which arena file serves which (job, operator), with the epoch
#: each arena was created under (owner-restart detector)
MANIFEST_NAME = "hotcache_manifest.json"

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)

#: namespaces a packed entry can hold; compositions wider than this
#: stay uncached (plain misses) or ride the Python overflow store
ENTRY_CAP = 8
#: first allocation per (job, operator) table; grows x4 toward the
#: cache bound under live-count pressure
MIN_TABLE_ENTRIES = 1 << 12

_EMPTY_I64 = np.zeros(0, dtype=np.int64)
_EMPTY_U64 = np.zeros(0, dtype=np.uint64)


def _ptr_i64(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


class PackedProbe:
    """One batched probe's raw result: the packed entry buffers as the
    C call filled them — NO per-key Python materialization happened.
    ``hit[i]``/``counts[i]`` describe key i; hit entries sit compactly
    in ``ns``/``tags`` (and ``counts[i] * n_cols`` words in ``vals``).
    ``materialize(i)`` builds one key's composed dict on demand; the
    serving fast path hands these buffers to the client wrapper and
    dicts are only ever built for keys somebody actually reads —
    a frontend that serializes straight from the packed form never
    pays the interpreter for the hits at all."""

    __slots__ = ("hit", "counts", "ns", "vals", "tags", "cols",
                 "_offs")

    def __init__(self, hit, counts, ns, vals, tags,
                 cols: Tuple[str, ...]) -> None:
        self.hit = hit
        self.counts = counts
        self.ns = ns
        self.vals = vals
        self.tags = tags
        self.cols = cols
        self._offs = None

    def materialize(self, i: int):
        """Key i's composed result dict (None when counts say miss —
        callers consult ``hit`` first; a hit with 0 entries is ``{}``)."""
        if self._offs is None:
            self._offs = np.concatenate(
                ([0], np.cumsum(self.counts, dtype=np.int64)))
        lo = int(self._offs[i])
        hi = int(self._offs[i + 1])
        ncol = len(self.cols)
        res: Dict[int, dict] = {}
        fv = self.vals.view(np.float64)
        for e in range(lo, hi):
            tag = int(self.tags[e])
            base = e * ncol
            res[int(self.ns[e])] = {
                nm: (float(fv[base + ci]) if (tag >> ci) & 1
                     else int(self.vals[base + ci]))
                for ci, nm in enumerate(self.cols)}
        return res


class _Scratch:
    """Per-thread probe buffers with PREBUILT ctypes pointers — each
    ``.ctypes.data_as()`` conversion costs ~3 µs (it builds a fresh
    ctypeslib interface object), which at 10 pointers per probe dwarfed
    the ~5 µs C call itself. The scratch is reused across calls on one
    thread; the compact results are COPIED out (they are small — the
    hit entries only) so a lazily-consumed :class:`PackedProbe` never
    aliases buffers a later probe overwrites."""

    __slots__ = ("n", "ncol", "keys", "hit", "cnt", "ogen", "ons",
                 "ovals", "otags", "p_keys", "p_hit", "p_cnt",
                 "p_ogen", "p_ons", "p_ovals", "p_otags")

    def __init__(self) -> None:
        self.n = 0
        self.ncol = 0

    def ensure(self, n: int, ncol: int) -> None:
        if n <= self.n and ncol == self.ncol:
            return
        n = max(n, self.n, 256)
        self.n = n
        self.ncol = ncol
        self.keys = np.empty(n, dtype=np.int64)
        self.hit = np.empty(n, dtype=np.uint8)
        self.cnt = np.empty(n, dtype=np.int32)
        self.ogen = np.empty(n, dtype=np.int64)
        self.ons = np.empty(n * ENTRY_CAP, dtype=np.int64)
        self.ovals = np.empty(n * ENTRY_CAP * ncol, dtype=np.int64)
        self.otags = np.empty(n * ENTRY_CAP, dtype=np.uint64)
        self.p_keys = _ptr_i64(self.keys)
        self.p_hit = self.hit.ctypes.data_as(_u8p)
        self.p_cnt = self.cnt.ctypes.data_as(_i32p)
        self.p_ogen = _ptr_i64(self.ogen)
        self.p_ons = _ptr_i64(self.ons)
        self.p_ovals = _ptr_i64(self.ovals)
        self.p_otags = self.otags.ctypes.data_as(_u64p)


class _Table:
    """One (job, operator) native table + its packing schema. With a
    ``shm_path`` the arena is a MAP_SHARED file frontends hc_attach;
    without, it is the private heap arena (the single-process path,
    byte-for-byte today's behavior)."""

    __slots__ = ("ptr", "cols", "n_cols", "entries", "graveyard",
                 "shm_path", "epoch")

    def __init__(self, lib, cols: Tuple[str, ...], entries: int,
                 shm_path: Optional[str] = None) -> None:
        self.cols = cols
        self.n_cols = len(cols)
        self.entries = int(entries)
        self.shm_path = shm_path
        if shm_path is None:
            self.ptr = lib.hc_create(self.entries, self.n_cols,
                                     ENTRY_CAP)
        else:
            self.ptr = lib.hc_create_shared(
                shm_path.encode(), self.entries, self.n_cols,
                ENTRY_CAP)
        if not self.ptr:
            raise MemoryError("hc_create failed")
        self.epoch = int(lib.hc_epoch(self.ptr))
        #: old table pointers kept alive across growth swaps: a reader
        #: that grabbed the previous pointer must stay safe (freed on
        #: cache close)
        self.graveyard: List[int] = []


class NativeHotRowCache:
    """Drop-in :class:`HotRowCache` with the native probe table under
    it. See the module doc for the packing/overflow split."""

    def __init__(self, max_entries: int = 1 << 18,
                 shm_dir: Optional[str] = None) -> None:
        self._lib = load_hotcache()
        if self._lib is None:
            raise RuntimeError("native hotcache library unavailable")
        self.max_entries = int(max_entries)
        #: shared-memory mode: every table is a MAP_SHARED file arena
        #: under this directory (ideally /dev/shm-backed) plus a JSON
        #: manifest frontends poll to attach — None keeps the private
        #: heap arenas (zero frontends = exactly the one-process path)
        self.shm_dir = shm_dir
        self._shm_seq = 0
        if shm_dir is not None:
            os.makedirs(shm_dir, exist_ok=True)
        #: (job, operator) -> _Table (created on first packable value)
        self._tables: Dict[tuple, _Table] = {}
        #: (job, operator) whose values fundamentally cannot pack
        #: (non-dict results, object columns) — Python store only
        self._py_only: set = set()
        #: (job, operator) that ever routed a value to the overflow
        #: store (the probe falls through to it only for these)
        self._py_ops: set = set()
        #: overflow store: identical semantics, shared LRU bound
        self._py = HotRowCache(max_entries=max_entries)
        #: guards structural mutation AND every native WRITE path
        #: (prime/put/drop/clear): a writer that read a table pointer
        #: just before a growth migrate+swap would otherwise land its
        #: write in the retired graveyard table — a whole publish
        #: prime silently lost, and with presence-implies-validity
        #: probes that is stale-serving forever. Probes never take it
        #: (a probe against the just-retired pointer reads migrated,
        #: still-alive data — bounded to one race window). RLock:
        #: _maybe_grow runs inside locked writer sections.
        # function-level import: keep the frontend child's spawn
        # closure (FrontendCacheClient only) free of the observe plane
        from flink_tpu_torch.observe.lock_sentinel import named_lock
        self._lock = named_lock("tenancy.native_cache", reentrant=True)
        self._closed = False
        #: per-thread probe scratch, one per column count (a thread
        #: alternating operators with different n_cols must not
        #: realloc + rebuild pointers every probe)
        self._tls = threading.local()

    def _scratch(self, n: int, ncol: int) -> _Scratch:
        pool = getattr(self._tls, "sc", None)
        if pool is None:
            pool = self._tls.sc = {}
        sc = pool.get(ncol)
        if sc is None:
            sc = pool[ncol] = _Scratch()
        sc.ensure(n, ncol)
        return sc

    def _probe_raw(self, tbl: _Table, key_ids, gen: int,
                   exact: bool) -> Tuple[int, "_Scratch", int]:
        """(hits, scratch, n): ONE GIL-released C call through the
        thread's prebuilt-pointer scratch."""
        keys = np.asarray(key_ids, dtype=np.int64)
        n = len(keys)
        sc = self._scratch(n, tbl.n_cols)
        np.copyto(sc.keys[:n], keys)
        hits = self._lib.hc_get_batch(
            tbl.ptr, n, sc.p_keys, int(gen) if exact else -1,
            sc.p_hit, sc.p_cnt, sc.p_ogen, sc.p_ons, sc.p_ovals,
            sc.p_otags)
        return hits, sc, n

    # ------------------------------------------------------------- tables

    def _next_shm_path(self) -> Optional[str]:
        """A FRESH arena filename per create (also per growth swap):
        re-using a path would mean truncating a file a live frontend
        has mapped — a fault, not a race. Old files unlink immediately
        after the swap; existing mappings keep their pages (POSIX), and
        frontends re-attach off the rewritten manifest."""
        if self.shm_dir is None:
            return None
        self._shm_seq += 1
        return os.path.join(self.shm_dir,
                            f"hc_{os.getpid()}_{self._shm_seq:05d}.arena")

    def _write_manifest(self) -> None:
        """Rewrite the frontend attach manifest (atomic rename). Called
        under ``self._lock`` after any structural change (new table,
        growth swap) so frontends always see a consistent registry:
        every listed path exists and its arena's epoch matches."""
        if self.shm_dir is None:
            return
        doc = {
            "version": 1,
            "seq": self._shm_seq,
            "tables": [
                {"job": j, "operator": op, "path": t.shm_path,
                 "cols": list(t.cols), "epoch": t.epoch,
                 "entries": t.entries}
                for (j, op), t in self._tables.items()
                if t.shm_path is not None],
        }
        path = os.path.join(self.shm_dir, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def _table_for(self, job: str, operator: str,
                   cols: Tuple[str, ...]) -> Optional[_Table]:
        key = (job, operator)
        tbl = self._tables.get(key)
        if tbl is not None:
            return tbl if tbl.cols == cols else None
        with self._lock:
            tbl = self._tables.get(key)
            if tbl is None:
                # shm tables allocate at the FULL cache bound up front:
                # growth would swap arena files under attached
                # frontends every x4 step — one fixed file per
                # (job, operator) keeps attachments stable for the
                # table's whole life (memory is the configured bound
                # either way; private tables keep the lazy ramp)
                entries = (self.max_entries if self.shm_dir is not None
                           else min(self.max_entries,
                                    MIN_TABLE_ENTRIES))
                tbl = _Table(self._lib, cols, entries,
                             shm_path=self._next_shm_path())
                self._tables[key] = tbl
                self._write_manifest()
            return tbl if tbl.cols == cols else None

    def _maybe_grow(self, tbl: _Table) -> None:
        """Grow a pressured table toward the cache bound (writer paths
        only). The swap is atomic at the Python attribute level; the
        outgoing pointer parks in the graveyard for reader safety."""
        if tbl.entries >= self.max_entries:
            return
        if self._lib.hc_len(tbl.ptr) * 2 < tbl.entries:
            return
        with self._lock:
            if self._lib.hc_len(tbl.ptr) * 2 < tbl.entries:
                return
            new_entries = min(tbl.entries * 4, self.max_entries)
            new_ptr = self._lib.hc_create(new_entries, tbl.n_cols,
                                          ENTRY_CAP)
            if not new_ptr:
                return
            # entries MIGRATE (one C sweep) and the retiring table's
            # counters fold forward, so growth loses nothing and stats
            # stay cumulative
            self._lib.hc_migrate(new_ptr, tbl.ptr)
            for which in range(8):
                self._lib.hc_add_stat(
                    new_ptr, which, self._lib.hc_stat(tbl.ptr, which))
            tbl.graveyard.append(tbl.ptr)
            tbl.ptr = new_ptr
            tbl.entries = new_entries

    def close(self) -> None:
        """Free the native tables (tests / explicit shutdown). Not safe
        concurrently with probes — callers quiesce first."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for tbl in self._tables.values():
                for p in tbl.graveyard:
                    self._lib.hc_destroy(p)
                self._lib.hc_destroy(tbl.ptr)
                if tbl.shm_path is not None:
                    try:
                        os.unlink(tbl.shm_path)
                    except OSError:
                        pass
            self._tables.clear()
            if self.shm_dir is not None:
                try:
                    os.unlink(os.path.join(self.shm_dir,
                                           MANIFEST_NAME))
                except OSError:
                    pass

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------- packing

    @staticmethod
    def _pack_value(value, cols: Optional[Tuple[str, ...]]):
        """(cols, ns_list, vals_i64, tags) for a packable composed
        result, or None. Packable = dict of int namespace -> dict of
        numeric scalars with one consistent column set; int64 and
        float64 pack as exact bit patterns."""
        if not isinstance(value, dict):
            return None
        if not value:
            return (cols, [], _EMPTY_I64, _EMPTY_U64) \
                if cols is not None else None
        ns_list: List[int] = []
        rows: List[list] = []
        tags: List[int] = []
        for ns, row in value.items():
            if not isinstance(row, dict):
                return None
            try:
                ns_list.append(int(ns))
            except (TypeError, ValueError):
                return None
            if cols is None:
                cols = tuple(row.keys())
            elif len(row) != len(cols):
                return None
            tag = 0
            packed = []
            for ci, name in enumerate(cols):
                try:
                    v = row[name]
                except KeyError:
                    return None
                if isinstance(v, (bool, int, np.integer)):
                    packed.append(int(v))
                elif isinstance(v, (float, np.floating)):
                    packed.append(
                        np.float64(v).view(np.int64).item())
                    tag |= 1 << ci
                else:
                    return None
            rows.append(packed)
            tags.append(tag)
        if len(ns_list) > ENTRY_CAP:
            return None  # oversize: rides the overflow store
        vals = np.asarray(rows, dtype=np.int64).ravel()
        return (cols, ns_list,
                np.ascontiguousarray(vals),
                np.asarray(tags, dtype=np.uint64))

    @staticmethod
    def _pack_cols(u_cols) -> Optional[Tuple[np.ndarray, int]]:
        """(vals_i64 [U, n_cols] raveled, tag bitmask) for the delta's
        value columns, or None when a column cannot pack (object
        dtype). One tag for every entry — columns are dtype-uniform."""
        mats = []
        tag = 0
        for ci, (_name, col) in enumerate(u_cols):
            col = np.asarray(col)
            if np.issubdtype(col.dtype, np.floating):
                mats.append(col.astype(np.float64).view(np.int64))
                tag |= 1 << ci
            elif (np.issubdtype(col.dtype, np.integer)
                  or col.dtype == bool):
                mats.append(col.astype(np.int64))
            else:
                return None
        return np.ascontiguousarray(
            np.stack(mats, axis=1).ravel() if mats else _EMPTY_I64), tag

    # -------------------------------------------------------------- probes

    def get_many(self, job: str, operator: str, key_ids, gen: int,
                 out: list, misses: list, exact: bool = True) -> int:
        """Batched probe: ONE GIL-released C call for the whole batch,
        falling through to the overflow store only for keys the native
        table missed (and only when the op ever routed values there).
        Interface and results identical to ``HotRowCache.get_many``."""
        opkey = (job, operator)
        # probes are deliberately lock-free
        # (see the _lock docstring): a pointer read racing a growth
        # swap probes the retired-but-alive table — bounded staleness,
        # never corruption, and the publish path holds the lock
        tbl = self._tables.get(opkey)
        if tbl is None:
            return self._py.get_many(job, operator, key_ids, gen, out,
                                     misses, exact=exact)
        hits, sc, n = self._probe_raw(tbl, key_ids, gen, exact)
        names = tbl.cols
        ncol = tbl.n_cols
        hit_l = sc.hit[:n].tolist()
        if hits:
            cnt_l = sc.cnt[:n].tolist()
            tot = int(sum(cnt_l))
            ns_l = sc.ons[:tot].tolist()
            tags_l = sc.otags[:tot].tolist()
            iv = sc.ovals[:tot * ncol]
            il = iv.tolist()
            fl = iv.view(np.float64).tolist()
            pos = 0
            vpos = 0
            if ncol == 1:  # the common agg shape: one output column
                nm0 = names[0]
                for i in range(n):
                    if not hit_l[i]:
                        misses.append((i, key_ids[i]))
                        continue
                    res: Dict[int, dict] = {}
                    for _e in range(cnt_l[i]):
                        res[ns_l[pos]] = {
                            nm0: fl[pos] if tags_l[pos] & 1
                            else il[pos]}
                        pos += 1
                    out[i] = res
                # _py_ops only ever grows; a
                # stale negative read skips one overflow probe that
                # could not have entries yet (lock-free probe path)
                return hits if opkey not in self._py_ops else \
                    self._py_fallthrough(job, operator, gen, out,
                                         misses, exact, tbl, hits)
            for i in range(n):
                if not hit_l[i]:
                    misses.append((i, key_ids[i]))
                    continue
                res = {}
                for _e in range(cnt_l[i]):
                    tag = tags_l[pos]
                    res[ns_l[pos]] = {
                        nm: (fl[vpos + ci] if (tag >> ci) & 1
                             else il[vpos + ci])
                        for ci, nm in enumerate(names)}
                    pos += 1
                    vpos += ncol
                out[i] = res
        else:
            for i in range(n):
                misses.append((i, key_ids[i]))
        # _py_ops only ever grows; stale
        # negative read is a skipped probe of a still-empty overflow
        if opkey in self._py_ops:
            return self._py_fallthrough(job, operator, gen, out,
                                        misses, exact, tbl, hits)
        return hits

    def _py_fallthrough(self, job: str, operator: str, gen: int,
                        out: list, misses: list, exact: bool, tbl,
                        hits: int) -> int:
        """Overflow fall-through: probe the Python store for the
        native misses; its counters absorb those keys' outcomes (the
        native table's miss count is rolled back so totals stay
        one-per-probe)."""
        if not misses:
            return hits
        still: list = []
        for i, kid in misses:
            h2, val = self._py.get(job, operator, int(kid), gen,
                                   exact=exact)
            if h2:
                out[i] = val
                hits += 1
            else:
                still.append((i, kid))
        self._lib.hc_add_stat(tbl.ptr, HC_STAT_MISSES, -len(misses))
        misses[:] = still
        return hits

    def get_many_packed(self, job: str, operator: str, key_ids,
                        gen: int, out: list, misses: list,
                        exact: bool = True):
        """The ZERO-COPY batched probe: one GIL-released C call, hits
        stay in the packed buffers (:class:`PackedProbe`) — no dict is
        built here. Overflow-store hits (rare: non-packable ops) land
        in ``out`` as materialized overrides. Returns ``(hits, probe)``
        — probe None when the op has no native table (caller takes the
        dict path)."""
        opkey = (job, operator)
        # lock-free probe path (see the _lock
        # docstring): racing a growth swap reads the retired-but-alive
        # table, bounded staleness only
        tbl = self._tables.get(opkey)
        if tbl is None:
            return 0, None
        hits, sc, n = self._probe_raw(tbl, key_ids, gen, exact)
        if hits < n:
            hit_l = sc.hit[:n].tolist()
            for i in range(n):
                if not hit_l[i]:
                    misses.append((i, key_ids[i]))
            # _py_ops only ever grows; stale
            # negative read skips a probe of a still-empty overflow
            if opkey in self._py_ops:
                hits = self._py_fallthrough(job, operator, gen, out,
                                            misses, exact, tbl, hits)
        # COPY the compact results out of the scratch: they are small
        # (hit entries only) and the probe object must stay valid past
        # this thread's next probe
        tot = int(sc.cnt[:n].sum())
        probe = PackedProbe(sc.hit[:n].copy(), sc.cnt[:n].copy(),
                            sc.ons[:tot].copy(),
                            sc.ovals[:tot * tbl.n_cols].copy(),
                            sc.otags[:tot].copy(), tbl.cols)
        return hits, probe

    def get(self, job: str, operator: str, key_id: int, gen: int,
            exact: bool = True) -> Tuple[bool, Any]:
        out: List[Any] = [None]
        misses: list = []
        hits = self.get_many(job, operator, [int(key_id)], gen, out,
                             misses, exact=exact)
        return (hits > 0), out[0]

    # -------------------------------------------------------------- writes

    def put(self, job: str, operator: str, key_id: int, gen: int,
            value: Any) -> None:
        self.put_many(job, operator, [key_id], gen, [value])

    def put_many(self, job: str, operator: str, key_ids, gen: int,
                 values) -> None:
        """Worker miss-resolution feed: pack every packable result into
        ONE C call (no-downgrade enforced per entry in the table);
        non-packable results route to the overflow store (and evict any
        stale native entry for the key, so exactly one store answers)."""
        with self._lock:  # writer: see _lock docstring (growth race)
            self._put_many_locked(job, operator, key_ids, gen, values)

    def _put_many_locked(self, job: str, operator: str, key_ids,
                         gen: int, values) -> None:
        opkey = (job, operator)
        py_only = opkey in self._py_only
        n_keys: List[int] = []
        n_off: List[int] = [0]
        n_ns: List[int] = []
        n_vals: List[np.ndarray] = []
        n_tags: List[np.ndarray] = []
        cols = None
        tbl = self._tables.get(opkey)
        if tbl is not None:
            cols = tbl.cols
        for kid, value in zip(key_ids, values):
            packed = None if py_only else self._pack_value(value, cols)
            if packed is None:
                self._py_ops.add(opkey)
                if not isinstance(value, dict):
                    self._py_only.add(opkey)
                    py_only = True
                self._py.put(job, operator, int(kid), gen, value)
                if tbl is not None:
                    self._lib.hc_drop(tbl.ptr, int(kid))
                continue
            cols, ns_list, vals, tags = packed
            if tbl is None:
                tbl = self._table_for(job, operator, cols)
                if tbl is None:  # schema clash: overflow route
                    self._py_ops.add(opkey)
                    self._py.put(job, operator, int(kid), gen, value)
                    continue
            n_keys.append(int(kid))
            n_off.append(n_off[-1] + len(ns_list))
            n_ns.extend(ns_list)
            n_vals.append(vals)
            n_tags.append(tags)
        if not n_keys:
            return
        keys_a = np.asarray(n_keys, dtype=np.int64)
        gens_a = np.full(len(n_keys), int(gen), dtype=np.int64)
        off_a = np.asarray(n_off, dtype=np.int64)
        ns_a = np.asarray(n_ns, dtype=np.int64) if n_ns else _EMPTY_I64
        vals_a = (np.concatenate(n_vals) if n_ns else _EMPTY_I64)
        tags_a = (np.concatenate(n_tags) if n_ns else _EMPTY_U64)
        self._lib.hc_put_batch(
            tbl.ptr, len(n_keys), _ptr_i64(keys_a), _ptr_i64(gens_a),
            _ptr_i64(off_a), _ptr_i64(ns_a), _ptr_i64(vals_a),
            tags_a.ctypes.data_as(_u64p))
        self._maybe_grow(tbl)
        if opkey in self._py_ops:
            # the key may have a stale overflow copy from before its
            # values became packable — exactly one store may answer
            for kid in n_keys:
                self._py.drop(job, operator, kid)

    def prime(self, job: str, operator: str, key_id: int, gen: int,
              updates: Optional[dict] = None, remove=(),
              insert_ok: bool = False) -> None:
        """Scalar prime (interface parity; the adapters feed
        :meth:`prime_batch`). Folds through the same packed path."""
        u_ns = []
        u_cols: List[Tuple[str, list]] = []
        if updates:
            cols = None
            for ns, row in updates.items():
                u_ns.append(int(ns))
                if cols is None:
                    cols = tuple(row.keys())
                    u_cols = [(nm, []) for nm in cols]
                for (nm, acc) in u_cols:
                    acc.append(row[nm])
        cols_np = [(nm, np.asarray(acc)) for nm, acc in u_cols]
        delta = PrimeDelta(
            keys=np.asarray([int(key_id)], dtype=np.int64),
            uoff=np.asarray([0, len(u_ns)], dtype=np.int64),
            u_ns=np.asarray(u_ns, dtype=np.int64),
            u_cols=cols_np,
            roff=np.asarray([0, len(tuple(remove))], dtype=np.int64),
            r_ns=np.asarray([int(r) for r in remove], dtype=np.int64),
            flags=np.asarray([1 if insert_ok else 0], dtype=np.uint8))
        self.prime_batch(job, operator, gen, delta)

    def prime_batch(self, job: str, operator: str, gen: int,
                    delta: PrimeDelta) -> None:
        """Publish-harvest feed: fold one boundary's flat delta in ONE
        GIL-released C call. Overflow-store entries for the same op get
        the identical fold (insert_ok stripped — inserts are the native
        table's job), so presence-implies-validity holds across both."""
        with self._lock:  # writer: see _lock docstring (growth race)
            self._prime_batch_locked(job, operator, gen, delta)

    def _prime_batch_locked(self, job: str, operator: str, gen: int,
                            delta: PrimeDelta) -> None:
        opkey = (job, operator)
        cols = tuple(nm for nm, _ in (delta.u_cols or []))
        packed = (None if opkey in self._py_only
                  else self._pack_cols(delta.u_cols or []))
        tbl = None
        if packed is not None:
            tbl = self._tables.get(opkey)
            if tbl is None and len(delta.u_ns):
                tbl = self._table_for(job, operator, cols)
            elif tbl is not None and len(delta.u_ns) \
                    and tbl.cols != cols:
                tbl = None  # schema clash
        if packed is None or (tbl is None and len(delta.u_ns)):
            # cannot pack: the overflow store takes the whole delta
            self._py_ops.add(opkey)
            self._py.prime_batch(job, operator, gen, delta)
            t = self._tables.get(opkey)
            if t is not None:
                for kid in delta.keys:
                    self._lib.hc_drop(t.ptr, int(kid))
            return
        if tbl is not None:
            vals_a, tag = packed
            keys_a = np.ascontiguousarray(
                np.asarray(delta.keys, dtype=np.int64))
            uoff_a = np.ascontiguousarray(
                np.asarray(delta.uoff, dtype=np.int64))
            u_ns_a = np.ascontiguousarray(
                np.asarray(delta.u_ns, dtype=np.int64))
            u_tags = np.full(len(u_ns_a), tag, dtype=np.uint64)
            roff_a = np.ascontiguousarray(
                np.asarray(delta.roff, dtype=np.int64))
            r_ns_a = np.ascontiguousarray(
                np.asarray(delta.r_ns, dtype=np.int64))
            flags_a = np.ascontiguousarray(
                np.asarray(delta.flags, dtype=np.uint8))
            self._lib.hc_prime_batch(
                tbl.ptr, len(keys_a), _ptr_i64(keys_a), int(gen),
                _ptr_i64(uoff_a), _ptr_i64(u_ns_a), _ptr_i64(vals_a),
                u_tags.ctypes.data_as(_u64p), _ptr_i64(roff_a),
                _ptr_i64(r_ns_a), flags_a.ctypes.data_as(_u8p))
            self._maybe_grow(tbl)
        if opkey in self._py_ops:
            strip = np.asarray(delta.flags, dtype=np.uint8) & 0xFE
            self._py.prime_batch(job, operator, gen, PrimeDelta(
                delta.keys, delta.uoff, delta.u_ns, delta.u_cols,
                delta.roff, delta.r_ns, strip))

    # ---------------------------------------------------------- lifecycle

    def drop(self, job: str, operator: str, key_id: int) -> None:
        with self._lock:  # writer: see _lock docstring (growth race)
            tbl = self._tables.get((job, operator))
            if tbl is not None:
                self._lib.hc_drop(tbl.ptr, int(key_id))
            py = (job, operator) in self._py_ops
        if py:
            self._py.drop(job, operator, key_id)

    def invalidate_op(self, job: str, operator: str) -> None:
        with self._lock:  # writer: see _lock docstring (growth race)
            tbl = self._tables.get((job, operator))
            if tbl is not None:
                self._lib.hc_clear(tbl.ptr)
        self._py.invalidate_op(job, operator)

    def invalidate_job(self, job: str) -> None:
        with self._lock:  # writer: see _lock docstring (growth race)
            for (j, _op), tbl in list(self._tables.items()):
                if j == job:
                    self._lib.hc_clear(tbl.ptr)
        self._py.invalidate_job(job)

    # ------------------------------------------------------------- metrics

    def _tables_snapshot(self) -> List["_Table"]:
        """Consistent list of live tables for metric scans: ``_tables``
        mutates under ``_lock`` (bind/grow), so an unlocked iteration
        can see the dict resize mid-walk. Counters stay monotonic
        either side of a swap — only the LIST copy needs the lock."""
        with self._lock:
            return list(self._tables.values())

    def _sum_stat(self, which: int) -> int:
        return sum(int(self._lib.hc_stat(t.ptr, which))
                   for t in self._tables_snapshot())

    @property
    def hits(self) -> int:
        return self._sum_stat(HC_STAT_HITS) + self._py.hits

    @property
    def misses(self) -> int:
        return self._sum_stat(HC_STAT_MISSES) + self._py.misses

    @property
    def evictions(self) -> int:
        return self._sum_stat(HC_STAT_EVICTIONS) + self._py.evictions

    @property
    def primes(self) -> int:
        return self._sum_stat(HC_STAT_PRIMES) + self._py.primes

    @property
    def torn_retries(self) -> int:
        return self._sum_stat(HC_STAT_TORN_RETRIES)

    @property
    def torn_misses(self) -> int:
        return self._sum_stat(HC_STAT_TORN_MISSES)

    def __len__(self) -> int:
        return (sum(int(self._lib.hc_len(t.ptr))
                    for t in self._tables_snapshot()) + len(self._py))

    def hit_rate(self) -> float:
        h, m = self.hits, self.misses
        total = h + m
        return h / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        h, m = self.hits, self.misses
        total = h + m
        return {
            "hot_row_hits": float(h),
            "hot_row_misses": float(m),
            "hot_row_evictions": float(self.evictions),
            "hot_row_entries": float(len(self)),
            "hot_row_hit_rate": (h / total) if total else 0.0,
            "hot_row_native_tables": float(len(self._tables_snapshot())),
            "hot_row_torn_retries": float(self.torn_retries),
            "hot_row_torn_misses": float(self.torn_misses),
            "hot_row_oversize_drops": float(
                self._sum_stat(HC_STAT_OVERSIZE_DROPS)),
            "hot_row_native_puts": float(self._sum_stat(HC_STAT_PUTS)),
        }

    def fe_stats(self, n_frontends: int = HC_MAX_FRONTENDS
                 ) -> List[Dict[str, int]]:
        """Per-frontend counters read OWNER-SIDE off the shared arena
        headers (no IPC — the frontends accumulated them there via
        ``hc_fe_note`` / ``hc_get_batch_fe``), summed across this
        cache's tables: one dict per frontend slot with the
        ``HC_FE_STAT_NAMES`` keys. All-zero rows for unused slots."""
        rows = [dict.fromkeys(HC_FE_STAT_NAMES, 0)
                for _ in range(int(n_frontends))]
        for tbl in self._tables_snapshot():
            for fe in range(len(rows)):
                for which, name in enumerate(HC_FE_STAT_NAMES):
                    v = int(self._lib.hc_fe_stat(tbl.ptr, fe, which))
                    if v > 0:
                        rows[fe][name] += v
        return rows


class FrontendCacheClient:
    """The FRONTEND-process face of the shared hot cache: attach every
    arena the owner's manifest lists and probe them lock-free (the
    seqlock read protocol is address-free — an attached mapper is
    exactly as safe as an in-process reader thread). The hit path is
    shm-probe → :class:`PackedProbe`; nothing here ever takes a lock,
    touches the owner process, or imports the serving plane.

    Owner-restart discipline: each attachment remembers the epoch the
    manifest promised; ``refresh()`` re-reads the manifest when its
    ``seq`` moved or a probe-time ``hc_epoch`` check disagrees, then
    re-attaches the changed tables. A table the manifest no longer
    lists detaches (its unlinked file's pages stay valid while mapped,
    so in-flight probes on the OLD attachment were never at risk)."""

    def __init__(self, shm_dir: str, frontend_id: int = 0) -> None:
        self._lib = load_hotcache()
        if self._lib is None:
            raise RuntimeError("native hotcache library unavailable")
        if not (0 <= int(frontend_id) < HC_MAX_FRONTENDS):
            raise ValueError(
                f"frontend_id must be in [0, {HC_MAX_FRONTENDS})")
        self.shm_dir = shm_dir
        self.frontend_id = int(frontend_id)
        self._manifest_path = os.path.join(shm_dir, MANIFEST_NAME)
        self._manifest_seq = -1
        self._manifest_mtime = -1
        #: (job, operator) -> (ptr, cols, epoch, path)
        self._attached: Dict[tuple, tuple] = {}
        self._tls = threading.local()
        self.refresh()

    # ---------------------------------------------------------- attach

    def refresh(self) -> bool:
        """Re-read the manifest and (re-)attach changed tables.
        Returns True when the attachment set changed. Missing manifest
        (owner not up yet / shut down) detaches everything."""
        try:
            with open(self._manifest_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            changed = bool(self._attached)
            self._detach_all()
            self._manifest_seq = -1
            self._manifest_mtime = -1
            return changed
        try:
            self._manifest_mtime = os.stat(
                self._manifest_path).st_mtime_ns
        except OSError:
            self._manifest_mtime = -1
        changed = False
        want = {}
        for row in doc.get("tables", ()):
            want[(row["job"], row["operator"])] = row
        for key in list(self._attached):
            if key not in want:
                self._detach(key)
                changed = True
        for key, row in want.items():
            cur = self._attached.get(key)
            if cur is not None and cur[2] == row["epoch"]:
                continue  # same owner session: attachment still valid
            if cur is not None:
                self._detach(key)
            ptr = self._lib.hc_attach(row["path"].encode())
            if ptr and int(self._lib.hc_epoch(ptr)) == row["epoch"]:
                self._attached[key] = (ptr, tuple(row["cols"]),
                                       int(row["epoch"]), row["path"])
                changed = True
            elif ptr:
                # arena newer than the manifest copy we read — a
                # re-read next refresh picks the matching pair up
                self._lib.hc_destroy(ptr)
        self._manifest_seq = int(doc.get("seq", 0))
        return changed

    def _detach(self, key) -> None:
        ptr, _cols, _epoch, _path = self._attached.pop(key)
        self._lib.hc_destroy(ptr)  # attached mode: munmap only

    def _detach_all(self) -> None:
        for key in list(self._attached):
            self._detach(key)

    def close(self) -> None:
        self._detach_all()

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self._detach_all()
        except Exception:
            pass

    def tables(self) -> List[tuple]:
        return sorted(self._attached)

    # ----------------------------------------------------------- probes

    def _scratch(self, n: int, ncol: int) -> _Scratch:
        pool = getattr(self._tls, "sc", None)
        if pool is None:
            pool = self._tls.sc = {}
        sc = pool.get(ncol)
        if sc is None:
            sc = pool[ncol] = _Scratch()
        sc.ensure(n, ncol)
        return sc

    def probe(self, job: str, operator: str, key_ids,
              gen: int = -1, exact: bool = False):
        """One shm probe for the whole batch: ``(hits, probe, misses)``
        with ``probe`` a :class:`PackedProbe` (None when the table is
        not attached — every key is then a miss) and ``misses`` the
        indices to cross to the owner. Stale-attachment detection rides
        the probe: an epoch mismatch (the GRACEFUL owner-restart path —
        the retiring owner zeroes the arena's epoch word) triggers one
        refresh + re-probe, and a manifest mtime change (the CRASHED-
        owner path, where nobody retired the old arena) does the same
        at the cost of one stat per batch."""
        try:
            mt = os.stat(self._manifest_path).st_mtime_ns
        except OSError:
            mt = -1
        if mt != self._manifest_mtime:
            self.refresh()
        for _attempt in range(2):
            entry = self._attached.get((job, operator))
            if entry is None:
                self.refresh()
                entry = self._attached.get((job, operator))
                if entry is None:
                    return 0, None, list(range(len(key_ids)))
            ptr, cols, epoch, _path = entry
            if int(self._lib.hc_epoch(ptr)) != epoch:
                self.refresh()  # owner restarted: re-attach and retry
                continue
            keys = np.ascontiguousarray(
                np.asarray(key_ids, dtype=np.int64))
            n = len(keys)
            ncol = len(cols)
            sc = self._scratch(n, ncol)
            np.copyto(sc.keys[:n], keys)
            hits = self._lib.hc_get_batch_fe(
                ptr, self.frontend_id, n, sc.p_keys,
                int(gen) if exact else -1, sc.p_hit, sc.p_cnt,
                sc.p_ogen, sc.p_ons, sc.p_ovals, sc.p_otags)
            misses = ([] if hits == n else
                      [i for i, h in enumerate(sc.hit[:n].tolist())
                       if not h])
            tot = int(sc.cnt[:n].sum())
            probe = PackedProbe(sc.hit[:n].copy(), sc.cnt[:n].copy(),
                                sc.ons[:tot].copy(),
                                sc.ovals[:tot * ncol].copy(),
                                sc.otags[:tot].copy(), cols)
            return hits, probe, misses
        return 0, None, list(range(len(key_ids)))

    def note_miss_crossings(self, job: str, operator: str,
                            n: int) -> None:
        """Attribute ``n`` cold misses this frontend CROSSED to the
        owner for (the request-pipe trips) in the shared header."""
        entry = self._attached.get((job, operator))
        if entry is not None and n:
            self._lib.hc_fe_note(entry[0], self.frontend_id,
                                 0, 0, 0, int(n))
