"""Native session-metadata plane (port of
``flink_tpu/windowing/session_native.py``): the ctypes wrapper over
``native/sessions.cpp``.

One C sweep per batch replaces the numpy hot loop of
:class:`flink_tpu_torch.windowing.session_meta.SessionIntervalSet`:

- **absorb**: stable (key, ts) sort + sessionize + interval-index
  probe/extend/create + sid allocation + fire-candidate pushes run in
  ONE native pass over the batch columns (``sx_absorb``). The slow path
  (keys holding >= 2 live sessions, disjoint second sessions) stays in
  Python with exact reference semantics — the sweep flags those
  sessions and the base class's ``_merge_session`` handles them against
  the same store through the ctypes facade.
- **slot folding**: each metadata row carries the session's device-plane
  slot (``dslot``). Engines VERIFY a folded slot against the state
  table's own metadata views before trusting it (see
  ``state.slot_table.verify_slot_hints``), so singleton sessions — the
  overwhelming majority at high key cardinality — never touch the
  state-plane hash probe, and a stale fold costs a fallback probe,
  never a wrong row.
- **pop**: fire candidates live as native columnar chunks with cached
  ``[lo, hi]`` end bounds; ``sx_pop`` cuts, validates and removes fired
  singles in C and returns (key, start, end, sid, slot) columns ready
  for flat staging and ``free_slots(keys=, nss=)``.

The pure-Python plane remains the bit-identical fallback where the
library does not build; :func:`flink_tpu_torch.windowing.session_meta.
make_session_meta` selects per engine, the way ``make_slot_index`` does
for the state plane. The mesh session engine's host-prep sweeps
(``shard_group``, ``rec_shard_max``, ``route_records``) are one C pass
each here; on the Python plane the engine takes their NumPy equivalents
(``parallel/sharded_sessions.py``).
"""

from __future__ import annotations

import ctypes as _ct
import time
from typing import List, Optional, Tuple

import numpy as np

from flink_tpu_torch.windowing.session_meta import (
    AbsorbResult,
    NativePlaneError,
    PopResult,
    SessionIntervalSet,
)

#: hoisted ctypes pointer types (one construction per process — the
#: sweep runs once per batch per engine)
_I64P = _ct.POINTER(_ct.c_int64)
_I32P = _ct.POINTER(_ct.c_int32)
_U8P = _ct.POINTER(_ct.c_uint8)

_FLAG_FRESH = 0
_FLAG_EXTENDED = 1
_FLAG_SLOW = 2
_FLAG_STALE = 3


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


class _NativeSessionStore:
    """``make_slot_index``-shaped facade over the C session table.

    Sessions are keyed by key only (one metadata row per key in the
    singles store), so the ``namespaces`` argument the base-class slow
    paths pass is accepted and ignored. Interval columns (start / end /
    sid / folded dslot) are exposed as zero-copy NumPy views, re-wrapped
    after any call that can grow the table.
    """

    def __init__(self, lib, capacity: int = 1 << 16,
                 max_capacity: int = 1 << 28, on_grow=None) -> None:
        self._lib = lib
        self.on_grow = on_grow
        self._h = lib.sx_create(int(capacity), int(max_capacity))
        self._wrap_views()

    def _wrap_views(self) -> None:
        cap = int(self._lib.sx_capacity(self._h))
        self.capacity = cap
        h = self._h
        self.slot_key = np.ctypeslib.as_array(self._lib.sx_keys(h),
                                              shape=(cap,))
        self.start = np.ctypeslib.as_array(self._lib.sx_starts(h),
                                           shape=(cap,))
        self.end = np.ctypeslib.as_array(self._lib.sx_ends(h),
                                         shape=(cap,))
        self.sid = np.ctypeslib.as_array(self._lib.sx_sids(h),
                                         shape=(cap,))
        self.dslot = np.ctypeslib.as_array(self._lib.sx_dslots(h),
                                           shape=(cap,))
        self.slot_used = np.ctypeslib.as_array(
            self._lib.sx_used_mask(h), shape=(cap,)).view(bool)

    def _maybe_rewrap(self) -> None:
        if int(self._lib.sx_capacity(self._h)) != self.capacity:
            self._wrap_views()
            if self.on_grow is not None:
                self.on_grow()

    def destroy(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sx_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - finalizer
        try:
            self.destroy()
        except Exception:
            pass

    @property
    def num_used(self) -> int:
        return int(self._lib.sx_used(self._h))

    def used_slots(self) -> np.ndarray:
        return np.nonzero(self.slot_used)[0]

    def lookup(self, key_ids: np.ndarray, namespaces=None) -> np.ndarray:
        keys = np.ascontiguousarray(key_ids, dtype=np.int64)
        out = np.empty(len(keys), dtype=np.int32)
        self._lib.sx_lookup(self._h, len(keys), _i64p(keys), _i32p(out))
        return out

    def lookup_or_insert(self, key_ids: np.ndarray,
                         namespaces=None) -> np.ndarray:
        keys = np.ascontiguousarray(key_ids, dtype=np.int64)
        out = np.empty(len(keys), dtype=np.int32)
        rc = self._lib.sx_insert(self._h, len(keys), _i64p(keys),
                                 _i32p(out))
        if rc < 0:
            raise NativePlaneError(
                "native session store full (capacity="
                f"{self.capacity}) — raise its max capacity")
        if rc > 0:
            self._wrap_views()
            if self.on_grow is not None:
                self.on_grow()
        return out

    def free_slots(self, slots: np.ndarray, keys=None, nss=None) -> None:
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        if len(slots):
            self._lib.sx_erase_rows(self._h, len(slots), _i32p(slots))


def native_absorb(store: _NativeSessionStore, keys: np.ndarray,
                  ts: np.ndarray, gap: int, lateness: int,
                  max_fired_wm: int, next_sid: int):
    """The raw fused-sweep call: one ``sx_absorb`` per (engine, batch).

    Returns ``(m, n_fast, order, rec_to_sess, sess_key, sess_start,
    sess_end, sess_sid, sess_slot, sess_row, sess_flag)`` with the
    per-session arrays trimmed to the ``m`` batch-local sessions.
    ``sess_row`` is each fast-path session's metadata row — the fold
    writeback is a direct array scatter instead of a hash pass.
    """
    n = len(keys)
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    ts = np.ascontiguousarray(ts, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    rec_to_sess = np.empty(n, dtype=np.int64)
    sess_key = np.empty(n, dtype=np.int64)
    sess_start = np.empty(n, dtype=np.int64)
    sess_end = np.empty(n, dtype=np.int64)
    sess_sid = np.empty(n, dtype=np.int64)
    sess_slot = np.empty(n, dtype=np.int32)
    sess_row = np.empty(n, dtype=np.int32)
    sess_flag = np.empty(n, dtype=np.uint8)
    n_fast = _ct.c_int64()
    m = store._lib.sx_absorb(
        store._h, n, _i64p(keys), _i64p(ts),
        int(gap), int(lateness), int(max_fired_wm), int(next_sid),
        _i64p(order), _i64p(rec_to_sess),
        _i64p(sess_key), _i64p(sess_start), _i64p(sess_end),
        _i64p(sess_sid), _i32p(sess_slot), _i32p(sess_row),
        sess_flag.ctypes.data_as(_U8P), _ct.byref(n_fast))
    if m < 0:
        raise NativePlaneError(
            "native session store full during absorb — raise its max "
            "capacity")
    store._maybe_rewrap()
    return (int(m), int(n_fast.value), order, rec_to_sess,
            sess_key[:m], sess_start[:m], sess_end[:m], sess_sid[:m],
            sess_slot[:m], sess_row[:m], sess_flag[:m])


def native_pop(store: _NativeSessionStore, watermark: int):
    """The raw chunk-pop call: cut + validate + remove fired singles in
    C. Returns ``((keys, starts, ends, sids, slots), (rest_keys,
    rest_sids, rest_ends))`` — rest rows belong to multi-interval keys
    and are walked by the Python caller."""
    n_rest = _ct.c_int64()
    n = int(store._lib.sx_pop(store._h, int(watermark),
                              _ct.byref(n_rest)))
    keys = np.empty(n, dtype=np.int64)
    starts = np.empty(n, dtype=np.int64)
    ends = np.empty(n, dtype=np.int64)
    sids = np.empty(n, dtype=np.int64)
    slots = np.empty(n, dtype=np.int32)
    if n:
        store._lib.sx_pop_fetch(store._h, _i64p(keys), _i64p(starts),
                                _i64p(ends), _i64p(sids), _i32p(slots))
    nr = int(n_rest.value)
    rk = np.empty(nr, dtype=np.int64)
    rs = np.empty(nr, dtype=np.int64)
    re = np.empty(nr, dtype=np.int64)
    if nr:
        store._lib.sx_pop_fetch_rest(store._h, _i64p(rk), _i64p(rs),
                                     _i64p(re))
    return (keys, starts, ends, sids, slots), (rk, rs, re)


class NativeSessionIntervalSet(SessionIntervalSet):
    """SessionIntervalSet with the hot paths replaced by the C sweep.

    Bit-identity discipline: every classification, push order and
    validation rule in ``sx_absorb`` / ``sx_pop`` mirrors the base
    class line by line (same stable sort, same fast/slow split, same
    chunk cut); the slow paths ARE the base class's, run against the C
    store through the ``make_slot_index``-shaped facade. Fires and
    snapshots are pinned bit-identical across planes, and to the
    reference's, by tests/test_torch_session_meta.py.
    """

    def __init__(self, gap: int, allowed_lateness: int = 0):
        from flink_tpu_torch.native import load_sessions

        self._lib = load_sessions()
        if self._lib is None:
            raise RuntimeError("NativeSessionIntervalSet needs the native "
                               "sessions library (native/sessions.cpp)")
        self._store: Optional[_NativeSessionStore] = None
        super().__init__(gap, allowed_lateness)

    # ------------------------------------------------------------ store

    def _reset_store(self) -> None:
        if self._store is not None:
            self._store.destroy()
        self._store = _NativeSessionStore(self._lib,
                                          on_grow=self._rebind_views)
        self._idx = self._store
        self._rebind_views()
        self._multi.clear()

    def _rebind_views(self) -> None:
        st = self._store
        self._s_start = st.start
        self._s_end = st.end
        self._s_sid = st.sid

    def _on_grow(self, old: int, new: int) -> None:  # pragma: no cover
        # growth re-binds through the store's on_grow callback instead
        self._rebind_views()

    def _intervals_of(self, key: int):
        # scalar-ctypes fast path: the slow path probes one key at a
        # time, and the base class's 1-element array round trip cost
        # more in pointer marshalling than the probe itself
        ivs = self._multi.get(key)
        if ivs is not None:
            return ivs
        row = int(self._lib.sx_lookup1(self._store._h, int(key)))
        if row < 0:
            return None
        return [(int(self._s_start[row]), int(self._s_end[row]),
                 int(self._s_sid[row]))]

    def _store_intervals(self, key: int,
                         ivs: List[Tuple[int, int, int]]) -> None:
        # scalar write-back + multi-membership mirroring into the
        # native set (the sweep classifies against it)
        lib, h = self._lib, self._store._h
        key = int(key)
        row = int(lib.sx_lookup1(h, key))
        if len(ivs) == 1:
            self._multi.pop(key, None)
            lib.sx_multi_remove(h, key)
            if row < 0:
                row = int(lib.sx_insert1(h, key))
                if row < 0:
                    raise NativePlaneError(
                        "native session store full — raise its max "
                        "capacity")
                self._store._maybe_rewrap()
            s, e, sid = ivs[0]
            self._s_start[row] = s
            self._s_end[row] = e
            self._s_sid[row] = sid
        else:
            if row >= 0:
                lib.sx_erase1(h, row)
            ivs.sort()
            self._multi[key] = ivs
            lib.sx_multi_add(h, key)

    def note_slots(self, keys: np.ndarray, sids: np.ndarray,
                   slots: np.ndarray, rows=None) -> None:
        if not len(keys):
            return
        if rows is not None:
            # fold by direct row access: the rows came out of THIS
            # batch's sweep and row ids are stable across the slow loop
            # (grow reallocs in place, erases touch other keys). The
            # sid guard in sx_fold_rows drops any row a slow-path merge
            # re-purposed.
            rows = np.ascontiguousarray(rows, dtype=np.int32)
            sids = np.ascontiguousarray(sids, dtype=np.int64)
            slots = np.ascontiguousarray(slots, dtype=np.int32)
            self._lib.sx_fold_rows(self._store._h, len(rows),
                                   _i32p(rows), _i64p(sids),
                                   _i32p(slots))
            return
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        sids = np.ascontiguousarray(sids, dtype=np.int64)
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        self._lib.sx_fold(self._store._h, len(keys), _i64p(keys),
                          _i64p(sids), _i32p(slots))

    # ----------------------------------------------------------- absorb

    def absorb_batch_ex(self, keys: np.ndarray, ts: np.ndarray,
                        want_fresh: bool = True) -> AbsorbResult:
        # want_fresh is accepted for interface parity and ignored: the
        # sweep's flag column makes the fresh mask a free compare
        t0 = time.perf_counter()
        (m, n_fast, order, rec_to_sess, sess_key, sess_start, sess_end,
         sess_sid, sess_slot, sess_row, sess_flag) = native_absorb(
            self._store, keys, ts, self.gap, self.allowed_lateness,
            self.max_fired_watermark, self._next_sid)
        self._next_sid += n_fast
        self.native_sweep_s += time.perf_counter() - t0
        # slow path: multi-flavored sessions + disjoint seconds, exact
        # reference semantics in the base class, ascending (key, ts)
        slow = np.nonzero(sess_flag == _FLAG_SLOW)[0]
        if len(slow):
            self._groups, self._cur = [], None
            self._cur_dst, self._cur_src = set(), set()
            for j in slow:
                sess_sid[j] = self._merge_session(
                    int(sess_key[j]), int(sess_start[j]),
                    int(sess_end[j]))
            groups = self._groups
            if self._cur is not None and len(self._cur):
                groups.append(self._cur)
            self._groups, self._cur = [], None
        else:
            groups = []
        return AbsorbResult(sess_key, sess_sid, rec_to_sess, order,
                            groups, sess_flag == _FLAG_FRESH, sess_slot,
                            sess_row)

    def absorb_batch(self, keys: np.ndarray, ts: np.ndarray):
        r = self.absorb_batch_ex(keys, ts)
        return r.sess_key, r.sess_sid, r.rec_to_sess, r.order, r.groups

    # ------------------------------------------------------------- fire

    def _push_fires(self, ends: np.ndarray, keys: np.ndarray,
                    sids: np.ndarray) -> None:
        n = len(ends)
        if not n:
            return
        e = np.ascontiguousarray(ends, dtype=np.int64)
        k = np.ascontiguousarray(keys, dtype=np.int64)
        s = np.ascontiguousarray(sids, dtype=np.int64)
        self._lib.sx_push_chunk(self._store._h, n, _i64p(e), _i64p(k),
                                _i64p(s))

    _EMPTY_POP_EX = PopResult(*(np.empty(0, dtype=np.int64),) * 4,
                              slot_hint=np.empty(0, dtype=np.int32))

    def pop_fired_ex(self, watermark: int) -> PopResult:
        # effective earliest pending end = min(native chunks, the
        # Python-side scalar push buffer the slow path still uses)
        eff_min = min(self._min_pending_end,
                      int(self._lib.sx_min_pending(self._store._h)))
        if watermark < eff_min - 1:
            self.max_fired_watermark = max(self.max_fired_watermark,
                                           watermark)
            return self._EMPTY_POP_EX
        self._drain_fire_buf()  # buf -> one native chunk
        self._min_pending_end = 1 << 62
        t0 = time.perf_counter()
        (keys, starts, ends, sids, slots), (rk, rs, re) = native_pop(
            self._store, watermark)
        self.native_sweep_s += time.perf_counter() - t0
        self.max_fired_watermark = max(self.max_fired_watermark,
                                       watermark)
        if self._multi and len(rk):
            # the base class's reference-shaped walk, with this plane's
            # scalar store accessors (one copy — see _pop_rest_walk)
            ek, es, ee, esid, eslot = self._pop_rest_walk(rk, rs, re)
            if ek:
                keys = np.concatenate([
                    keys, np.asarray(ek, dtype=np.int64)])
                starts = np.concatenate([
                    starts, np.asarray(es, dtype=np.int64)])
                ends = np.concatenate([
                    ends, np.asarray(ee, dtype=np.int64)])
                sids = np.concatenate([
                    sids, np.asarray(esid, dtype=np.int64)])
                slots = np.concatenate([
                    slots, np.asarray(eslot, dtype=np.int32)])
                o = np.argsort(ends, kind="stable")
                keys, starts = keys[o], starts[o]
                ends, sids, slots = ends[o], sids[o], slots[o]
        return PopResult(keys, starts, ends, sids, slots)

    def pop_fired(self, watermark: int):
        r = self.pop_fired_ex(watermark)
        return r.keys, r.starts, r.ends, r.sids

    def _rest_single_lookup(self, key: int) -> int:
        return int(self._lib.sx_lookup1(self._store._h, int(key)))

    # ------------------------------------------- host-prep sweep helpers

    def shard_group(self, res: AbsorbResult, P: int, maxp: int,
                    key_group_range) -> Tuple:
        """Per-session shard assignment and stable grouping of the LIVE
        sessions by shard, gathering every resolve column in ONE C pass
        (``sx_shard_group``; the key-group formula of ``keygroups.py``).
        Returns ``(sess_shard, counts, sorted_idx, key_sorted,
        sid_sorted, fresh_sorted, hint_sorted, row_sorted)``; the sorted
        arrays slice contiguously per shard."""
        m = len(res.sess_key)
        kg_first, kg_last = (key_group_range
                             if key_group_range is not None else (-1, -1))
        shard = np.empty(m, dtype=np.int64)
        counts = np.empty(int(P), dtype=np.int64)
        sorted_idx = np.empty(m, dtype=np.int64)
        key_s = np.empty(m, dtype=np.int64)
        sid_s = np.empty(m, dtype=np.int64)
        fresh_s = np.empty(m, dtype=np.uint8)
        hint_s = np.empty(m, dtype=np.int32)
        row_s = np.empty(m, dtype=np.int32)
        t0 = time.perf_counter()
        nl = int(self._lib.sx_shard_group(
            m, _i64p(res.sess_key), _i64p(res.sess_sid),
            res.fresh.view(np.uint8).ctypes.data_as(_U8P),
            _i32p(res.slot_hint), _i32p(res.meta_row),
            int(P), int(maxp), int(kg_first), int(kg_last),
            _i64p(shard), _i64p(counts), _i64p(sorted_idx),
            _i64p(key_s), _i64p(sid_s),
            fresh_s.ctypes.data_as(_U8P), _i32p(hint_s), _i32p(row_s)))
        self.native_sweep_s += time.perf_counter() - t0
        if nl < 0:
            raise ValueError(
                "session key routed outside the engine's key-group "
                "range — upstream routing bug")
        return (shard, counts, sorted_idx[:nl], key_s[:nl], sid_s[:nl],
                fresh_s[:nl].view(bool), hint_s[:nl], row_s[:nl])

    def rec_shard_max(self, keys: np.ndarray, P: int, maxp: int,
                      key_group_range) -> int:
        """The largest per-shard record count of a batch in one C pass
        (``sx_rec_shard_max``): the cheap first check of the engine's
        batch split."""
        kg_first, kg_last = (key_group_range
                             if key_group_range is not None else (-1, -1))
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        t0 = time.perf_counter()
        mx = int(self._lib.sx_rec_shard_max(
            len(keys), _i64p(keys), int(P), int(maxp),
            int(kg_first), int(kg_last)))
        self.native_sweep_s += time.perf_counter() - t0
        if mx < 0:
            raise ValueError(
                "record key routed outside the engine's key-group "
                "range — upstream routing bug")
        return mx

    def route_records(self, n: int, order: np.ndarray,
                      rec_to_sess: np.ndarray, m: int,
                      sorted_idx: np.ndarray, slot_sorted: np.ndarray,
                      sess_shard: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Record routing in one C pass (``sx_route``):
        ``rec[order[i]] = per_session[rec_to_sess[i]]`` for the slot and
        shard columns, the resolved slots arriving as the (sorted_idx,
        slot_sorted) pairs of the per-shard resolve; sessions without a
        resolved slot (stale on arrival) route their records to slot 0."""
        rec_slots = np.empty(n, dtype=np.int32)
        rec_shards = np.empty(n, dtype=np.int64)
        order = np.ascontiguousarray(order, dtype=np.int64)
        rec_to_sess = np.ascontiguousarray(rec_to_sess, dtype=np.int64)
        sorted_idx = np.ascontiguousarray(sorted_idx, dtype=np.int64)
        slot_sorted = np.ascontiguousarray(slot_sorted, dtype=np.int32)
        sess_shard = np.ascontiguousarray(sess_shard, dtype=np.int64)
        t0 = time.perf_counter()
        self._lib.sx_route(
            int(n), int(m), _i64p(order), _i64p(rec_to_sess),
            len(sorted_idx), _i64p(sorted_idx), _i32p(slot_sorted),
            _i64p(sess_shard), _i32p(rec_slots), _i64p(rec_shards))
        self.native_sweep_s += time.perf_counter() - t0
        return rec_slots, rec_shards

    def _rest_single_free(self, slot: int) -> int:
        dslot = int(self._store.dslot[slot])
        self._lib.sx_erase1(self._store._h, slot)
        return dslot
