"""Host-side session interval metadata (port of
``flink_tpu/windowing/session_meta.py``, host code with the same
behaviour), shared by the single-device session engine and the
mesh-sharded one (``parallel/sharded_sessions.py``).

reference: MergingWindowSet + WindowOperator.java:159-162 — merge *metadata*
(tiny per-key interval lists) lives apart from merged *state* (accumulator
slots). This module is the metadata half; a device engine supplies the state
half (slot resolution + merge/scatter/fire kernels).

Key property exploited by the mesh engine: sessions are per-key and keys are
owned by exactly one shard (key-group routing), so session merging NEVER
crosses shards — the metadata is engine-global, only slot residency is
sharded.

Columnar store (round 5): the clickstream shape holds ~one live session
per key across millions of keys, and a dict of per-key interval lists
priced every operation at a Python allocation. The store is now hybrid:

- **singles** (the overwhelming case): a slot index (the same native
  hash map the state plane uses) maps key -> slot into dense
  ``start/end/sid`` arrays. Registration, overlap-extend, fire
  validation, and removal are all vectorized batch operations.
- **multi**: keys holding >= 2 concurrently-live sessions fall back to
  the reference-shaped interval lists (``key -> [(start, end, sid)]``)
  — exact merge semantics, including accumulator merge groups.

A key lives in exactly one of the two stores; promotion/demotion happens
in the slow path that needed it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.state.slot_table import make_slot_index

_NEG_INF = -(1 << 62)


class NativePlaneError(RuntimeError):
    """A native (C) metadata sweep failed at runtime (its store is full).
    The single-device engine lets it end the job; the reference's mesh
    engine falls back to the Python plane there (as the port's mesh
    session engine does)."""


@dataclasses.dataclass
class AbsorbResult:
    """One absorbed batch, engine-facing: the classic absorb_batch tuple
    plus the per-session columns the state-plane resolve consumes.

    ``fresh``: sessions CREATED by this absorb that cannot be resident
    or paged in the state plane (skip the hash probe AND the page
    query). ``slot_hint``: the folded device slot from the metadata row
    (-1 unknown) — engines VERIFY a hint against the state table's own
    metadata before trusting it, so a stale fold costs a fallback
    probe, never a wrong row."""

    sess_key: np.ndarray
    sess_sid: np.ndarray
    rec_to_sess: np.ndarray
    order: np.ndarray
    groups: List["MergeGroup"]
    #: None when the caller opted out (want_fresh=False — only the
    #: paged resolve reads it)
    fresh: Optional[np.ndarray]
    slot_hint: Optional[np.ndarray] = None
    #: native plane: each fast-path session's metadata row, -1 for
    #: slow/stale sessions — lets note_slots fold by direct array
    #: scatter instead of a hash pass
    meta_row: Optional[np.ndarray] = None


@dataclasses.dataclass
class PopResult:
    """One watermark pop: fired sessions as columnar int64 arrays in end
    order, plus the folded device slot per fired session (-1 unknown;
    only the native plane folds)."""

    keys: np.ndarray
    starts: np.ndarray
    ends: np.ndarray
    sids: np.ndarray
    slot_hint: Optional[np.ndarray] = None


@dataclasses.dataclass
class MergeGroup:
    """A chain-free batch of accumulator merges: within one group no sid is
    both a source and a destination, so a single gather/scatter kernel is
    safe. Groups must execute in order."""

    keys_dst: List[int] = dataclasses.field(default_factory=list)
    sids_dst: List[int] = dataclasses.field(default_factory=list)
    keys_src: List[int] = dataclasses.field(default_factory=list)
    sids_src: List[int] = dataclasses.field(default_factory=list)
    absorbed_sids: List[int] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.sids_dst)


class _SessionsView:
    """Read-only dict-like view over the hybrid store — keeps the
    ``meta.sessions`` surface (query paths, tests) unchanged."""

    def __init__(self, meta: "SessionIntervalSet"):
        self._m = meta

    def get(self, key, default=None):
        ivs = self._m._intervals_of(int(key))
        return ivs if ivs is not None else default

    def __getitem__(self, key):
        ivs = self._m._intervals_of(int(key))
        if ivs is None:
            raise KeyError(key)
        return ivs

    def __contains__(self, key) -> bool:
        return self._m._intervals_of(int(key)) is not None

    def __len__(self) -> int:
        return int(self._m._idx.num_used) + len(self._m._multi)

    def items(self):
        m = self._m
        used = m._idx.used_slots()
        keys = m._idx.slot_key[used]
        for k, s, e, sid in zip(keys.tolist(),
                                m._s_start[used].tolist(),
                                m._s_end[used].tolist(),
                                m._s_sid[used].tolist()):
            yield int(k), [(int(s), int(e), int(sid))]
        for k, ivs in m._multi.items():
            yield int(k), list(ivs)

    def keys(self):
        for k, _ in self.items():
            yield k


class SessionIntervalSet:
    """Per-key session intervals + lazy fire candidates + sid allocator."""

    def __init__(self, gap: int, allowed_lateness: int = 0):
        self.gap = int(gap)
        self.allowed_lateness = int(allowed_lateness)
        #: time spent inside the native sweep calls (absorb + pop); the
        #: pure-Python plane keeps it at 0.0 — bench tooling reports it
        #: as its own host-prep line
        self.native_sweep_s = 0.0
        #: keys with >= 2 live sessions: reference-shaped interval lists
        self._multi: Dict[int, List[Tuple[int, int, int]]] = {}
        self._reset_store()
        self._next_sid = 1
        #: fire candidates as COLUMNAR chunks
        #: [(ends, keys, sids, lo, hi), ...] with cached per-chunk
        #: end bounds — pushes are array appends, and the watermark cut
        #: touches only chunks the watermark actually reached: a chunk
        #: wholly due pops whole, a chunk wholly pending is SKIPPED
        #: untouched. Event time advances chunk by chunk, so a pop is
        #: O(due + one straddler), never O(live candidates) — the old
        #: single-merged-chunk layout re-masked and re-copied the whole
        #: ~live-session-sized pool on every watermark advance.
        self._fire_chunks: List[Tuple[np.ndarray, np.ndarray,
                                      np.ndarray, int, int]] = []
        #: scalar push buffers (slow-path merges), drained into a chunk
        #: — three parallel component lists, NOT a list of tuples (the
        #: drain builds columns; np.asarray over tuples walked every
        #: element twice)
        self._fire_buf: Tuple[List[int], List[int], List[int]] = \
            ([], [], [])
        #: earliest pending candidate end — pop_fired returns O(1) when
        #: the watermark has not reached it (the heap's cheap peek)
        self._min_pending_end = 1 << 62
        self.max_fired_watermark = _NEG_INF
        self.late_records_dropped = 0
        # merge-group accumulation during absorb_batch
        self._groups: List[MergeGroup] = []
        self._cur: Optional[MergeGroup] = None
        self._cur_dst: set = set()
        self._cur_src: set = set()

    def _reset_store(self) -> None:
        """(Re)create the empty singles store — the ONE hook the native
        plane overrides to swap the numpy arrays for the C views."""
        self._idx = make_slot_index(1 << 16, on_grow=self._on_grow,
                                    track_namespaces=False)
        cap = self._idx.capacity
        self._s_start = np.zeros(cap, dtype=np.int64)
        self._s_end = np.zeros(cap, dtype=np.int64)
        self._s_sid = np.zeros(cap, dtype=np.int64)
        self._multi.clear()

    def _on_grow(self, old: int, new: int) -> None:
        for name in ("_s_start", "_s_end", "_s_sid"):
            arr = getattr(self, name)
            grown = np.zeros(new, dtype=np.int64)
            grown[:old] = arr
            setattr(self, name, grown)

    # --------------------------------------------------------- store access

    @property
    def sessions(self) -> _SessionsView:
        return _SessionsView(self)

    @property
    def sid_watermark(self) -> int:
        """Next session id the allocator will hand out — sids are
        monotonic, so a sid >= the pre-absorb watermark marks a session
        CREATED by that absorb (engines use this to skip state-plane
        probes for sessions that cannot exist there yet)."""
        return self._next_sid

    def _intervals_of(self, key: int
                      ) -> Optional[List[Tuple[int, int, int]]]:
        ivs = self._multi.get(key)
        if ivs is not None:
            return ivs
        a = np.asarray([key], dtype=np.int64)
        slot = int(self._idx.lookup(a, a)[0])
        if slot < 0:
            return None
        return [(int(self._s_start[slot]), int(self._s_end[slot]),
                 int(self._s_sid[slot]))]

    def _store_intervals(self, key: int,
                         ivs: List[Tuple[int, int, int]]) -> None:
        """Write a key's (possibly merged) interval list back to the
        hybrid store, moving it between singles and multi as needed."""
        a = np.asarray([key], dtype=np.int64)
        slot = int(self._idx.lookup(a, a)[0])
        if len(ivs) == 1:
            self._multi.pop(key, None)
            if slot < 0:
                slot = int(self._idx.lookup_or_insert(a, a)[0])
            s, e, sid = ivs[0]
            self._s_start[slot] = s
            self._s_end[slot] = e
            self._s_sid[slot] = sid
        else:
            if slot >= 0:
                self._idx.free_slots(np.asarray([slot], dtype=np.int32))
            ivs.sort()
            self._multi[key] = ivs

    # ------------------------------------------------------- fire pending

    def _push_fire(self, end: int, key: int, sid: int) -> None:
        ends, keys, sids = self._fire_buf
        ends.append(end)
        keys.append(key)
        sids.append(sid)
        if end < self._min_pending_end:
            self._min_pending_end = end

    def _push_fires(self, ends: np.ndarray, keys: np.ndarray,
                    sids: np.ndarray) -> None:
        if len(ends):
            ends = np.asarray(ends, dtype=np.int64)
            lo = int(ends.min())
            self._fire_chunks.append((
                ends,
                np.asarray(keys, dtype=np.int64),
                np.asarray(sids, dtype=np.int64),
                lo, int(ends.max())))
            if lo < self._min_pending_end:
                self._min_pending_end = lo

    def _drain_fire_buf(self) -> None:
        if self._fire_buf[0]:
            ends, keys, sids = self._fire_buf
            self._fire_buf = ([], [], [])
            self._push_fires(np.asarray(ends, dtype=np.int64),
                             np.asarray(keys, dtype=np.int64),
                             np.asarray(sids, dtype=np.int64))

    # ---------------------------------------------------------------- absorb

    def absorb_batch(self, keys: np.ndarray, ts: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, List[MergeGroup]]:
        """Sessionize a batch and merge it into the interval set.

        Returns ``(sess_key, sess_sid, rec_to_sess, order, merge_groups)``:
        per batch-local session its key and merged sid (-1 = stale on
        arrival, see below), the sorted-order record->session indirection,
        the lexsort order itself, and the accumulator merges the metadata
        merge implied. Records of a stale session must be dropped (counted
        in ``late_records_dropped`` by the caller via the -1 marker).

        Lateness is decided per *merged session*, not per record — an
        out-of-order record that merges into a live session is never late
        (reference: WindowOperator merges first, then isWindowLate).
        """
        n = len(keys)
        # vectorized batch-local sessionization: sort by (key, ts); a new
        # local session starts at a key change or a gap exceedance.
        # When the batch's time span fits the spare bits of an int64 the
        # two-key lexsort collapses into ONE argsort of a packed
        # (key << span_bits) | (ts - ts_min) column — measurably cheaper
        # at micro-batch sizes, and every realistic micro-batch spans
        # seconds, not years
        t_min = int(ts.min()) if n else 0
        span = (int(ts.max()) - t_min) if n else 0
        k_min = int(keys.min()) if n else 0
        k_max = int(keys.max()) if n else 0
        shift = max(span.bit_length(), 1)
        # shift <= 62 guards the span itself: a pathological range
        # (sentinel timestamps) must take the lexsort fallback, not a
        # negative-shift ValueError
        if n and shift <= 62 and k_min >= 0 \
                and (k_max >> (62 - shift)) == 0:
            packed = (keys.astype(np.int64) << shift) | \
                (ts.astype(np.int64) - t_min)
            order = np.argsort(packed, kind="stable")
        else:
            order = np.lexsort((ts, keys))
        ks, tss = keys[order], ts[order]
        new_sess = np.empty(n, dtype=bool)
        new_sess[0] = True
        new_sess[1:] = (ks[1:] != ks[:-1]) | (tss[1:] - tss[:-1] > self.gap)
        rec_to_sess = np.cumsum(new_sess) - 1
        starts_pos = np.nonzero(new_sess)[0]
        m = len(starts_pos)
        ends_pos = np.empty(m, dtype=np.int64)
        ends_pos[:-1] = starts_pos[1:] - 1
        ends_pos[-1] = n - 1
        sess_key = ks[starts_pos]
        sess_min = tss[starts_pos]
        sess_max = tss[ends_pos]

        self._groups, self._cur = [], None
        self._cur_dst, self._cur_src = set(), set()
        sess_sid = np.empty(m, dtype=np.int64)
        ends_all = sess_max + self.gap

        if self.max_fired_watermark > _NEG_INF // 2:
            stale = (ends_all - 1 + self.allowed_lateness
                     <= self.max_fired_watermark)
        else:
            stale = np.zeros(m, dtype=bool)

        first_of_key = np.empty(m, dtype=bool)
        first_of_key[0] = True
        first_of_key[1:] = sess_key[1:] != sess_key[:-1]
        only_of_key = first_of_key.copy()
        only_of_key[:-1] &= first_of_key[1:]

        slots = self._idx.lookup(sess_key, sess_key)
        found = slots >= 0
        in_multi = np.zeros(m, dtype=bool)
        if self._multi:
            probe = ~found
            if probe.any():
                pk = sess_key[probe]
                in_multi[probe] = np.fromiter(
                    (int(k) in self._multi for k in pk.tolist()),
                    np.bool_, len(pk))

        # A: fresh singles (no stored state) — bulk registration
        fast = only_of_key & ~found & ~in_multi
        fresh_stale = fast & stale
        fast &= ~stale
        cnt = int(fast.sum())
        if cnt:
            sids_fast = np.arange(self._next_sid, self._next_sid + cnt,
                                  dtype=np.int64)
            self._next_sid += cnt
            sess_sid[fast] = sids_fast
            fk = sess_key[fast]
            fslots = self._idx.lookup_or_insert(fk, fk)
            self._s_start[fslots] = sess_min[fast]
            self._s_end[fslots] = ends_all[fast]
            self._s_sid[fslots] = sids_fast
            self._push_fires(ends_all[fast], fk, sids_fast)
        sess_sid[fresh_stale] = -1  # stale on arrival (never stored)

        # B: sole local session meeting a stored SINGLE — vectorized
        # overlap-extend; disjoint ones (a second live session) and
        # everything multi-flavored go to the exact slow path
        b = only_of_key & found
        slow_extra = None
        if b.any():
            bi = np.nonzero(b)[0]
            bs = slots[bi]
            ex_s = self._s_start[bs]
            ex_e = self._s_end[bs]
            ov = (sess_min[bi] <= ex_e) & (ex_s <= ends_all[bi])
            b1 = bi[ov]
            if len(b1):
                s1 = slots[b1]
                ns_ = np.minimum(self._s_start[s1], sess_min[b1])
                ne_ = np.maximum(self._s_end[s1], ends_all[b1])
                changed = ne_ != self._s_end[s1]
                self._s_start[s1] = ns_
                self._s_end[s1] = ne_
                sess_sid[b1] = self._s_sid[s1]
                if changed.any():
                    self._push_fires(ne_[changed],
                                     sess_key[b1][changed],
                                     self._s_sid[s1][changed])
            slow_extra = bi[~ov]

        # slow path: multi-flavored rows (everything not covered above)
        # plus B2 (disjoint second sessions), in ascending (key, ts) order
        covered = fast | fresh_stale | b
        slow = np.nonzero(~covered)[0]
        if slow_extra is not None and len(slow_extra):
            slow = np.sort(np.concatenate([slow, slow_extra]))
        for j in slow:
            sess_sid[j] = self._merge_session(
                int(sess_key[j]), int(sess_min[j]), int(ends_all[j]))
        groups = self._groups
        if self._cur is not None and len(self._cur):
            groups.append(self._cur)
        self._groups, self._cur = [], None
        return sess_key, sess_sid, rec_to_sess, order, groups

    def absorb_batch_ex(self, keys: np.ndarray, ts: np.ndarray,
                        want_fresh: bool = True) -> AbsorbResult:
        """absorb_batch plus the per-session resolve columns engines
        consume: the fresh mask (sids allocated by THIS absorb, minus
        merge destinations — a fresh dst was already inserted by its
        merge group, and skipping its probe would leave it
        eviction-unprotected inside the very resolve that follows) and,
        on the native plane, the folded device-slot hints.

        ``want_fresh=False`` skips the fresh-mask derivation (the
        unique/isin over merge destinations) — only the PAGED resolve
        reads it, and this sits on the per-batch hot path."""
        sid_floor = self.sid_watermark
        sess_key, sess_sid, rec_to_sess, order, groups = \
            self.absorb_batch(keys, ts)
        fresh = None
        if want_fresh:
            fresh = sess_sid >= sid_floor
            if groups:
                merged_dst = np.unique(np.concatenate(
                    [np.asarray(g.sids_dst, dtype=np.int64)
                     for g in groups]))
                if len(merged_dst):
                    fresh &= ~np.isin(sess_sid, merged_dst)
        return AbsorbResult(sess_key, sess_sid, rec_to_sess, order,
                            groups, fresh)

    def note_slots(self, keys: np.ndarray, sids: np.ndarray,
                   slots: np.ndarray, rows=None) -> None:
        """Fold resolved device slots back into the metadata rows so the
        NEXT batch's resolve can skip the state-plane hash probe.
        ``rows``: the sessions' metadata rows when the caller holds them
        (AbsorbResult.meta_row) — fold by direct scatter, no hash pass.
        The pure-Python plane does not fold (its resolve is the
        reference path) — no-op."""

    def _add_merge(self, key: int, dst_sid: int, src_sid: int) -> None:
        """Queue an accumulator merge. A chain (src was an earlier dst, or
        dst was an earlier src) would make a single gather/scatter kernel
        read stale values, so it closes the current group."""
        if self._cur is None:
            self._cur = MergeGroup()
        elif (src_sid in self._cur_dst or src_sid in self._cur_src
                or dst_sid in self._cur_src):
            self._groups.append(self._cur)
            self._cur = MergeGroup()
            self._cur_dst, self._cur_src = set(), set()
        g = self._cur
        g.keys_dst.append(key)
        g.sids_dst.append(dst_sid)
        g.keys_src.append(key)
        g.sids_src.append(src_sid)
        g.absorbed_sids.append(src_sid)
        self._cur_dst.add(dst_sid)
        self._cur_src.add(src_sid)

    def _merge_session(self, key: int, start: int, end: int) -> int:
        """Merge [start, end) into key's intervals; returns the session id,
        or -1 if the session is stale on arrival. Mirrors
        MergingWindowSet.addWindow: overlapping intervals collapse into
        one; absorbed sessions queue an accumulator merge."""
        intervals = self._intervals_of(key)
        if intervals is None:
            if self._stale(end):
                return -1
            sid = self._alloc_sid()
            self._store_intervals(key, [(start, end, sid)])
            self._push_fire(end, key, sid)
            return sid

        overlapping = [iv for iv in intervals
                       if iv[0] <= end and start <= iv[1]]
        if not overlapping:
            if self._stale(end):
                return -1
            sid = self._alloc_sid()
            intervals.append((start, end, sid))
            self._store_intervals(key, intervals)
            self._push_fire(end, key, sid)
            return sid

        # absorb into the first overlapping interval's session
        keep = overlapping[0]
        new_start = min(start, keep[0])
        new_end = max(end, keep[1])
        for iv in overlapping[1:]:
            new_start = min(new_start, iv[0])
            new_end = max(new_end, iv[1])
            self._add_merge(key, keep[2], iv[2])
        remaining = [iv for iv in intervals if iv not in overlapping]
        remaining.append((new_start, new_end, keep[2]))
        self._store_intervals(key, remaining)
        if new_end != keep[1]:
            self._push_fire(new_end, key, keep[2])
        return keep[2]

    def _stale(self, end: int) -> bool:
        return (self.max_fired_watermark > _NEG_INF // 2
                and end - 1 + self.allowed_lateness
                <= self.max_fired_watermark)

    def _alloc_sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    # ------------------------------------------------------------------ fire

    _EMPTY_POP = (np.empty(0, dtype=np.int64),) * 4

    def pop_fired_ex(self, watermark: int) -> PopResult:
        """pop_fired plus the fired sessions' folded device slots (the
        native plane's pop carries them out of the metadata rows; here
        they are unknown)."""
        keys, starts, ends, sids = self.pop_fired(watermark)
        return PopResult(keys, starts, ends, sids)

    def pop_fired(self, watermark: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
        """All sessions whose end - 1 <= watermark, removed from the set.
        Returns int64 ARRAYS (keys, starts, ends, sids) in end order —
        the fire paths are columnar, and a list round-trip here cost a
        tolist + re-asarray of every fired session. Stale candidates
        (merged or extended sessions) are skipped lazily — one vectorized
        watermark cut selects the due candidates, one vectorized
        (sid, end) compare validates the single-store ones; only
        multi-key candidates walk interval lists."""
        if watermark < self._min_pending_end - 1:
            # nothing can be due yet — O(1), the heap's cheap peek
            self.max_fired_watermark = max(self.max_fired_watermark,
                                           watermark)
            return self._EMPTY_POP
        self._drain_fire_buf()
        if not self._fire_chunks:
            self._min_pending_end = 1 << 62
            self.max_fired_watermark = max(self.max_fired_watermark,
                                           watermark)
            return self._EMPTY_POP
        # chunk-bounded watermark cut: whole chunks pop or stay by their
        # cached [lo, hi] end bounds; only STRADDLING chunks pay a mask
        due_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        kept: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]] \
            = []
        min_pending = 1 << 62
        for chunk in self._fire_chunks:
            ends, keys, sids, lo, hi = chunk
            if hi - 1 <= watermark:          # wholly due
                due_parts.append((ends, keys, sids))
            elif lo - 1 > watermark:         # wholly pending: untouched
                kept.append(chunk)
                min_pending = min(min_pending, lo)
            else:                            # straddler
                due = ends - 1 <= watermark
                due_parts.append((ends[due], keys[due], sids[due]))
                keep = ~due
                k_ends = ends[keep]
                k_lo = int(k_ends.min())
                kept.append((k_ends, keys[keep], sids[keep],
                             k_lo, int(k_ends.max())))
                min_pending = min(min_pending, k_lo)
        self._fire_chunks = kept
        self._min_pending_end = min_pending
        if due_parts:
            if len(due_parts) > 1:
                d_ends = np.concatenate([c[0] for c in due_parts])
                d_keys = np.concatenate([c[1] for c in due_parts])
                d_sids = np.concatenate([c[2] for c in due_parts])
            else:
                d_ends, d_keys, d_sids = due_parts[0]
            order = np.argsort(d_ends, kind="stable")  # heap pop order
            d_ends, d_keys, d_sids = (d_ends[order], d_keys[order],
                                      d_sids[order])
        else:
            d_ends = d_keys = d_sids = np.empty(0, dtype=np.int64)
        self.max_fired_watermark = max(self.max_fired_watermark, watermark)
        if not len(d_ends):
            return self._EMPTY_POP

        slots = self._idx.lookup(d_keys, d_keys)
        sing = slots >= 0
        valid = sing.copy()
        if sing.any():
            vs = slots[sing]
            valid[sing] = ((self._s_sid[vs] == d_sids[sing])
                           & (self._s_end[vs] == d_ends[sing]))
        out_keys = d_keys[valid]
        out_starts = self._s_start[slots[valid]]
        out_ends = d_ends[valid]
        out_sids = d_sids[valid]
        if valid.any():
            # the pair columns are in hand (key == ns for the meta
            # index) — skip free_slots' per-slot metadata gathers
            self._idx.free_slots(slots[valid].astype(np.int32),
                                 keys=out_keys, nss=out_keys)

        rest = np.nonzero(~sing)[0]
        if self._multi and len(rest):
            ek, es, ee, esid, _ = self._pop_rest_walk(
                d_keys[rest], d_sids[rest], d_ends[rest])
            if ek:
                out_keys = np.concatenate([
                    out_keys, np.asarray(ek, dtype=np.int64)])
                out_starts = np.concatenate([
                    out_starts, np.asarray(es, dtype=np.int64)])
                out_ends = np.concatenate([
                    out_ends, np.asarray(ee, dtype=np.int64)])
                out_sids = np.concatenate([
                    out_sids, np.asarray(esid, dtype=np.int64)])
                o = np.argsort(out_ends, kind="stable")
                out_keys, out_starts = out_keys[o], out_starts[o]
                out_ends, out_sids = out_ends[o], out_sids[o]
        return (out_keys, np.asarray(out_starts, dtype=np.int64),
                out_ends, out_sids)

    def _pop_rest_walk(self, rk, rs, re_):
        """Validate REST candidates — keys absent from the singles
        store at cut time — against the multi-interval lists; the ONE
        copy of the reference-shaped walk both planes run (the native
        plane only swaps the scalar store accessors via the two hooks
        below). Returns columnar extras ``(keys, starts, ends, sids,
        slots)`` — slots are the folded device slots where known."""
        ek: List[int] = []
        es: List[int] = []
        ee: List[int] = []
        esid: List[int] = []
        eslot: List[int] = []
        for j in range(len(rk)):
            key = int(rk[j])
            sid, end = int(rs[j]), int(re_[j])
            ivs = self._multi.get(key)
            if not ivs:
                # the key may have demoted to the single store earlier
                # in THIS pop (a sibling session fired and left exactly
                # one) — validate there
                slot = self._rest_single_lookup(key)
                if (slot >= 0 and self._s_sid[slot] == sid
                        and self._s_end[slot] == end):
                    ek.append(key)
                    es.append(int(self._s_start[slot]))
                    ee.append(end)
                    esid.append(sid)
                    eslot.append(self._rest_single_free(slot))
                continue
            cur = next((iv for iv in ivs if iv[2] == sid), None)
            if cur is None or cur[1] != end:
                continue
            ek.append(key)
            es.append(cur[0])
            ee.append(end)
            esid.append(sid)
            eslot.append(-1)
            ivs.remove(cur)
            if len(ivs) == 1:
                del self._multi[key]
                self._store_intervals(key, ivs)
        return ek, es, ee, esid, eslot

    def _rest_single_lookup(self, key: int) -> int:
        """Store row of ``key`` in the singles store, -1 if absent."""
        a = np.asarray([key], dtype=np.int64)
        return int(self._idx.lookup(a, a)[0])

    def _rest_single_free(self, slot: int) -> int:
        """Free a validated demoted-single row; returns its folded
        device slot (-1 on this plane — it does not fold)."""
        self._idx.free_slots(np.asarray([slot], dtype=np.int32))
        return -1

    # -------------------------------------------------------------- snapshot

    def snapshot(self) -> Dict[str, object]:
        return {
            "sessions": {k: list(v) for k, v in self.sessions.items()},
            "next_sid": self._next_sid,
            "max_fired_watermark": self.max_fired_watermark,
        }

    # ------------------------------------------------- partial failover

    def _forget_multi_key(self, key: int) -> None:
        """Remove a key's multi-interval entry (the native plane also
        un-mirrors its membership set)."""
        self._multi.pop(key, None)

    def drop_key_groups(self, groups, max_parallelism: int = 128) -> int:
        """Remove every session whose key falls in ``groups`` — a lost
        shard's metadata dies with its device state. The fire candidates
        of the dropped sessions become stale and are skipped by pop
        validation (as merged or extended sessions already are). Returns
        sessions dropped."""
        from flink_tpu_torch.state.keygroups import assign_key_groups

        gset = np.asarray(sorted(groups), dtype=np.int64)
        dropped = 0
        used = self._idx.used_slots()
        if len(used):
            keys = np.asarray(self._idx.slot_key[used], dtype=np.int64)
            hit = np.isin(assign_key_groups(keys, max_parallelism), gset)
            if hit.any():
                self._idx.free_slots(used[hit].astype(np.int32),
                                     keys=keys[hit], nss=keys[hit])
                dropped += int(hit.sum())
        if self._multi:
            mkeys = np.asarray(list(self._multi), dtype=np.int64)
            mhit = np.isin(assign_key_groups(mkeys, max_parallelism), gset)
            for k in mkeys[mhit].tolist():
                dropped += len(self._multi[int(k)])
                self._forget_multi_key(int(k))
        return dropped

    def merge_restore(self, snap: Dict[str, object], key_group_filter,
                      max_parallelism: int = 128) -> int:
        """Partial-failover merge: fold a checkpoint's sessions of the key
        groups ``key_group_filter`` into the LIVE set (the survivors' keys
        never fall in them). ``next_sid`` takes the max (sids stay
        globally unique); ``max_fired_watermark`` rolls back to the
        checkpoint's so the replayed range's records are not judged stale
        — it advances again as replay feeds the original watermarks.
        Returns sessions restored."""
        from flink_tpu_torch.state.keygroups import assign_key_groups

        sessions = snap.get("sessions", {})
        restored = 0
        if sessions:
            keys = np.asarray([int(k) for k in sessions], dtype=np.int64)
            keep = np.isin(
                assign_key_groups(keys, max_parallelism),
                np.asarray(sorted(key_group_filter), dtype=np.int64))
            for k, ok in zip(sessions, keep):
                if not ok:
                    continue
                kept = [tuple(iv) for iv in sessions[k]]
                self._store_intervals(int(k), kept)
                restored += len(kept)
                for start, end, sid in kept:
                    self._push_fire(int(end), int(k), int(sid))
        self._drain_fire_buf()
        self._next_sid = max(self._next_sid, int(snap.get("next_sid", 1)))
        self.max_fired_watermark = min(
            self.max_fired_watermark,
            snap.get("max_fired_watermark", _NEG_INF))
        return restored

    @staticmethod
    def filter_snapshot(snap: Dict[str, object], groups,
                        max_parallelism: int = 128) -> Dict[str, object]:
        """A metadata snapshot restricted to the key groups ``groups``;
        the scalar fields ride along whole."""
        from flink_tpu_torch.state.keygroups import assign_key_groups

        sessions = snap.get("sessions", {})
        if sessions:
            keys = np.asarray([int(k) for k in sessions], dtype=np.int64)
            kg = assign_key_groups(keys, max_parallelism)
            keep = np.isin(kg, np.asarray(sorted(groups), dtype=np.int64))
            sessions = {int(k): list(sessions[k])
                        for k, ok in zip(sessions, keep) if ok}
        return {
            "sessions": sessions,
            "next_sid": snap.get("next_sid", 1),
            "max_fired_watermark": snap.get("max_fired_watermark",
                                            _NEG_INF),
        }

    def restore(self, snap: Dict[str, object],
                key_group_filter=None, max_parallelism: int = 128) -> None:
        """Rebuild the interval set from :meth:`snapshot` (a checkpoint's,
        or a native plane's live sessions handed over after a
        ``NativePlaneError``), keeping only the keys in the key groups
        ``key_group_filter`` when given."""
        self._reset_store()
        self._fire_chunks = []
        self._fire_buf = ([], [], [])
        self._min_pending_end = 1 << 62
        sk, ss, se, ssid = [], [], [], []
        for k, ivs in snap.get("sessions", {}).items():
            kept = [tuple(iv) for iv in ivs]
            if key_group_filter is not None:
                from flink_tpu_torch.state.keygroups import assign_key_groups

                g = int(assign_key_groups(np.array([k]),
                                          max_parallelism)[0])
                if g not in key_group_filter:
                    continue
            if len(kept) == 1:
                s, e, sid = kept[0]
                sk.append(int(k))
                ss.append(int(s))
                se.append(int(e))
                ssid.append(int(sid))
            else:
                self._multi[int(k)] = sorted(kept)
                for start, end, sid in kept:
                    self._push_fire(end, int(k), sid)
        if sk:
            keys = np.asarray(sk, dtype=np.int64)
            slots = self._idx.lookup_or_insert(keys, keys)
            self._s_start[slots] = ss
            self._s_end[slots] = se
            self._s_sid[slots] = ssid
            self._push_fires(np.asarray(se, dtype=np.int64), keys,
                             np.asarray(ssid, dtype=np.int64))
        self._next_sid = snap.get("next_sid", 1)
        self.max_fired_watermark = snap.get("max_fired_watermark", _NEG_INF)


def make_session_meta(gap: int,
                      allowed_lateness: int = 0) -> SessionIntervalSet:
    """The native metadata plane (``native/sessions.cpp``) when its library
    builds, else the pure-Python plane — bit-identical fires and
    snapshots. A fallback is LOUD: a warning per distinct reason and the
    ``flink_tpu_torch.native.native_fallbacks()`` counter."""
    from flink_tpu_torch.native import load_sessions, note_fallback

    if load_sessions() is None:
        note_fallback("native sessions library unavailable (build failed "
                      "or no toolchain) — using the bit-identical Python "
                      "plane")
        return SessionIntervalSet(gap, allowed_lateness)
    from flink_tpu_torch.windowing.session_native import (
        NativeSessionIntervalSet,
    )

    return NativeSessionIntervalSet(gap, allowed_lateness)
