"""Paged (cohort-granular) spill bookkeeping (port of
``flink_tpu/state/paged_spill.py``, host code with the same behaviour).

The paged layout (``spill_layout="pages"``) serves session-shaped state:
one row per namespace, millions of namespaces. The unit of movement is an
EVICTION COHORT — the coldest rows of the device table, however many
sessions they span — stored as one page entry carrying its own ``ns``
column (RocksDB's block granularity: state moves in blocks, not records).

This module owns the host bookkeeping of a paged table:

- the (namespace -> page, row) membership map as lazily sorted parallel
  arrays, binary-searched per batch;
- LAZY TOMBSTONES: a reload takes exactly the requested rows out of their
  pages by row index and unmaps them; the pages' other rows are not
  rewritten. A row is live iff the map holds it; stale copies left in a
  page are skipped by every reader through the same map;
- THRESHOLD COMPACTION: once a page's dead fraction passes
  ``compact_dead_fraction`` the page is rewritten with its live rows only
  (``rows_compacted``); a page whose rows all died is dropped unread;
- the spill traffic counters (pages and rows evicted and reloaded, rows
  split on reload, rows compacted).

The device moves (gather and reset on eviction, put on reload) stay with
the owning table (``state/slot_table.py``). ``restore_into_pages`` packs a
restored snapshot into pages, so a snapshot larger than the device budget
restores with bounded device memory. The reference's fault points sit at
its sites: ``spill.page_compact`` (a recoverable fault defers the
compaction) and ``spill.page_reload`` (retried in place through
``chaos.run_recoverable``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.chaos import injection as chaos

COUNTER_NAMES = ("pages_evicted", "pages_reloaded", "rows_evicted",
                 "rows_reloaded", "rows_split_on_reload", "rows_compacted")


def sorted_match(sorted_vals: np.ndarray, queries: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Membership probe against a sorted array: ``(mask, pos)`` where
    ``mask[i]`` says ``queries[i]`` occurs in ``sorted_vals`` and
    ``pos[i]`` is its (clamped) index — positions are only meaningful
    where ``mask`` holds. The one implementation of the
    searchsorted-clamp-compare idiom every membership check here uses."""
    queries = np.asarray(queries)
    if not len(sorted_vals):
        return (np.zeros(len(queries), dtype=bool),
                np.zeros(len(queries), dtype=np.int64))
    pos = np.minimum(np.searchsorted(sorted_vals, queries),
                     len(sorted_vals) - 1)
    return sorted_vals[pos] == queries, pos

#: rewrite a page once more than this fraction of its rows are dead
#: (0.5: a page is compacted at most O(log rows) times over its life,
#: so compaction traffic is amortized-constant per row — the same
#: geometric argument as LSM compaction fan-out)
COMPACT_DEAD_FRACTION = 0.5


class PagedSpillMap:
    """Membership + lifecycle bookkeeping for one paged spill tier."""

    def __init__(self,
                 compact_dead_fraction: float = COMPACT_DEAD_FRACTION
                 ) -> None:
        #: spilled (ns -> page, row-within-page) mapping as parallel
        #: arrays; kept sorted by ns lazily (evictions append, reloads
        #: tombstone). ``sp_row`` is stable: pages are immutable once
        #: written — compaction assigns fresh row indexes.
        self.sp_ns = np.empty(0, dtype=np.int64)
        self.sp_page = np.empty(0, dtype=np.int64)
        self.sp_row = np.empty(0, dtype=np.int64)
        #: map-entry tombstones: an unmap only FLAGS its entries dead
        #: (O(extracted)); dead entries purge in bulk at the next
        #: sort()/compress cycle. Compressing the parallel arrays on
        #: every unmap cost three O(map) copies per extraction round —
        #: at the session-thrashing shape that was the single largest
        #: spill-bookkeeping term.
        self.sp_dead = np.empty(0, dtype=bool)
        self._dead_count = 0
        self.sorted = True
        self.compact_dead_fraction = float(compact_dead_fraction)
        #: latency tier: when set, the fire-path extraction QUEUES its
        #: touched pages here instead of sweeping (reap/compact) them
        #: inline — space reclamation is time-insensitive, so the owner
        #: drains the queue on its next ingest step
        #: (run_deferred_sweeps) and the fire span stays a bounded
        #: delta instead of absorbing compaction bursts
        self.defer_sweeps = False
        self.deferred_pages: set = set()
        #: per-page physical row count (as stored) and live row count
        #: (still mapped); dead fraction = 1 - live/rows
        self.page_rows: Dict[int, int] = {}
        self.page_live: Dict[int, int] = {}
        self.next_page = 1
        self.pages_evicted = 0
        self.pages_reloaded = 0
        self.rows_evicted = 0
        self.rows_reloaded = 0
        self.rows_split_on_reload = 0
        self.rows_compacted = 0

    def __len__(self) -> int:
        return len(self.sp_ns) - self._dead_count

    def counters(self) -> Dict[str, int]:
        return {name: int(getattr(self, name)) for name in COUNTER_NAMES}

    @staticmethod
    def zero_counters() -> Dict[str, int]:
        return {name: 0 for name in COUNTER_NAMES}

    # ------------------------------------------------------------ membership

    def _compress(self, keep: np.ndarray) -> None:
        self.sp_ns = self.sp_ns[keep]
        self.sp_page = self.sp_page[keep]
        self.sp_row = self.sp_row[keep]
        self.sp_dead = self.sp_dead[keep]
        self._dead_count = int(self.sp_dead.sum())

    def sort(self) -> None:
        """Settle the map for reads: purge dead entries when appends
        arrived (the at-most-one-entry-per-ns invariant the searchsorted
        probes rely on) or when tombstones dominate, then re-sort."""
        if not self.sorted:
            if self._dead_count:
                self._compress(~self.sp_dead)
            o = np.argsort(self.sp_ns, kind="stable")
            self.sp_ns = self.sp_ns[o]
            self.sp_page = self.sp_page[o]
            self.sp_row = self.sp_row[o]
            self.sp_dead = self.sp_dead[o]
            self.sorted = True
        elif self._dead_count * 2 > len(self.sp_ns):
            # bound tombstone memory; a mask compress keeps sort order
            self._compress(~self.sp_dead)

    def spilled_mask(self, nss: np.ndarray) -> np.ndarray:
        """Vectorized membership: which of ``nss`` are spilled."""
        self.sort()
        mask, pos = sorted_match(self.sp_ns, nss)
        if self._dead_count:
            mask &= ~self.sp_dead[pos]
        return mask

    def positions_for(self, nss: np.ndarray) -> np.ndarray:
        """Map-array positions of the spilled members of ``nss``."""
        self.sort()
        mask, pos = sorted_match(
            self.sp_ns, np.unique(np.asarray(nss, dtype=np.int64)))
        if self._dead_count:
            mask &= ~self.sp_dead[pos]
        return pos[mask]

    def page_of(self, ns: int) -> Optional[int]:
        """The page holding ``ns``, or None (read-only point probe)."""
        if not len(self.sp_ns):
            return None
        self.sort()
        p = int(np.searchsorted(self.sp_ns, int(ns)))
        if p >= len(self.sp_ns) or int(self.sp_ns[p]) != int(ns) \
                or bool(self.sp_dead[p]):
            return None
        return int(self.sp_page[p])

    def live_ns(self) -> np.ndarray:
        """The live (non-tombstoned) spilled namespaces — the listing
        external readers use instead of the raw ``sp_ns`` array."""
        self.sort()
        if self._dead_count:
            return self.sp_ns[~self.sp_dead]
        return self.sp_ns

    def live_row_mask(self, page: int, rns: np.ndarray) -> np.ndarray:
        """Which rows of a stored page entry are still live: a row is
        live iff its namespace is still mapped to THIS page (reloaded
        and freed rows are tombstones — physically present, logically
        gone). Readers (snapshots, queries) filter through this."""
        rns = np.asarray(rns, dtype=np.int64)
        self.sort()
        # re-check AFTER sort: a fully-tombstoned map compresses to
        # empty there (common with deferred fire-path sweeps)
        if not len(self.sp_ns):
            return np.zeros(len(rns), dtype=bool)
        mask, pos = sorted_match(self.sp_ns, rns)
        if self._dead_count:
            mask &= ~self.sp_dead[pos]
        return mask & (self.sp_page[pos] == int(page))

    def record(self, nss: np.ndarray, page: int) -> None:
        n = len(nss)
        self.sp_ns = np.concatenate([self.sp_ns, nss])
        self.sp_page = np.concatenate([
            self.sp_page, np.full(n, page, dtype=np.int64)])
        self.sp_row = np.concatenate([
            self.sp_row, np.arange(n, dtype=np.int64)])
        self.sp_dead = np.concatenate([
            self.sp_dead, np.zeros(n, dtype=bool)])
        self.page_rows[int(page)] = n
        self.page_live[int(page)] = n
        self.sorted = False

    def unmap_positions(self, pos: np.ndarray) -> List[int]:
        """Tombstone the map entries at ``pos``; returns the distinct
        pages they lived in (candidates for reap/compact). O(len(pos)):
        the arrays are not compressed here — dead entries purge in bulk
        at the next sort cycle."""
        if not len(pos):
            return []
        pages, counts = np.unique(self.sp_page[pos], return_counts=True)
        for page, c in zip(pages.tolist(), counts.tolist()):
            self.page_live[page] = self.page_live.get(page, c) - c
        self.sp_dead[pos] = True
        self._dead_count += len(pos)
        return pages.tolist()

    def remove_pages(self, pages: np.ndarray) -> None:
        self._compress(~np.isin(self.sp_page, pages))
        for page in np.asarray(pages).tolist():
            self.page_rows.pop(int(page), None)
            self.page_live.pop(int(page), None)

    def clear(self) -> None:
        self.sp_ns = np.empty(0, dtype=np.int64)
        self.sp_page = np.empty(0, dtype=np.int64)
        self.sp_row = np.empty(0, dtype=np.int64)
        self.sp_dead = np.empty(0, dtype=bool)
        self._dead_count = 0
        self.sorted = True
        self.page_rows.clear()
        self.page_live.clear()


def spill_page(spill, pmap: PagedSpillMap, entry: Dict[str, np.ndarray],
               count: bool = True) -> int:
    """Store one eviction cohort as a page entry; returns the page id.

    ``entry`` carries ``key_id`` / ``ns`` / ``dirty`` / ``leaf_i``
    columns. ``count=False`` for internal rewrites and restore, which
    are not evictions.
    """
    page = pmap.next_page
    pmap.next_page += 1
    spill.put(page, entry, dirty=bool(entry["dirty"].any()))
    pmap.record(np.asarray(entry["ns"], dtype=np.int64), page)
    if count:
        pmap.pages_evicted += 1
        pmap.rows_evicted += len(entry["ns"])
    return page


def _sweep_pages(spill, pmap: PagedSpillMap, pages: Sequence[int]) -> None:
    """Reclaim dead space in the touched pages: a fully-dead page drops
    outright; a page whose dead fraction crossed the threshold is
    rewritten with only its live rows (``rows_compacted``). Everything
    else keeps its tombstones — no read-path rewrites (the RocksDB
    compaction discipline)."""
    for page in pages:
        page = int(page)
        total = pmap.page_rows.get(page)
        if total is None:
            continue
        live = pmap.page_live.get(page, 0)
        if live <= 0:
            # delete without load: a fully-dead fs page is unlinked,
            # not read back just to be thrown away
            spill.discard(page)
            pmap.page_rows.pop(page, None)
            pmap.page_live.pop(page, None)
            continue
        if (total - live) / total <= pmap.compact_dead_fraction:
            continue
        _compact_page(spill, pmap, page)


def _compact_page(spill, pmap: PagedSpillMap, page: int) -> None:
    """Rewrite one page with only its live rows; remaps its membership
    entries to the fresh page in place."""
    if chaos.armed():
        # a failed compaction is SAFE to skip: tombstones stay valid and
        # the page re-qualifies next sweep (a lost compaction costs
        # space, never correctness). Only a recoverable injected fault
        # defers; a hard one crashes here, BEFORE the pop, so no page is
        # half-moved.
        try:
            chaos.fault_point("spill.page_compact", page=page)
        except chaos.InjectedFault as f:
            if f.recoverable:
                c = chaos.controller()
                if c is not None:
                    c.note_recovery()
                return
            raise
    entry = spill.pop(page)
    pmap.page_rows.pop(page, None)
    pmap.page_live.pop(page, None)
    if entry is None:
        return
    was_dirty = bool(entry.get("__was_dirty__", False))
    pos = np.nonzero((pmap.sp_page == page) & ~pmap.sp_dead)[0]
    if not len(pos):
        return
    old_rows = pmap.sp_row[pos]
    order = np.argsort(old_rows)  # preserve storage order
    pos, old_rows = pos[order], old_rows[order]
    new_entry = {
        k: np.asarray(v)[old_rows] for k, v in entry.items()
        if k != "__was_dirty__"
    }
    if not was_dirty:
        # the tier-level flag was cleared by a snapshot since this page
        # spilled, so its rows HAVE been shipped — carrying the stale
        # per-row dirty column forward would re-ship the unchanged rows
        # in every later delta
        new_entry["dirty"] = np.zeros(len(old_rows), dtype=bool)
    new_page = pmap.next_page
    pmap.next_page += 1
    spill.put(new_page, new_entry,
              dirty=was_dirty and bool(new_entry["dirty"].any()))
    n = len(pos)
    pmap.sp_page[pos] = new_page
    pmap.sp_row[pos] = np.arange(n, dtype=np.int64)
    pmap.page_rows[new_page] = n
    pmap.page_live[new_page] = n
    pmap.rows_compacted += n


def _peek_page(spill, page: int):
    """One page read on the reload path. Under chaos, a transient
    injected reload failure retries with backoff in place; a persistent
    one propagates as the engine crash it would be."""
    if not chaos.armed():
        return spill.peek(page)

    def attempt():
        chaos.fault_point("spill.page_reload", page=page)
        return spill.peek(page)

    return chaos.run_recoverable("spill.page_reload", attempt)


def read_spilled_rows(spill, pmap: Optional[PagedSpillMap], paged: bool,
                      wants, on_row) -> None:
    """Serving-path cold read: resolve ``wants`` — an iterable of
    ``(tag, key_id, ns)`` — against the tier, grouping by tier entry so
    each page is peeked (and, for the fs tier, loaded from disk) ONCE
    per batch, however many of the batch's rows it holds. Calls
    ``on_row(tag, entry, src_row)`` for each row found. Read-only: no
    residency change, no membership mutation. The ONE copy of the
    miss-scan for both spill layouts: the point queries (ROADMAP.md Queue
    A item 12e) and the mesh session engine read through it."""
    by_entry: Dict[int, list] = {}
    for tag, key_id, ns in wants:
        ek = (pmap.page_of(int(ns)) if paged
              else (int(ns) if int(ns) in spill else None))
        if ek is not None:
            by_entry.setdefault(int(ek), []).append(
                (tag, int(key_id), int(ns)))
    for ek, rows in by_entry.items():
        entry = spill.peek(ek)
        if entry is None:
            continue
        entry_keys = np.asarray(entry["key_id"], dtype=np.int64)
        entry_ns = (np.asarray(entry["ns"], dtype=np.int64)
                    if paged else None)
        for tag, key_id, ns in rows:
            if paged:
                pos = np.nonzero((entry_keys == key_id)
                                 & (entry_ns == ns))[0]
            else:
                pos = np.nonzero(entry_keys == key_id)[0]
            if len(pos):
                on_row(tag, entry, int(pos[0]))


def spilled_rows(spill, pmap: Optional[PagedSpillMap], leaves,
                 dirty_only: bool = False
                 ) -> Tuple[List[np.ndarray], List[np.ndarray],
                            List[List[np.ndarray]]]:
    """The spill tier's part of a snapshot: (key_id chunks, namespace
    chunks, per-leaf chunks), one chunk per entry in the tier's order, for
    the caller to concatenate after its device rows. A paged entry carries
    its own ``ns`` column and only rows still mapped to the page are state
    (lazy tombstones); ``dirty_only`` (a delta) keeps the dirty entries'
    dirty AND live rows — a tombstoned row is resident again (its device
    copy travels) or freed. The ONE copy for ``SlotTable`` and the mesh
    engines (one call per shard)."""
    key_chunks: List[np.ndarray] = []
    ns_chunks: List[np.ndarray] = []
    leaf_chunks: List[List[np.ndarray]] = [[] for _ in leaves]
    names = spill.dirty_namespaces() if dirty_only else spill.namespaces
    for pid_or_ns in names:
        entry = spill.peek(int(pid_or_ns))
        if entry is None:
            continue
        keys = np.asarray(entry["key_id"], dtype=np.int64)
        if "ns" in entry:
            rns = np.asarray(entry["ns"], dtype=np.int64)
            sel = pmap.live_row_mask(int(pid_or_ns), rns)
            if dirty_only:
                sel &= np.asarray(entry["dirty"], dtype=bool)
            keys, rns = keys[sel], rns[sel]
        else:
            sel = slice(None)
            rns = np.full(len(keys), int(pid_or_ns), dtype=np.int64)
        key_chunks.append(keys)
        ns_chunks.append(rns)
        for i, l in enumerate(leaves):
            leaf_chunks[i].append(
                np.asarray(entry[f"leaf_{i}"], dtype=l.dtype)[sel])
    return key_chunks, ns_chunks, leaf_chunks


def reload_rows_for(spill, pmap: PagedSpillMap, nss: np.ndarray,
                    leaf_dtypes: Sequence) -> Optional[
                        Tuple[np.ndarray, np.ndarray, np.ndarray,
                              List[np.ndarray]]]:
    """Extract the REQUESTED rows (and only them) from their pages;
    return ``(keys, rns, dirty, leaf_values)`` for the caller's device
    put, or None when nothing relevant was spilled.

    Amplification-free: each touched page is read once and the rows are
    pulled by stored row index (one ``take`` per page); the pages'
    other rows stay exactly where they are, and the reloaded rows
    become lazy tombstones (unmapped, physically still in the page).
    Space comes back when a page's dead fraction crosses the compaction
    threshold — never by rewriting cohort remainders on the reload
    path, which cost ~16x the reloaded rows in pure host repacking at
    the session-thrashing shape."""
    nss = np.asarray(nss, dtype=np.int64)
    pos = pmap.positions_for(nss)
    if not len(pos):
        return None
    hit_pages = pmap.sp_page[pos]
    hit_rows = pmap.sp_row[pos]
    order = np.argsort(hit_pages, kind="stable")
    hit_pages, hit_rows = hit_pages[order], hit_rows[order]
    bounds = np.nonzero(np.diff(hit_pages))[0] + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [len(hit_pages)]))
    key_chunks, ns_chunks, dirty_chunks = [], [], []
    leaf_chunks: List[List[np.ndarray]] = [[] for _ in leaf_dtypes]
    pages_read = 0
    for a, b in zip(starts.tolist(), ends.tolist()):
        page = int(hit_pages[a])
        entry = _peek_page(spill, page)
        if entry is None:
            continue
        pages_read += 1
        rows = hit_rows[a:b]
        key_chunks.append(
            np.asarray(entry["key_id"], dtype=np.int64)[rows])
        ns_chunks.append(np.asarray(entry["ns"], dtype=np.int64)[rows])
        dirty_chunks.append(
            np.asarray(entry["dirty"], dtype=bool)[rows])
        for i, dt in enumerate(leaf_dtypes):
            leaf_chunks[i].append(
                np.asarray(entry[f"leaf_{i}"], dtype=dt)[rows])
    touched = pmap.unmap_positions(pos)
    if pmap.defer_sweeps:
        pmap.deferred_pages.update(touched)
    else:
        _sweep_pages(spill, pmap, touched)
    if not key_chunks:
        return None
    keys = np.concatenate(key_chunks)
    rns = np.concatenate(ns_chunks)
    dirty = np.concatenate(dirty_chunks)
    vals = [np.concatenate(c) for c in leaf_chunks]
    pmap.pages_reloaded += pages_read
    pmap.rows_reloaded += len(keys)
    return keys, rns, dirty, vals


def drop_spilled_sessions(spill, pmap: PagedSpillMap,
                          nss: np.ndarray) -> None:
    """Tombstone spilled sessions that were freed (rare: fires reload
    first); fully-dead pages are reaped and mostly-dead pages compact,
    so their storage cannot leak for the rest of the run."""
    if not len(pmap.sp_ns):
        return
    pos = pmap.positions_for(np.asarray(nss, dtype=np.int64))
    if not len(pos):
        return
    touched = pmap.unmap_positions(pos)
    if pmap.defer_sweeps:
        pmap.deferred_pages.update(touched)
    else:
        _sweep_pages(spill, pmap, touched)


def run_deferred_sweeps(spill, pmap: PagedSpillMap) -> int:
    """Drain the pages queued by fire-path extractions under
    ``defer_sweeps`` — reap the fully-dead ones, compact the mostly-dead
    ones. Called by the owning engine on its INGEST step (and harmless
    to skip: tombstones stay valid, only space reclamation is delayed).
    Returns pages swept."""
    if not pmap.deferred_pages:
        return 0
    pages = sorted(pmap.deferred_pages)
    pmap.deferred_pages.clear()
    _sweep_pages(spill, pmap, pages)
    return len(pages)


def restore_into_pages(spill, pmap: PagedSpillMap, key_ids: np.ndarray,
                       namespaces: np.ndarray, leaves: List[np.ndarray],
                       page_rows: int,
                       dirty: Optional[np.ndarray] = None,
                       append: bool = False) -> None:
    """Pack restored logical rows into page-sized spill entries (sorted by
    ns, never splitting one namespace across pages): a snapshot far larger
    than the device budget restores with bounded device memory and reloads
    lazily by page. Clears any stale pages first (re-restore).

    ``dirty``: optional per-row dirtiness carried into the pages; a
    checkpoint restore passes None (restored state is the new incremental
    base). ``append=True`` keeps the tier's existing pages (the caller
    guarantees the appended namespaces are not mapped yet)."""
    if not append:
        if len(pmap.sp_ns):
            for page in np.unique(pmap.sp_page).tolist():
                spill.discard(int(page))
        pmap.clear()
    order = np.argsort(namespaces, kind="stable")
    s_ns = namespaces[order]
    s_keys = key_ids[order]
    s_leaves = [l[order] for l in leaves]
    s_dirty = (np.asarray(dirty, dtype=bool)[order]
               if dirty is not None else None)
    total = len(s_ns)
    a = 0
    while a < total:
        b = min(a + page_rows, total)
        while b < total and s_ns[b] == s_ns[b - 1]:
            b += 1
        entry = {"key_id": s_keys[a:b], "ns": s_ns[a:b],
                 "dirty": (s_dirty[a:b] if s_dirty is not None
                           else np.zeros(b - a, dtype=bool)),
                 **{f"leaf_{i}": s_leaves[i][a:b]
                    for i in range(len(s_leaves))}}
        spill_page(spill, pmap, entry, count=False)
        a = b
    if not append:
        # pages were appended in ascending-ns order: the map is sorted
        pmap.sorted = True
