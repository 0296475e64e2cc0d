"""Host-side hot-row cache over the serving plane (port of
``flink_tpu/tenancy/hot_cache.py``, the whole module; host code).

Fires and lookup harvests materialize exactly the HOT rows host-side;
this cache retains those composed per-key results keyed ``(job,
operator, key_id)`` and tagged with the replica GENERATION that
produced them. Invalidation is the generation tag itself: a publish
advances the generation, so the next probe of a stale entry misses
(and drops it) — no flush pass, no timer. Between publishes, repeat
lookups of hot keys never touch the device at all: the probe is one
dict access under one lock.

Capacity is bounded LRU (an ``OrderedDict``): a churning key space
evicts the coldest entries instead of growing per historical key.
The cached value is the composed result dict the operator's
``query_state_batch`` would return — callers treat it as immutable
(the serving plane hands the same object to concurrent riders).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.observe.lock_sentinel import named_lock


class PrimeDelta:
    """One publish boundary's cache delta, FLAT: the shape both cache
    planes consume (``prime_batch``), built once by the replica adapter
    from the publish harvest — the native plane packs it into a single
    GIL-released C call, the Python plane folds it under one lock.

    ``keys[i]``'s updates are rows ``uoff[i]:uoff[i+1]`` of ``u_ns`` /
    the ``u_cols`` value columns; its removals are ``roff[i]:roff[i+1]``
    of ``r_ns``. ``flags`` bit0 = insert_ok (the updates are the key's
    COMPLETE composed state — an absent entry may be created), bit1 =
    drop (the key's entry is removed outright — the invalidate-on-change
    path for compositions that cannot update incrementally)."""

    __slots__ = ("keys", "uoff", "u_ns", "u_cols", "roff", "r_ns",
                 "flags")

    def __init__(self, keys, uoff, u_ns, u_cols, roff, r_ns, flags):
        self.keys = keys
        self.uoff = uoff
        self.u_ns = u_ns
        #: [(column name, value array aligned with u_ns)]
        self.u_cols = u_cols
        self.roff = roff
        self.r_ns = r_ns
        self.flags = flags

    def __len__(self) -> int:
        return len(self.keys)


def make_hot_row_cache(max_entries: int = 1 << 18,
                       shm_dir: Optional[str] = None):
    """The native (C++) hot-row probe table when available, else this
    module's :class:`HotRowCache` — selected exactly the way
    ``make_session_meta`` picks the session-metadata plane. Lookup
    results are bit-identical across planes (test-pinned); the native
    plane probes/primes a whole key batch in ONE GIL-released C call.

    ``shm_dir`` arms the multi-process serving tier: the native tables
    allocate as MAP_SHARED file arenas under it (plus an attach
    manifest), so frontend processes probe the SAME table over shared
    memory (the frontends: ``tenancy/frontend.py``). The Python plane
    cannot shm-map — requesting ``shm_dir`` without the native plane
    raises rather than silently serving a frontendless cache.

    ``FLINK_TPU_NATIVE_HOTCACHE=0`` forces the Python plane while other
    native components stay on (the A/B knob; the blanket
    ``FLINK_TPU_NO_NATIVE=1`` forces it as well).
    Unavailability (no toolchain, build failure) degrades LOUDLY via
    ``flink_tpu_torch.native.note_fallback``."""
    import os

    from flink_tpu_torch.native import (
        hotcache_available,
        native_disabled,
        note_fallback,
    )

    if (os.environ.get("FLINK_TPU_NATIVE_HOTCACHE") != "0"
            and not native_disabled()):
        if hotcache_available():
            try:
                from flink_tpu_torch.tenancy.hot_cache_native import (
                    NativeHotRowCache,
                )

                return NativeHotRowCache(max_entries=max_entries,
                                         shm_dir=shm_dir)
            except Exception as e:  # noqa: BLE001 — degrade, loudly
                if shm_dir is not None:
                    raise
                note_fallback(
                    "native hot-row cache failed to initialize: "
                    f"{type(e).__name__}: {e}")
        else:
            note_fallback(
                "native hotcache library unavailable (build failed or "
                "no toolchain) — using the bit-identical Python cache")
    if shm_dir is not None:
        raise RuntimeError(
            "shm_dir (the multi-process serving tier) requires the "
            "native hotcache plane — it is disabled or unavailable "
            "here, and the Python cache cannot be shared-memory "
            "mapped by frontend processes")
    return HotRowCache(max_entries=max_entries)


class HotRowCache:
    """Generation-tagged LRU of composed lookup results."""

    def __init__(self, max_entries: int = 1 << 18) -> None:
        self.max_entries = int(max_entries)
        self._lock = named_lock("tenancy.hot_rows")
        self._entries: "OrderedDict[tuple, Tuple[int, Any]]" = \
            OrderedDict()
        #: counters read (under the lock) by the serving gauges
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.primes = 0

    def get(self, job: str, operator: str, key_id: int, gen: int,
            exact: bool = True) -> Tuple[bool, Any]:
        """(hit, value). ``exact=True``: only an entry tagged with the
        CURRENT generation hits; older tags are dropped (pure
        tag-invalidation — the mode when nothing re-primes entries).
        ``exact=False`` (the primed serving path): ANY entry hits —
        the publish harvest re-primes or drops every cached entry a
        boundary changed, so an entry's presence IS its validity (an
        unchanged key's value is by definition still its boundary
        value)."""
        k = (job, operator, key_id)
        with self._lock:
            ent = self._entries.get(k)
            if ent is not None and (not exact or ent[0] == gen):
                self._entries.move_to_end(k)
                self.hits += 1
                return True, ent[1]
            if ent is not None:
                del self._entries[k]
            self.misses += 1
            return False, None

    def get_many(self, job: str, operator: str, key_ids, gen: int,
                 out: list, misses: list, exact: bool = True) -> int:
        """Batched probe under ONE lock acquisition: fills ``out[i]``
        for hits, appends ``(i, key_id)`` to ``misses`` otherwise;
        returns the hit count. The per-key locked ``get`` would spend
        more time on lock traffic than on the probes at cache-hit QPS
        (the serving hot loop). ``exact`` as in :meth:`get`."""
        if hasattr(key_ids, "tolist"):  # ndarray: bulk-convert once
            key_ids = key_ids.tolist()
        hits = 0
        with self._lock:
            entries = self._entries
            for i, kid in enumerate(key_ids):
                k = (job, operator, kid)
                ent = entries.get(k)
                if ent is not None and (not exact or ent[0] == gen):
                    entries.move_to_end(k)
                    out[i] = ent[1]
                    hits += 1
                    continue
                if ent is not None:
                    del entries[k]
                misses.append((i, kid))
            self.hits += hits
            self.misses += len(misses)
        return hits

    def put(self, job: str, operator: str, key_id: int, gen: int,
            value: Any) -> None:
        k = (job, operator, key_id)
        with self._lock:
            ent = self._entries.get(k)
            if ent is not None and ent[0] > gen:
                # no downgrade: a worker that resolved against an older
                # sealed generation must not overwrite a fresher prime
                # (the stale value would then be served "forever" — no
                # future prime touches a key that stops changing)
                return
            self._entries[k] = (gen, value)
            self._entries.move_to_end(k)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def prime(self, job: str, operator: str, key_id: int, gen: int,
              updates: Optional[dict] = None, remove=(),
              insert_ok: bool = False) -> None:
        """Publish-harvest feed: fold a boundary's changes into an
        EXISTING entry (copy-on-write — readers hold references to the
        old value dict) and retag it with the publishing generation.
        ``insert_ok=True`` means ``updates`` is the key's COMPLETE
        composed state (the adapter checked the delta covers every
        published row of the key), so an absent entry may be created —
        first-touch lookups of hot keys then hit without ever paying a
        device round trip. Otherwise keys nobody cached are skipped."""
        k = (job, operator, key_id)
        with self._lock:
            ent = self._entries.get(k)
            if ent is None and not insert_ok:
                return
            if ent is not None and ent[0] > gen:
                return
            val = dict(ent[1]) if ent is not None else {}
            for ns in remove:
                val.pop(ns, None)
            if updates:
                val.update(updates)
            self._entries[k] = (gen, val)
            self._entries.move_to_end(k)
            self.primes += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def put_many(self, job: str, operator: str, key_ids, gen: int,
                 values) -> None:
        """Worker miss-resolution feed: one :meth:`put` per key (the
        native plane replaces this with one packed C call; here the
        loop is the bit-identical reference)."""
        for kid, val in zip(key_ids, values):
            self.put(job, operator, int(kid), gen, val)

    def prime_batch(self, job: str, operator: str, gen: int,
                    delta: "PrimeDelta") -> None:
        """Fold one publish boundary's flat delta (:class:`PrimeDelta`)
        into the cache: per key, drops apply first, then updates/
        removals through :meth:`prime` — semantically the per-key feed
        the adapters used to drive, now built once as arrays so the
        native plane can consume the SAME delta in one C call."""
        uoff = delta.uoff
        roff = delta.roff
        u_ns = delta.u_ns
        r_ns = delta.r_ns
        cols = delta.u_cols or []
        for i, kid in enumerate(delta.keys):
            kid = int(kid)
            fl = int(delta.flags[i])
            if fl & 2:
                self.drop(job, operator, kid)
                continue
            ups: Optional[Dict[int, dict]] = None
            lo, hi = int(uoff[i]), int(uoff[i + 1])
            if hi > lo:
                ups = {int(u_ns[j]): {name: col[j].item()
                                      for name, col in cols}
                       for j in range(lo, hi)}
            rem: List[int] = [int(r_ns[j])
                              for j in range(int(roff[i]),
                                             int(roff[i + 1]))]
            self.prime(job, operator, kid, gen, ups, rem,
                       insert_ok=bool(fl & 1))

    def drop(self, job: str, operator: str, key_id: int) -> None:
        with self._lock:
            self._entries.pop((job, operator, key_id), None)

    def invalidate_job(self, job: str) -> None:
        """Drop a finished/unbound job's entries (the per-historical-job
        leak rule the coalescer pool already follows)."""
        with self._lock:
            for k in [k for k in self._entries if k[0] == job]:
                del self._entries[k]

    def invalidate_op(self, job: str, operator: str) -> None:
        """Drop one operator's entries — a replica REBUILD (restore/
        reshard/shard loss) may roll values back, and the rebuild's
        full republish only re-primes keys still present: entries for
        keys that vanished across the restore would otherwise serve
        stale forever."""
        with self._lock:
            for k in [k for k in self._entries
                      if k[0] == job and k[1] == operator]:
                del self._entries[k]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hot_row_hits": float(self.hits),
                "hot_row_misses": float(self.misses),
                "hot_row_evictions": float(self.evictions),
                "hot_row_entries": float(len(self._entries)),
                "hot_row_hit_rate": (self.hits / total) if total else 0.0,
            }
