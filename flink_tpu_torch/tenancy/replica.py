"""Read replica: double-buffered, boundary-published state (port of
``flink_tpu/tenancy/replica.py``).

Without a replica, every lookup batch gathers from the LIVE planes and
waits for the owning job's next batch boundary (the control-queue path of
``tenancy/serving.py``). The replica decouples readers from ingest:

- **Publish at boundaries.** At every watermark boundary the owning mesh
  engine publishes a bounded DELTA of the rows changed since the last
  publish: the changed ``(shard, slot)`` rows of the live ``[P, cap]``
  planes are copied into the next generation on the device, with no
  device-to-host copy on the publish itself. The steps are torch ops
  (``build_replica_steps``), shared through ``PROGRAM_CACHE`` under the
  ``replica-pub`` kind.
- **Snapshot isolation.** A sealed generation's tensors are NEVER written
  in place: a publish clones every leaf of the sealed generation, copies
  the delta rows of the live planes into the clones, and seals them with
  one reference swap. A reader resolves against the generation it
  grabbed, so it sees exactly the state at that generation's boundary.
  Padded publish lanes carry slot 0: copying live slot 0 over replica
  slot 0 is harmless because any slot whose value changed since the last
  publish is in the delta, so an unchanged slot's copy is a no-op by
  value.
- **One stream.** The live planes are updated in place by the next
  scatter. Every replica op — the publish's clone and copy on the task
  thread, the gathers on the serving workers' threads — is queued on the
  device's default stream, the one the ingest uses, so the publish's copy
  is ordered before the next scatter, and the caching allocator cannot
  hand a superseded generation's memory to new work while a gather
  queued on it is still to run. No side stream is used.
- **Index without copies in steady state.** Each generation carries a
  host index ``key_id -> {namespace -> (shard, slot, extra)}``.
  Value-only publishes reuse the sealed index object; structural
  publishes copy the outer dict and copy-on-write the touched keys.
- **Cold rows stay serveable.** A row the engine evicted flips to
  ``slot == COLD_SLOT`` at the next publish and lookups detour those keys
  to the owning task loop (``cold_fetch``), counted in
  ``cold_rows_served``.

The publish HARVEST (the delta rows' values for the hot-row cache) and
:meth:`ReplicaPlane.gather_rows` each pay one gather plus ONE
device-to-host copy per batch (``runtime/pending.harvest_to_host``).

The engines drive this through ``MeshSpillSupport.arm_replica`` /
``_publish_replica`` (``parallel/sharded_windower.py``), the joins'
``arm_side_replica`` and CEP's ``arm_match_replica``.
"""

from __future__ import annotations

import threading
import time
from itertools import repeat
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.ops.segment_ops import sticky_bucket, torch_dtype
from flink_tpu_torch.runtime.pending import harvest_to_host
from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE

#: index entry slot value for a row serving from the page tier
COLD_SLOT = -1


def build_replica_steps(mesh, dtypes: Tuple[str, ...]):
    """(publish_step, gather_step) for a replica plane of per-leaf
    ``[P, capacity]`` tensors with the given dtype layout, shared through
    ``PROGRAM_CACHE`` per (device, P, dtypes) — keyed on WHAT they
    compute, never on which job's replica runs them."""
    cache_key = (str(mesh.device), int(mesh.size), tuple(dtypes))
    return PROGRAM_CACHE.get_or_build(
        "replica-pub", cache_key, _build_replica_steps)


def _build_replica_steps():
    def publish_step(rep, live, slots):
        """rep/live: per-leaf ``[P, cap]``; slots: ``[P, D]`` int64.
        Returns FRESH tensors (the next generation): ``rep`` is the
        sealed generation readers resolve against and is never
        written."""
        rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
        out = []
        for r, a in zip(rep, live):
            nxt = r.clone()
            nxt[rows, slots] = a[rows, slots]
            out.append(nxt)
        return tuple(out)

    def gather_step(rep, slots):
        """slots: ``[P, G]`` -> per-leaf ``[P, G]`` replica values."""
        return tuple(r.gather(1, slots) for r in rep)

    return publish_step, gather_step


def _pairs(x) -> np.ndarray:
    """``[(key, ns), ...]`` or an ``[n, 2]`` array -> ``[n, 2]`` int64."""
    if isinstance(x, np.ndarray):
        return x.reshape(-1, 2).astype(np.int64, copy=False)
    return np.asarray(list(x), dtype=np.int64).reshape(-1, 2)


def _ids(x) -> np.ndarray:
    """A set or array of key ids -> sorted unique int64."""
    if isinstance(x, np.ndarray):
        return np.unique(x.astype(np.int64, copy=False))
    return np.unique(np.fromiter(x, dtype=np.int64, count=len(x)))


def _objects(values) -> np.ndarray:
    """Per-row payloads as a 1-D array an object plane can take (tuples
    stay whole: NumPy would unpack them as rows)."""
    if isinstance(values, np.ndarray) and values.dtype != object:
        return values
    out = np.empty(len(values), dtype=object)
    for j, v in enumerate(values):
        out[j] = v
    return out


class ReplicaIndex:
    """A sealed generation's index, ``key_id -> {namespace -> (shard,
    slot, extra)}``, held as arrays. The resident rows ARE the boundary's
    ``[P, capacity]`` slot metadata (``used``/``key``/``ns``, the
    adapters' per-row payloads in the object plane ``extra``), searched
    through their keys sorted once, on first use. Rows serving from the
    page tier sit in ``cold`` (``key -> {ns -> (shard, extra)}``: only
    evicted rows, so small). ``hidden`` (or None) masks resident rows the
    index does not serve — a split key's partial rows, whose main rows
    sit in ``cold`` — while ``used`` stays the publish diff's shadow.
    Never mutated once sealed."""

    __slots__ = ("used", "key", "ns", "extra", "cold", "hidden", "_by_key",
                 "_lock")

    def __init__(self, used, key, ns, extra, cold, hidden=None) -> None:
        self.used = used
        self.key = key
        self.ns = ns
        self.extra = extra
        self.cold = cold
        self.hidden = hidden
        self._by_key = None
        self._lock = threading.Lock()

    @classmethod
    def empty(cls, P: int, capacity: int) -> "ReplicaIndex":
        z = np.zeros((P, capacity), dtype=np.int64)
        return cls(np.zeros((P, capacity), dtype=bool), z, z, None, {})

    def _sorted(self):
        """(keys of the resident rows sorted, their flat slot positions)."""
        s = self._by_key
        if s is None:
            with self._lock:
                s = self._by_key
                if s is None:
                    flat = np.flatnonzero(
                        self.used if self.hidden is None
                        else self.used & ~self.hidden)
                    keys = self.key.ravel()[flat]
                    order = np.argsort(keys)
                    s = self._by_key = (keys[order], flat[order])
        return s

    def resident(self, key_ids):
        """Every resident entry of ``key_ids``: ``(row, shard, slot, ns,
        extra)`` arrays, ``row`` the position in ``key_ids`` (``extra``
        None when the adapter has no payloads)."""
        sk, pos = self._sorted()
        kid = np.asarray(key_ids, dtype=np.int64)
        lo = np.searchsorted(sk, kid, "left")
        cnt = np.searchsorted(sk, kid, "right") - lo
        row = np.repeat(np.arange(len(kid)), cnt)
        first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
        flat = pos[first + np.arange(len(row))]
        shard, slot = np.divmod(flat, max(self.used.shape[1], 1))
        extra = self.extra.ravel()[flat] if self.extra is not None else None
        return row, shard, slot, self.ns.ravel()[flat], extra

    def count(self, key_ids) -> np.ndarray:
        """Entries (resident and cold) per key."""
        sk, _ = self._sorted()
        kid = np.asarray(key_ids, dtype=np.int64)
        n = np.searchsorted(sk, kid, "right") - np.searchsorted(sk, kid,
                                                                "left")
        if self.cold:
            n = n + np.fromiter((len(self.cold.get(int(k), ()))
                                 for k in kid), dtype=np.int64,
                                count=len(kid))
        return n

    def find(self, keys, nss):
        """Each ``(keys[i], nss[i])`` pair's entry: ``(found, shard, slot,
        extra)``, ``extra`` a list (``slot == COLD_SLOT``: page tier)."""
        keys = np.asarray(keys, dtype=np.int64)
        nss = np.asarray(nss, dtype=np.int64)
        n = len(keys)
        found = np.zeros(n, dtype=bool)
        shard = np.zeros(n, dtype=np.int64)
        slot = np.zeros(n, dtype=np.int64)
        extra: List[Any] = [None] * n
        if not n:
            return found, shard, slot, extra
        row, sh, sl, ns, ex = self.resident(keys)
        hit = ns == nss[row]
        at = row[hit]
        found[at], shard[at], slot[at] = True, sh[hit], sl[hit]
        if ex is not None:
            for j, e in zip(at.tolist(), ex[hit].tolist()):
                extra[j] = e
        if self.cold:
            for j in np.flatnonzero(~found).tolist():
                ent = self.cold.get(int(keys[j]), {}).get(int(nss[j]))
                if ent is not None:
                    found[j], shard[j], slot[j] = True, ent[0], COLD_SLOT
                    extra[j] = ent[1]
        return found, shard, slot, extra

    def get(self, key: int, default=None):
        """One key's ``{ns -> (shard, slot, extra)}`` (None if absent)."""
        row, sh, sl, ns, ex = self.resident([key])
        out = {int(n): (int(p), int(s), None if ex is None else ex[j])
               for j, (p, s, n) in enumerate(zip(sh, sl, ns))}
        for n, (p, e) in self.cold.get(int(key), {}).items():
            out[n] = (p, COLD_SLOT, e)
        return out or default

    def __getitem__(self, key: int):
        out = self.get(key)
        if out is None:
            raise KeyError(key)
        return out

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None


class ReplicaGeneration:
    """One sealed, immutable snapshot view. ``accs`` are the replica's
    tensors (never written after seal), ``index`` the
    :class:`ReplicaIndex` (``slot == COLD_SLOT`` serves from the page
    tier; ``extra`` is the owning adapter's per-row payload: session end,
    join ``(ts, host cols)``)."""

    __slots__ = ("gen", "boundary_wm", "published_at", "accs", "index",
                 "num_shards")

    def __init__(self, gen: int, boundary_wm: int, published_at: float,
                 accs, index: ReplicaIndex, num_shards: int) -> None:
        self.gen = gen
        self.boundary_wm = boundary_wm
        self.published_at = published_at
        self.accs = accs
        self.index = index
        self.num_shards = num_shards


class ReplicaPlane:
    """The double-buffered replica one engine publishes into.

    Single-writer: every mutating method runs on the engine's task thread.
    Readers (serving worker threads) only touch :attr:`sealed` — a
    reference to an immutable :class:`ReplicaGeneration` — and the gather
    step, both safe concurrently with a publish in progress."""

    def __init__(self, mesh, leaves, capacity: int) -> None:
        self.leaves = tuple(leaves)
        self._dtypes = tuple(np.dtype(l.dtype).name for l in self.leaves)
        #: minimum seconds between publishes (0 = every boundary)
        self.min_interval_s = 0.0
        #: set by the serving adapter (attach_cache): called on the TASK
        #: thread after each seal with (generation, per_shard, harvest,
        #: prev_index) — the harvest comes host-side in ONE copy so the
        #: hot-row cache re-primes without a lookup touching the device
        self.on_publish = None
        #: called when the plane rebuilds (restore/reshard/loss): the
        #: cache drops this operator's entries
        self.on_rebuild = None
        self._gen = 0
        #: the sealed generation readers resolve against (atomic swap)
        self.sealed: Optional[ReplicaGeneration] = None
        # ---- counters (read by serving gauges and the benchmark gates)
        self.publishes = 0
        self.rows_published = 0
        self.rows_freed = 0
        self.cold_flips = 0
        self.lookups_served = 0
        self.cold_rows_served = 0
        self._reset(mesh, capacity)
        self._index_reset = False

    def _reset(self, mesh, capacity: int) -> None:
        self.mesh = mesh
        self.P = int(mesh.size)
        self.device = mesh.device
        self.capacity = int(capacity)
        self._publish_step, self._gather_step = build_replica_steps(
            mesh, self._dtypes)
        #: the index of the last publish on this plane shape (empty after
        #: a rebuild): its slot metadata is the shadow the engines' next
        #: publish delta diffs against (``rep_used``/``rep_key``/``rep_ns``)
        self._published = ReplicaIndex.empty(self.P, self.capacity)
        #: rows whose VALUE changed since the last publish (set by the
        #: engines' scatter sites; residency/identity changes are
        #: derived from the metadata diff instead)
        self.rep_dirty = np.zeros((self.P, self.capacity), dtype=bool)
        self._accs = tuple(
            torch.full((self.P, self.capacity),
                       np.asarray(l.identity).item(),
                       dtype=torch_dtype(l.dtype), device=self.device)
            for l in self.leaves)
        self._pub_bucket = 0
        self._gather_bucket = 0

    @property
    def rep_used(self) -> np.ndarray:
        return self._published.used

    @property
    def rep_key(self) -> np.ndarray:
        return self._published.key

    @property
    def rep_ns(self) -> np.ndarray:
        return self._published.ns

    # ----------------------------------------------------------- publishing

    def needs_rebuild(self, P: int, capacity: int) -> bool:
        return P != self.P or capacity != self.capacity

    def rebuild(self, mesh, capacity: int) -> None:
        """Reset the plane over a (possibly) new mesh/capacity — after
        restore, reshard, shard loss or index growth. The next publish
        diffs against an empty shadow, i.e. republishes every resident
        row; the generation counter keeps advancing so caches tagged with
        older generations invalidate. Readers keep serving the last
        sealed generation of the OLD plane until the first publish on the
        new one seals; that publish builds its index FROM SCRATCH —
        carrying the sealed cold entries forward would keep entries for
        keys that do not exist in the rebuilt state."""
        self._reset(mesh, capacity)
        self._index_reset = True
        if self.on_rebuild is not None:
            self.on_rebuild()

    def mark_dirty(self, p: int, slots) -> None:
        self.rep_dirty[p, slots] = True

    def _to_device(self, block: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(block)
        return t if self.device.type == "cpu" else t.to(self.device)

    def publish(self, live_accs, per_shard: Dict[int, dict],
                boundary_wm: int) -> bool:
        """Build + seal the next generation. ``per_shard`` has every
        shard; ``per_shard[p]`` carries::

            resident   (used, keys, ns): the shard's slot metadata at
                       this boundary (slots 0..L-1, L <= capacity)
            hidden     optional [L] mask of resident rows the index does
                       not serve (see ``ReplicaIndex``)
            up_slots   int32 slots to (re)publish on shard p
            up_keys    their key ids
            up_ns      their namespaces
            up_extra   per-row adapter payloads (or None)
            cold       [(key, ns, extra)] flipped to (or inserted as)
                       page-tier serving; extra None keeps the
                       existing entry's payload. A cold pair is never
                       resident.
            freed      (key, ns) pairs (a list or an [n, 2] array)
                       dropped from the index

        Returns True when a new generation was sealed (False = no
        changes; the sealed boundary watermark still advances, so
        staleness gauges and caches read "up to date")."""
        structural = self._index_reset
        d_max = 0
        for d in per_shard.values():
            d_max = max(d_max, len(d["up_slots"]))
            if len(d["cold"]) or len(d["freed"]) or d.get("fresh"):
                structural = True
            elif d["up_extra"] is not None and len(d["up_slots"]):
                # extras travel WITH values (a session's END extends as
                # it absorbs) — a value-only publish must still rewrite
                # those entries
                structural = True
        if d_max == 0 and not structural:
            s = self.sealed
            if s is not None:
                # metadata-only advance: same state, newer boundary —
                # mutating these two scalars on the sealed object is
                # benign (readers never derive row addressing from them)
                s.boundary_wm = boundary_wm
                s.published_at = time.monotonic()
            return False
        chaos.fault_point("serving.replica_publish", generation=self._gen + 1)
        # ---- device delta: one program, no D2H on the publish itself
        harvest = None
        if d_max:
            D = sticky_bucket(d_max, self._pub_bucket, minimum=64)
            self._pub_bucket = D
            block = np.zeros((self.P, D), dtype=np.int64)
            for p, d in per_shard.items():
                n = len(d["up_slots"])
                if n:
                    block[p, :n] = d["up_slots"]
            dev_block = self._to_device(block)
            # fresh tensors: the sealed generation is never written
            self._accs = self._publish_step(self._accs, live_accs,
                                            dev_block)
            if self.on_publish is not None:
                # the publish HARVEST: the delta rows' values, ONE
                # gather + ONE device-to-host copy — the cache prime
                # below lets hot-key lookups skip the device entirely
                harvest = harvest_to_host(
                    self._gather_step(self._accs, dev_block))
        # ---- host index: a value-only publish reuses the last one (every
        # pair keeps its (shard, slot)); a structural one snapshots the
        # boundary's slot metadata
        prev = self._published
        index = (self._next_index(prev, per_shard)
                 if structural or self.sealed is None else prev)
        self._gen += 1
        self.rows_published += sum(len(d["up_slots"])
                                   for d in per_shard.values())
        self.publishes += 1
        self._published = index
        self._index_reset = False
        self.sealed = ReplicaGeneration(
            self._gen, boundary_wm, time.monotonic(), self._accs, index,
            self.P)
        if self.on_publish is not None:
            # AFTER the seal: a prime tags entries with the new
            # generation, so it must not run while probes still
            # resolve the old one (they would read fresh tags as
            # future and miss). ``prev`` is the pre-publish index: the
            # adapters' prime needs the OLD result addressing (a
            # session's end MOVES as it absorbs); after a rebuild it is
            # empty — the caches were invalidated, nothing maps back.
            self.on_publish(self._gen, per_shard, harvest, prev)
        return True

    def _next_index(self, prev: ReplicaIndex,
                    per_shard: Dict[int, dict]) -> ReplicaIndex:
        P, cap = self.P, self.capacity
        used = np.zeros((P, cap), dtype=bool)
        key = np.zeros((P, cap), dtype=np.int64)
        ns = np.zeros((P, cap), dtype=np.int64)
        extra = prev.extra.copy() if prev.extra is not None else None
        hidden = None
        for p, d in per_shard.items():
            r_used, r_key, r_ns = d["resident"]
            L = len(r_used)
            used[p, :L] = r_used
            key[p, :L] = r_key
            ns[p, :L] = r_ns
            if d.get("hidden") is not None:
                if hidden is None:
                    hidden = np.zeros((P, cap), dtype=bool)
                hidden[p, :L] = d["hidden"]
            if d["up_extra"] is not None and len(d["up_slots"]):
                if extra is None:
                    extra = np.empty((P, cap), dtype=object)
                extra[p, np.asarray(d["up_slots"], dtype=np.int64)] = \
                    _objects(d["up_extra"])
        return ReplicaIndex(used, key, ns, extra,
                            self._next_cold(prev, per_shard), hidden)

    def _next_cold(self, prev: ReplicaIndex,
                   per_shard: Dict[int, dict]) -> dict:
        """The page-tier entries after this publish, copy-on-write over
        ``prev.cold``: pairs resident again leave, the delta's cold
        entries enter (their payload from the entry before them unless
        given), freed pairs leave."""
        cold = prev.cold
        new_c = [c for d in per_shard.values() for c in d["cold"]]
        self.rows_freed += sum(len(d["freed"]) for d in per_shard.values())
        if not cold and not new_c:
            return cold
        out = dict(cold)
        copied: set = set()

        def inner(k: int) -> dict:
            if k not in copied:
                copied.add(k)
                out[k] = dict(out.get(k, ()))
            return out[k]

        if cold:
            ck = np.fromiter(cold, dtype=np.int64, count=len(cold))
            for d in per_shard.values():
                uk = np.asarray(d["up_keys"], dtype=np.int64)
                for j in np.flatnonzero(np.isin(uk, ck)).tolist():
                    k, n = int(uk[j]), int(d["up_ns"][j])
                    if n in out.get(k, ()):
                        inner(k).pop(n)
        if new_c:
            found, shard, _, pextra = prev.find([c[0] for c in new_c],
                                                [c[1] for c in new_c])
            j = 0
            for p, d in per_shard.items():
                for k, n, c_extra in d["cold"]:
                    k, n = int(k), int(n)
                    ent = out.get(k, {}).get(n)
                    if ent is None and found[j]:
                        ent = (int(shard[j]), pextra[j])
                    inner(k)[n] = (
                        (ent[0], ent[1] if c_extra is None else c_extra)
                        if ent is not None else (p, c_extra))
                    j += 1
            self.cold_flips += len(new_c)
        if out:
            ok = np.fromiter(out, dtype=np.int64, count=len(out))
            for d in per_shard.values():
                fa = _pairs(d["freed"])
                for k, n in fa[np.isin(fa[:, 0], ok)].tolist():
                    if n in out.get(k, ()):
                        inner(k).pop(n)
        for k in copied:
            if not out[k]:
                del out[k]
        return out


    # -------------------------------------------------------------- reading

    def generation(self) -> int:
        s = self.sealed
        return s.gen if s is not None else 0

    def staleness_ms(self) -> float:
        s = self.sealed
        if s is None:
            return 0.0
        return (time.monotonic() - s.published_at) * 1e3

    def gather_rows(self, gen: ReplicaGeneration,
                    rows: List[Tuple[int, int]]) -> List[tuple]:
        """Read resident replica rows ``(shard, slot)`` back as per-row
        leaf tuples: ONE gather + ONE device-to-host copy for the whole
        batch, against the sealed generation's immutable tensors — safe
        from any thread (the gather is queued on the default stream, the
        ingest's, see the module doc)."""
        if not len(rows):
            return []
        a = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
        return list(zip(*self.gather(gen, a[:, 0], a[:, 1])))

    def gather(self, gen: ReplicaGeneration, shard: np.ndarray,
               slot: np.ndarray) -> List[np.ndarray]:
        """:meth:`gather_rows` over arrays: per leaf, the host values of
        the resident rows ``(shard[i], slot[i])``."""
        n = len(shard)
        counts = np.bincount(shard, minlength=gen.num_shards)
        lane = np.empty(n, dtype=np.int64)
        lane[np.argsort(shard, kind="stable")] = (
            np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts))
        G = sticky_bucket(int(counts.max()), self._gather_bucket,
                          minimum=64)
        self._gather_bucket = G
        block = np.zeros((gen.num_shards, G), dtype=np.int64)
        block[shard, lane] = slot
        gathered = self._gather_step(gen.accs, self._to_device(block))
        host = harvest_to_host(gathered)  # ONE device-to-host copy
        return [np.asarray(h)[shard, lane] for h in host]

    def counters(self) -> Dict[str, int]:
        return {
            "publishes": int(self.publishes),
            "rows_published": int(self.rows_published),
            "rows_freed": int(self.rows_freed),
            "cold_flips": int(self.cold_flips),
            "lookups_served": int(self.lookups_served),
            "cold_rows_served": int(self.cold_rows_served),
        }




def finish_host(agg, leaves) -> Dict[str, np.ndarray]:
    """``agg.finish`` over host leaf arrays: NumPy columns by name (the
    finish is the same torch function the engines' fires run)."""
    finished = agg.finish(tuple(torch.from_numpy(np.array(a, copy=True))
                                for a in leaves))
    return {name: col.numpy() for name, col in finished.items()}


# --------------------------------------------------------------- adapters


class ReplicaAdapter:
    """The serving plane's view of one operator's replica: everything a
    worker thread may touch without the task loop. Subclasses compose
    engine-specific results (windows/sessions) from gathered rows.

    ``cold_fetch(key_ids)`` — posts ONE live query batch for keys whose
    entries are cold (page-tier state is single-owner host state, so
    the read detours through the owning job's control queue exactly
    like the legacy path; bound by the session cluster)."""

    def __init__(self, plane: ReplicaPlane, agg) -> None:
        self.plane = plane
        self.agg = agg
        self.cold_fetch = None  # bound by ServingPlane.bind_replica
        self._cache = None
        self._cache_job = None
        self._cache_op = None

    # -- publish-harvest cache feed

    def attach_cache(self, cache, job: str, operator: str) -> None:
        """Wire the hot-row cache into the publish harvest: every
        boundary publish folds its delta into the cached entries it
        touches (on the task thread — ONE batched D2H per publish), so
        a hot key's lookups never touch the device between misses."""
        self._cache = cache
        self._cache_job = job
        self._cache_op = operator
        self.plane.on_publish = self._on_publish
        self.plane.on_rebuild = self._on_rebuild

    def _on_rebuild(self) -> None:
        if self._cache is not None:
            self._cache.invalidate_op(self._cache_job, self._cache_op)

    def prime_value_ns(self, ns: int, extra):
        """Result-dict key for an upserted row, or None when the
        cached composition cannot be updated incrementally (the key's
        entry is dropped and the next lookup re-resolves)."""
        return None

    def prime_free_ns(self, ns: int, extra):
        """Result-dict key removed by a freed row (``extra`` is the
        row's payload in the PRE-publish index, when it had one), or
        None to drop the key's entry instead."""
        return None

    def _prime_rows(self, keys_f: np.ndarray, ns_f: np.ndarray,
                    extra_f: np.ndarray, prev_index):
        """Map the delta rows to cache updates: ``(rns, valid,
        removals, kill)`` where ``rns[j]`` is row j's RESULT namespace
        (valid[j] False = no incremental update), ``removals`` is a
        list of ``(kid, result_ns)`` stale entries to delete in the
        SAME batched prime, and ``kill`` is kids whose cached entry
        drops outright. Default: per-row :meth:`prime_value_ns`."""
        n = len(keys_f)
        rns = np.zeros(n, dtype=np.int64)
        valid = np.zeros(n, dtype=bool)
        kill: set = set()
        for j in range(n):
            r = self.prime_value_ns(int(ns_f[j]), extra_f[j])
            if r is None:
                kill.add(int(keys_f[j]))
            else:
                rns[j] = int(r)
                valid[j] = True
        return rns, valid, [], kill

    def _free_rows(self, per_shard: Dict[int, dict], prev_index):
        """Map the delta's freed rows to cache updates: ``(removals,
        kill)`` as in :meth:`_prime_rows`. Default: per-row
        :meth:`prime_free_ns` with the row's pre-publish payload."""
        removals: List[Tuple[int, int]] = []
        kill: set = set()
        fa = np.concatenate([_pairs(d["freed"]) for d in per_shard.values()]
                            or [np.zeros((0, 2), dtype=np.int64)])
        found, _, _, extra = prev_index.find(fa[:, 0], fa[:, 1])
        for j, (key, ns) in enumerate(fa.tolist()):
            r = self.prime_free_ns(ns, extra[j] if found[j] else None)
            if r is None:
                kill.add(key)
            else:
                removals.append((key, int(r)))
        return removals, kill

    def _on_publish(self, gen: int, per_shard: Dict[int, dict],
                    harvest, prev_index) -> None:
        """The publish-harvest cache feed, batch-first: flatten the
        delta rows once, finish the value columns ONCE, map rows to
        result namespaces, and fold the whole boundary into the cache
        as ONE :class:`~flink_tpu_torch.tenancy.hot_cache.PrimeDelta` (one
        GIL-released C call on the native plane; one locked pass on
        the Python fallback)."""
        cache = self._cache
        if cache is None:
            return
        from flink_tpu_torch.tenancy.hot_cache import PrimeDelta

        job, op = self._cache_job, self._cache_op
        leaves = self.agg.leaves
        # flatten the delta rows across shards, finish ONCE
        keys_l, ns_l, extra_l, val_cols = [], [], [], None
        if harvest is not None:
            chunks: List[List[np.ndarray]] = [[] for _ in leaves]
            for p, d in per_shard.items():
                n = len(d["up_slots"])
                if not n:
                    continue
                keys_l.append(d["up_keys"])
                ns_l.append(d["up_ns"])
                extra_l.append(
                    d["up_extra"] if d["up_extra"] is not None
                    else np.zeros(n, dtype=np.int64))
                for i in range(len(leaves)):
                    chunks[i].append(harvest[i][p][:n])
            if keys_l:
                finished = finish_host(self.agg, [
                    np.concatenate(chunks[i]).astype(l.dtype,
                                                     copy=False)
                    for i, l in enumerate(leaves)])
                val_cols = list(finished.items())
        if keys_l:
            keys_f = np.concatenate(keys_l)
            ns_f = np.concatenate(ns_l)
            extra_f = np.concatenate(extra_l)
        else:
            keys_f = ns_f = extra_f = np.zeros(0, dtype=np.int64)
        if val_cols is not None and len(keys_f):
            rns, valid, removals, kill = self._prime_rows(
                keys_f, ns_f, extra_f, prev_index)
        else:
            rns = np.zeros(len(keys_f), dtype=np.int64)
            valid = np.zeros(len(keys_f), dtype=bool)
            removals, kill = [], set()
        f_rem, f_kill = self._free_rows(per_shard, prev_index)
        rem = np.concatenate([_pairs(removals), _pairs(f_rem)])
        kill_a = np.union1d(_ids(kill), _ids(f_kill))
        # ---- the flat delta, grouped per kid (sorted; rows of a kid in
        # delta order): updates and removals of killed kids drop out
        u_kids = keys_f[valid]
        keep = ~np.isin(u_kids, kill_a)
        order = np.flatnonzero(keep)[np.argsort(u_kids[keep],
                                                kind="stable")]
        u_kids = u_kids[order]
        u_rns = rns[valid][order]
        u_cols = [(name, col[valid][order]) for name, col in
                  (val_cols or [])]
        rem = rem[~np.isin(rem[:, 0], kill_a)]
        rem = rem[np.argsort(rem[:, 0], kind="stable")]
        keys_a = np.union1d(np.union1d(u_kids, rem[:, 0]), kill_a)
        if not len(keys_a):
            return

        def offsets(sorted_kids):
            c = (np.searchsorted(sorted_kids, keys_a, "right")
                 - np.searchsorted(sorted_kids, keys_a, "left"))
            return c, np.concatenate([[0], np.cumsum(c)]).astype(np.int64)

        uc, uoff = offsets(u_kids)
        _, roff = offsets(rem[:, 0])
        flags = np.where(np.isin(keys_a, kill_a), 2, 0).astype(np.uint8)
        has = np.flatnonzero(uc)
        if len(has):
            # the delta covered EVERY published row of the key -> the
            # update IS its complete composed state, safe to INSERT:
            # first-touch lookups of hot keys never touch the device
            full = has[uc[has] == self.plane.sealed.index.count(
                keys_a[has])]
            flags[full] |= 1
        cache.prime_batch(job, op, gen, PrimeDelta(
            keys=keys_a, uoff=uoff, u_ns=u_rns, u_cols=u_cols,
            roff=roff, r_ns=rem[:, 1].copy(), flags=flags))

    # -- key plumbing (worker threads)

    def key_id(self, key) -> int:
        if isinstance(key, (int, np.integer)):
            return int(key)  # integer keys ARE their identity
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        return int(hash_keys_to_i64(np.asarray([key]))[0])

    def shard_of(self, key_id: int) -> int:
        gen = self.plane.sealed
        n = gen.num_shards if gen is not None else self.plane.P
        return key_id % n if n else 0

    def generation(self) -> int:
        return self.plane.generation()

    def ready(self) -> bool:
        return self.plane.sealed is not None

    # -- the lookup itself

    def lookup_batch(self, keys: List[Any]) -> Tuple[List[dict], int]:
        """One result dict per key (the operator's query_state_batch
        shape), resolved against ONE sealed generation; returns
        ``(results, generation)`` so the hot-row cache can tag them."""
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        gen = self.plane.sealed
        if gen is None:
            raise RuntimeError("replica not published yet")
        key_ids = hash_keys_to_i64(np.asarray(keys))
        n = len(key_ids)
        index = gen.index
        row, shard, slot, nss, extra = index.resident(key_ids)
        order = np.lexsort((nss, row))  # by request row, then namespace
        row, shard, slot, nss = row[order], shard[order], slot[order], \
            nss[order]
        vals = (list(zip(*self.plane.gather(gen, shard, slot)))
                if len(row) else [])
        row_of: List[List[Tuple[int, int, Any]]] = [[] for _ in range(n)]
        for j, (r, ns, e) in enumerate(zip(
                row.tolist(), nss.tolist(),
                extra[order].tolist() if extra is not None
                else repeat(None))):
            row_of[r].append((ns, j, e))
        cold_of: List[List[Tuple[int, Any]]] = [[] for _ in range(n)]
        if index.cold:
            for r in range(n):
                for ns, (_p, e) in index.cold.get(int(key_ids[r]),
                                                  {}).items():
                    cold_of[r].append((int(ns), e))
        cold_vals: Dict[int, dict] = {}
        cold_rows = [r for r in range(n) if cold_of[r]]
        if cold_rows:
            if self.cold_fetch is None:
                raise RuntimeError(
                    "replica has cold rows but no cold_fetch is bound")
            fetched = self.cold_fetch([keys[r] for r in cold_rows])
            for r, res in zip(cold_rows, fetched):
                cold_vals[r] = res
                self.plane.cold_rows_served += len(cold_of[r])
        out = self.compose_all(row_of, vals, cold_of, cold_vals)
        self.plane.lookups_served += n
        return out, gen.gen

    def compose_all(self, row_of, vals, cold_of,
                    cold_vals: Dict[int, dict]) -> List[dict]:
        """Compose every requested key's result. Default: one
        :meth:`compose` call per key; adapters override with a
        vectorized pass where the window/namespace mapping allows."""
        return [self.compose(row_of[r], vals, cold_of[r],
                             cold_vals.get(r))
                for r in range(len(row_of))]

    def compose(self, entries, vals, cold_entries, cold_result) -> dict:
        raise NotImplementedError


class SessionReplicaAdapter(ReplicaAdapter):
    """Session engine: an index entry's ``extra`` is the session END;
    a key's result is ``{session_end -> finished columns}``.

    Sessions PRIME instead of invalidating: a session's result key —
    its END — moves as the session absorbs, so each publish upserts
    the row under the NEW end and deletes the stale-end entry in the
    SAME batched prime (the old end read from the PRE-publish index,
    where the (key, sid) row still carries it). The hottest workload
    class — a session absorbing across many boundaries — stays on the
    hit path instead of structurally missing at every boundary."""

    def _prime_rows(self, keys_f, ns_f, extra_f, prev_index):
        n = len(keys_f)
        rns = np.asarray(extra_f, dtype=np.int64)  # the NEW ends
        valid = np.ones(n, dtype=bool)
        removals: List[Tuple[int, int]] = []
        found, _, _, prev = prev_index.find(keys_f, ns_f)
        for j in np.flatnonzero(found).tolist():
            if prev[j] is not None and int(prev[j]) != int(rns[j]):
                # the session's end MOVED: the entry cached under the
                # old end is stale — delete it in this prime
                removals.append((int(keys_f[j]), int(prev[j])))
        return rns, valid, removals, set()

    def prime_free_ns(self, ns: int, extra):
        # a freed (fired/merged-away) session removes its END entry;
        # ``extra`` is the pre-publish index payload = the old end.
        # A freed row with no recorded end cannot be mapped — drop the
        # key's entry (the safe fallback the old invalidate path took).
        return int(extra) if extra is not None else None

    def compose(self, entries, vals, cold_entries, cold_result) -> dict:
        out: Dict[int, Dict[str, float]] = {}
        if entries:
            leaves = [np.asarray([vals[j][i] for _, j, _ in entries],
                                 dtype=l.dtype)
                      for i, l in enumerate(self.agg.leaves)]
            cols = finish_host(self.agg, leaves)
            for r, (_ns, _j, end) in enumerate(entries):
                out[int(end)] = {name: col[r].item()
                                 for name, col in cols.items()}
        if cold_result is not None:
            # take ONLY the sessions the sealed index flagged cold out
            # of the live detour's full map (their entry extra is the
            # session end) — a cold row cannot change while cold, so
            # its live value IS its boundary value; sessions born after
            # the boundary are not in the sealed index and stay out
            for _sid, end in cold_entries:
                colsd = cold_result.get(int(end))
                if colsd is not None:
                    out[int(end)] = colsd
        return out


class JoinSideReplicaAdapter(ReplicaAdapter):
    """One join side table's replica view: rows are immutable, the
    index maps ``key -> {rid -> (shard, slot, (ts, host_col_values))}``
    and a key's result is the live ``query_side_batch`` shape — a list
    of ``{"ts", "rid", <col>: v}`` dicts sorted by (ts, rid). Device
    columns gather from the sealed plane; device-ineligible columns
    ride the published ``extra`` payload; cold rows detour through
    ``cold_fetch`` (their page value IS their boundary value — join
    rows never change after insert)."""

    def __init__(self, plane: ReplicaPlane, side) -> None:
        super().__init__(plane, agg=None)
        self.schema = list(side.schema)
        self.device_cols = list(side.device_cols)
        self.host_cols = list(side.host_cols)

    def compose(self, entries, vals, cold_entries, cold_result) -> list:
        rows: List[dict] = []
        names = [nm for nm, _ in self.schema]
        for rid, j, extra in entries:
            ts, host_vals = extra
            row = {"ts": int(ts), "rid": int(rid)}
            for gi, i in enumerate(self.device_cols):
                row[names[i]] = np.asarray(vals[j][gi]).item()
            for hi, i in enumerate(self.host_cols):
                v = host_vals[hi]
                row[names[i]] = v.item() if hasattr(v, "item") else v
            rows.append(row)
        if cold_result is not None:
            want = {int(rid) for rid, _ in cold_entries}
            for row in cold_result:
                if int(row["rid"]) in want:
                    rows.append(dict(row))
        rows.sort(key=lambda d: (d["ts"], d["rid"]))
        return rows


class WindowReplicaAdapter(ReplicaAdapter):
    """Window engine: entries are per-SLICE accumulator rows
    (namespace == slice end); results compose host-side through the
    same ``compose_windows`` the live query path uses. A window with at
    least one COLD slice answers from the live detour (raw slice values
    are not recoverable from a composed window result) — those slices
    are boundary-stable by definition of cold, and the detour is the
    exact legacy read path."""

    def __init__(self, plane: ReplicaPlane, agg, assigner) -> None:
        super().__init__(plane, agg)
        self.assigner = assigner
        #: None = unknown, probed on first lookup: does every slice map
        #: to exactly ONE window that is exactly that slice (tumbling)?
        #: Then composition is a single vectorized finish over all rows
        #: instead of a per-key per-window host merge loop.
        self._one_to_one: Optional[bool] = None

    def _probe_one_to_one(self, ns: int) -> bool:
        if self._one_to_one is None:
            a = self.assigner
            self._one_to_one = (
                [int(w) for w in a.window_ends_for_slice(int(ns))]
                == [int(ns)]
                and [int(s) for s in a.slice_ends_for_window(int(ns))]
                == [int(ns)])
        return self._one_to_one

    def prime_value_ns(self, ns: int, extra):
        # tumbling-style: the slice end IS the window end, a stable
        # result key — the cached entry updates in place. Sliding/
        # cumulative shapes fall back to drop-and-re-resolve (a slice
        # feeds k windows; incremental re-compose isn't worth it).
        return ns if self._probe_one_to_one(ns) else None

    def prime_free_ns(self, ns: int, extra):
        return ns if self._probe_one_to_one(ns) else None

    def _prime_rows(self, keys_f, ns_f, extra_f, prev_index):
        # vectorized: ONE assigner probe decides the whole batch —
        # tumbling-style rows prime under their own namespace, other
        # shapes drop every touched key (the base class would have
        # made the same per-row decision n times)
        n = len(keys_f)
        if n and self._probe_one_to_one(int(ns_f[0])):
            return (np.asarray(ns_f, dtype=np.int64),
                    np.ones(n, dtype=bool), [], set())
        return (np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool),
                [], np.unique(np.asarray(keys_f, dtype=np.int64)))

    def _free_rows(self, per_shard, prev_index):
        # one assigner probe decides every freed row (as _prime_rows):
        # tumbling-style rows remove their own namespace, other shapes
        # drop the key
        fa = np.concatenate([_pairs(d["freed"]) for d in per_shard.values()]
                            or [np.zeros((0, 2), dtype=np.int64)])
        if not len(fa):
            return [], set()
        if self._probe_one_to_one(int(fa[0, 1])):
            return fa, set()
        return [], np.unique(fa[:, 0])

    def compose_all(self, row_of, vals, cold_of, cold_vals):
        # vectorized fast path (the serving hot loop): tumbling-style
        # assigners finish EVERY gathered row in one pass — the per-key
        # compose_windows loop is only needed for sliding/cumulative
        # shapes (slice sharing) and for keys with cold slices
        some = next((row_of[r][0][0] for r in range(len(row_of))
                     if row_of[r]), None)
        if some is None:
            return super().compose_all(row_of, vals, cold_of, cold_vals)
        if not self._probe_one_to_one(some):
            return self._compose_shared(row_of, vals, cold_of, cold_vals)
        leaves = [np.asarray([v[i] for v in vals], dtype=l.dtype)
                  for i, l in enumerate(self.agg.leaves)]
        cols = list(finish_host(self.agg, leaves).items())
        out: List[dict] = []
        for r in range(len(row_of)):
            if cold_of[r]:
                out.append(self.compose(row_of[r], vals, cold_of[r],
                                        cold_vals.get(r)))
                continue
            res: Dict[int, Dict[str, float]] = {}
            for ns, j, _extra in row_of[r]:
                res[ns] = {name: col[j].item() for name, col in cols}
            out.append(res)
        return out

    def _compose_shared(self, row_of, vals, cold_of, cold_vals):
        """Sliding/cumulative shapes (a slice feeds several windows): every
        key without cold slices composes in ONE ``compose_windows_pairs``
        call — the batched form of the per-key ``compose_windows``, equal
        to it bit for bit (the live query path's composition); keys with
        cold slices take :meth:`compose`."""
        from flink_tpu_torch.windowing.windower import compose_windows_pairs

        n = len(row_of)
        rows: List[int] = []
        nss: List[int] = []
        take: List[int] = []
        for r in range(n):
            if cold_of[r]:
                continue
            for ns, j, _extra in row_of[r]:
                rows.append(r)
                nss.append(int(ns))
                take.append(j)
        leaves = [np.asarray([vals[j][i] for j in take], dtype=l.dtype)
                  for i, l in enumerate(self.agg.leaves)]
        out = compose_windows_pairs(
            self.assigner, self.agg, np.asarray(rows, dtype=np.int64),
            np.asarray(nss, dtype=np.int64), leaves, n)
        for r in range(n):
            if cold_of[r]:
                out[r] = self.compose(row_of[r], vals, cold_of[r],
                                      cold_vals.get(r))
        return out

    def compose(self, entries, vals, cold_entries, cold_result) -> dict:
        from flink_tpu_torch.windowing.windower import compose_windows

        slice_vals: Dict[int, tuple] = {}
        for ns, j, _extra in entries:
            slice_vals[int(ns)] = tuple(
                np.asarray([v], dtype=l.dtype)
                for v, l in zip(vals[j], self.agg.leaves))
        out = compose_windows(self.assigner, self.agg, slice_vals) \
            if slice_vals else {}
        if cold_result is not None:
            cold_windows = sorted({
                int(w) for ns, _ in cold_entries
                for w in self.assigner.window_ends_for_slice(int(ns))})
            for w in cold_windows:
                colsd = cold_result.get(w)
                if colsd is not None:
                    out[w] = colsd
                else:
                    out.pop(w, None)
        return out
