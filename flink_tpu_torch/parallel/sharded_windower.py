"""Mesh-sharded keyed state (port of
``flink_tpu/parallel/sharded_windower.py``: the window engine reduced to
the Q5 path with its device budget, and the per-shard spill tiers the
mesh engines run on).

State lives in ``[P, capacity]`` planes on the mesh's device, one per
accumulator leaf, dim 0 being the key-group shard. Records are routed to
their owning shard by the reference's key-group formula; ingest runs the
fused exchange+scatter step (``parallel/shuffle.py``), a fire gathers and
merges a window's slices per shard on the device, and expired slices are
reset to identity. Every key's slices live on one shard, so fires and
resets are shard-local.

- :class:`MeshSpillSupport`: the routing, the dispatch-ahead pipeline and
  the per-shard spill tiers both mesh engines share, with the namespace
  spill layout: under a per-shard row budget the least recently touched
  namespaces (window slices) of a shard leave in ONE ``[P, G]`` gather,
  ONE device-to-host copy and ONE ``[P, R]`` reset, and reload on access
  in ONE ``[P, B]`` put for all shards. A window with a spilled slice
  fires hybrid: resident slices merge on the device, spilled ones are
  combined on the host.
- :class:`MeshPagedSpillSupport`: the paged (cohort) spill tier of the
  session engine (``parallel/sharded_sessions.py``): per shard the
  coldest rows leave as one page (``state/paged_spill.py``), every
  shard's cohort in ONE ``[P, G]`` gather, ONE device-to-host copy and
  ONE reset; reloads of all shards land in ONE ``[P, B]`` put.
- :func:`build_mesh_steps` (scatter, fire, reset, gather, put, merge,
  valued scatter) and
  :func:`build_delta_fire_step` (fire and reset in one call).

Both engines snapshot in the single-device engines' logical format (rows
of every shard and every spilled row, key-group indexed), write deltas of
the rows dirtied since the last snapshot plus freed-namespace tombstones,
and restore by routing each row to the shard its key's ingest uses — so a
P=8 snapshot restores at P=1 and the other way round. The reference's
fault points sit at its sites: ``mesh.dispatch_fence``,
``shuffle.device_exchange`` (after the fused dispatch) and
``mesh.window_fire``.

Failure domains finer than the job: ``reshard`` rebuilds the planes and
everything sized by P at a new shard count and lands every row on its new
owner; ``lose_shard(s)`` evacuates the survivors onto ``P - k`` shards,
``restore_key_groups`` lands one checkpoint unit's range, and
``snapshot_sharded`` / ``merge_unit_snapshots`` split and join the
snapshot by the shards' key-group ranges (``checkpoint/sharded.py``). An
attached ``runtime/watchdog.py`` watchdog times the synchronising device
interactions and probes shard health at batch boundaries.

With ``memory=(manager, owner)`` the planes reserve their footprint from
the job's managed pool at creation, growth and reshard
(``core/memory.py``). Each ingest is a ``batch.ingest`` span and each
watermark a ``fire.dispatch`` span in the flight recorder.

The read replica (``arm_replica``, ``tenancy/replica.py``): the scatter
sites mark the rows whose values changed, the evictions note rows going
cold, and the end of every ``on_watermark`` publishes the boundary delta
(the metadata diff against the replica's shadow plus the marks) into the
next sealed generation. ``enforce_resident_budget`` is the tenant
quota's backstop (``tenancy/quotas.py``): it sheds the engine's own
coldest rows into its spill tier.

Live rebalance (``reassign_key_groups``): an explicit
``KeyGroupAssignment`` moves key groups between shards at a batch
boundary with the reshard's drain -> lift -> rebuild -> redistribute
handoff; every routing site goes through ``_route``, so the installed
table re-routes ingest, merges, fires, queries, restores and the device
exchange's destination column at once. ``reshard`` resets it to the
contiguous layout.

The data plane: ``shuffle_mode="device"`` (the default) ranks, buckets
and exchanges flat staged columns on the device; under a multi-host
``host_topology`` that exchange runs in two levels
(``parallel/exchange2.py``, bit for bit the flat one's folds);
``shuffle_mode="host"`` buckets records into ``[P, B]`` blocks on the host
(``bucket_by_shard``). Point queries (``query_batch``)
gather every shard's hits in one ``[P, G]`` block with one copy back, and
read spilled slices from the shards' host tiers.
"""

from __future__ import annotations

import time
from collections import deque
from itertools import repeat
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.ops.segment_ops import (
    HOST_COMBINE,
    MERGE_FN,
    fold_slots,
    pad_bucket_size,
    scatter_fold,
    sticky_bucket,
    torch_dtype,
)
from flink_tpu_torch.parallel.exchange2 import (
    ExchangeTraffic,
    build_exchange2_steps,
    stage_two_level_exchange,
    two_level_active,
)
from flink_tpu_torch.parallel.mesh import LogicalMesh
from flink_tpu_torch.parallel.shuffle import (
    ShuffleBufferPool,
    bucket_by_shard,
    build_exchange_scatter,
    shard_records,
    stage_device_exchange,
)
from flink_tpu_torch.runtime.local_agg import (
    is_partial_batch,
    partial_leaf_values,
)
from flink_tpu_torch.runtime.pending import (
    Fence,
    PendingFire,
    harvest_to_host,
)
from flink_tpu_torch.runtime.watchdog import WatchdogHooks
from flink_tpu_torch.state.keygroups import (
    assign_key_groups,
    shard_key_group_ranges,
)
from flink_tpu_torch.state.paged_spill import (
    PagedSpillMap,
    drop_spilled_sessions,
    reload_rows_for,
    restore_into_pages,
    run_deferred_sweeps,
    spill_page,
    spilled_rows,
)
from flink_tpu_torch.state.slot_table import (
    SlotTableFullError,
    SpillTier,
    make_slot_index,
    resolve_slot_hints,
    unique_pairs,
)
from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.bookkeeping import SliceBookkeeper
from flink_tpu_torch.windowing.windower import (
    WINDOW_END_FIELD,
    WINDOW_START_FIELD,
    compose_windows_pairs,
)


def _rows(keys: np.ndarray, nss: np.ndarray, extra) -> zip:
    """``(key, ns, extra)`` entries of a replica publish's cold list: the
    ids as Python ints, ``extra`` per row (None for every row when
    None)."""
    return zip(keys.tolist(), nss.tolist(),
               repeat(None) if extra is None else list(extra))


class MeshSpillSupport(WatchdogHooks):
    """What both mesh engines share: key-group routing, host-to-device
    staging, the dispatch-ahead pipeline, one spill tier per shard, and
    the logical snapshot, delta and restore of the ``[P, capacity]``
    planes. Hosts provide ``P``, ``device``, ``max_parallelism``,
    ``key_group_range``, ``agg``, ``accs``, ``capacity``,
    ``max_dispatch_ahead``, ``indexes`` and the ``_gather_step`` and
    ``_put_step`` programs, and call :meth:`_init_tracking`."""

    max_device_slots: int = 0
    #: the paged (cohort) layout is on; the namespace layout otherwise
    _paged: bool = False
    #: (MemoryManager, owner): the ``[P, capacity]`` footprint reserves
    #: from the job's managed pool (core/memory.py); None = unmanaged
    _memory = None
    #: the flight recorder's per-engine batch sequence
    _flight_batch: int = 0

    def _flight_ingest(self):
        """Open the ``batch.ingest`` span of one ``process_batch`` and
        advance the batch sequence (spans below inherit the batch id)."""
        self._flight_batch += 1
        return flight.ingest_span(self._flight_batch)

    #: live non-contiguous key-group -> shard table installed by
    #: reassign_key_groups(); None = the contiguous formula
    _assignment = None
    #: live rebalances applied, and the report of the latest
    rebalances_completed: int = 0
    last_rebalance: Optional[Dict[str, object]] = None

    #: the ingest data plane: "device" ranks, buckets and exchanges the
    #: flat staged columns on the device; "host" buckets the records into
    #: [P, B] blocks on the host (bucket_by_shard)
    shuffle_mode: str = "device"
    #: the (hosts, local) factorization of the mesh: device-mode ingest
    #: then runs the two-level exchange (parallel/exchange2.py); None (or
    #: one host) keeps the flat exchange
    host_topology = None
    #: intra- vs cross-host rows of the two-level exchange
    _exchange2_traffic = None

    @staticmethod
    def _check_shuffle_mode(mode: str) -> str:
        if mode not in ("host", "device"):
            raise ValueError(
                f"shuffle_mode must be 'host' or 'device', got {mode!r}")
        return mode

    def _set_host_topology(self, topology) -> None:
        if topology is not None:
            topology.check_covers(self.P)
        self.host_topology = topology
        if topology is not None and self._exchange2_traffic is None:
            self._exchange2_traffic = ExchangeTraffic()

    def _two_level_active(self) -> bool:
        return two_level_active(self.host_topology, self.shuffle_mode)

    def exchange2_traffic(self) -> Dict[str, int]:
        """The two-level exchange's traffic split (zeros when flat)."""
        return ExchangeTraffic.dict_of(self._exchange2_traffic)

    def _dispatch_exchange(self, shards: np.ndarray, columns, fills,
                           flat_step, steps2, host_step, n: int) -> None:
        """Fold one batch's records into the planes through the engine's
        data plane: ``columns`` are the record slots and the value
        columns, ``fills`` their padding. The two-level pair ``steps2``
        on a multi-host topology, the flat exchange+scatter
        ``flat_step`` in device mode, else host bucketing into ``[P, B]``
        blocks and ``host_step``. Claims a dispatch slot first: the
        pooled staging buffers are rewritten here."""
        self._await_dispatch_slot()
        self._shuffle_pool.flip()
        if self._two_level_active():
            with flight.span("prep.stage"):
                dst, staged, w1, w2 = stage_two_level_exchange(
                    shards, self.host_topology, columns=columns,
                    fills=fills, pool=self._shuffle_pool,
                    traffic=self._exchange2_traffic)
            s1, s2 = steps2
            tr = self._exchange2_traffic
            with flight.span("device.dispatch"):
                cols = [self._to_device(c) for c in (dst, *staged)]
                with flight.span("exchange.stage1"):
                    inter = tr.count_launches(
                        1, s1, cols[0], cols[1], tuple(cols[2:]), w1)
                with flight.span("exchange.stage2"):
                    self.accs = tr.count_launches(
                        2, s2, self.accs, inter[0], inter[1],
                        tuple(inter[2:]), w2)
        elif self.shuffle_mode == "device":
            with flight.span("prep.stage"):
                dst, staged, width = stage_device_exchange(
                    shards, self.P, columns=columns, fills=fills,
                    pool=self._shuffle_pool)
            with flight.span("device.dispatch"):
                cols = [self._to_device(c) for c in (dst, *staged)]
                self.accs = flat_step(self.accs, cols[0], cols[1],
                                      tuple(cols[2:]), width)
        else:
            with flight.span("prep.stage"):
                _, blocked = bucket_by_shard(
                    shards, self.P, columns=columns, fills=fills,
                    pool=self._shuffle_pool)
            with flight.span("device.dispatch"):
                blocks = [self._to_device(b) for b in blocked]
                self.accs = host_step(self.accs, blocks[0],
                                      tuple(blocks[1:]))
        if self.shuffle_mode == "device":
            # chaos: "crash mid-batch after the fused dispatch" — the
            # scatter is queued on the device, the host dies before the
            # fence
            chaos.fault_point("shuffle.device_exchange", records=n)
        self._push_dispatch_fence()

    def _route(self, key_ids) -> np.ndarray:
        """key id -> owning shard: the contiguous key-group formula, or
        the live assignment's table after a rebalance (every routing
        site goes through here)."""
        return shard_records(key_ids, self.P, self.max_parallelism,
                             self.key_group_range,
                             assignment=self._assignment)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        # an async copy from PAGEABLE host memory has staged `host` when
        # it returns (no stream sync), so a pooled buffer may be
        # rewritten afterwards; on the CPU this is the array itself
        return torch.from_numpy(np.ascontiguousarray(host)).to(
            self.device, non_blocking=True)

    def _shard_index_grew(self, new_capacity: int) -> None:
        """One shard's index outgrew the plane width: widen every plane
        and the dirty bits (the other shards' indexes address a
        prefix)."""
        if new_capacity <= self.capacity:
            return
        old = self.capacity
        self._reserve_rows(self.P * (new_capacity - old))
        self.capacity = new_capacity
        grown = []
        for a, leaf in zip(self.accs, self.agg.leaves):
            g = torch.full((self.P, new_capacity),
                           np.asarray(leaf.identity).item(), dtype=a.dtype,
                           device=self.device)
            g[:, :old] = a
            grown.append(g)
        self.accs = tuple(grown)
        dirty = np.zeros((self.P, new_capacity), dtype=bool)
        dirty[:, :old] = self._dirty
        self._dirty = dirty

    def _init_tracking(self) -> None:
        #: [P, capacity] rows changed since the last snapshot (a page row
        #: carries its bit back on reload), and the namespaces freed since
        #: (delta tombstones)
        self._dirty = np.zeros((self.P, self.capacity), dtype=bool)
        self._freed_ns: List[np.ndarray] = []
        self._gather_bucket = 0

    def _init_spill(self, spill_dir: Optional[str],
                    spill_host_max_bytes: int) -> None:
        #: kept for the mesh rebuild (reshard, shard loss): the new tiers
        #: are made from the same configuration
        self._spill_dir = spill_dir
        self._spill_host_max_bytes = spill_host_max_bytes
        #: one spill tier per shard: spilled rows are shard-local like
        #: the device rows (keys move between shards only through a
        #: rebuild of the mesh)
        self.spills = [
            SpillTier(
                f"{spill_dir.rstrip('/')}/shard-{p}" if spill_dir else None,
                spill_host_max_bytes // self.P
                if spill_host_max_bytes else 0)
            for p in range(self.P)
        ]
        #: per shard, namespace -> touch clock (the namespace layout's LRU)
        self._ns_touch: List[Dict[int, int]] = [{} for _ in range(self.P)]
        self._touch_clock = 0
        self._reload_bucket = 0
        #: the namespace layout's spill traffic (the paged layout counts
        #: on its PagedSpillMaps); a job-lifetime counter, so a rebuild of
        #: the mesh keeps it
        if not hasattr(self, "_ns_counters"):
            self._ns_counters = PagedSpillMap.zero_counters()
        self._init_pipeline(self.max_dispatch_ahead)

    # ------------------------------------------------ host/device pipelining

    def _init_pipeline(self, depth: int) -> None:
        """Double-buffered dispatch-ahead: the host stages batch k+1 while
        the device runs batch k. ``depth`` bounds the dispatched-but-
        unfenced batches, and the staging pool rotates as many buffer
        generations: a generation is rewritten only after the fence of
        the batch that last read it has passed (one CUDA event per
        dispatched batch, never a device-wide sync)."""
        self._pipeline_depth = max(int(depth or 1), 1)
        self._shuffle_pool = ShuffleBufferPool(
            generations=self._pipeline_depth)
        self._dispatch_fences: deque = deque()
        #: wall seconds the host spent blocked on dispatch fences
        self.pipeline_wait_s = 0.0

    def make_fence(self) -> Fence:
        """A completion marker enqueued after everything dispatched so far
        (the engine's dispatch-ahead bound and the task loop's fences)."""
        return Fence(self.device)

    def _await_dispatch_slot(self) -> None:
        """Block until < depth dispatches are outstanding. MUST run before
        this batch's staging buffers are (re)written."""
        if len(self._dispatch_fences) < self._pipeline_depth:
            return
        t0 = time.perf_counter()
        with self._wd_section("fence_drain"):
            while len(self._dispatch_fences) >= self._pipeline_depth:
                self._dispatch_fences.popleft().block_until_ready()
        dt = time.perf_counter() - t0
        self.pipeline_wait_s += dt
        flight.instant("device.fence_wait", duration_s=dt)

    def _push_dispatch_fence(self) -> None:
        # chaos: a fence failure mid-dispatch-ahead — the batch's device
        # work is enqueued but its completion proof is lost: the engine
        # dies here with up to `depth` batches in flight
        chaos.fault_point("mesh.dispatch_fence",
                          in_flight=len(self._dispatch_fences))
        with self._wd_section("dispatch_fence"):
            self._dispatch_fences.append(self.make_fence())

    def _quiesce(self) -> None:
        """Land every dispatched batch: the planes and the staging pool
        are about to be replaced, and in-flight work references both."""
        with self._wd_section("fence_drain"):
            while self._dispatch_fences:
                self._dispatch_fences.popleft().block_until_ready()

    # ------------------------------------------------------------- watchdog

    #: each shard's ORIGINAL logical index (the watchdog's identities: on
    #: one card two losses must not collapse into one); None: ``range(P)``
    _shard_id_list: Optional[List[int]] = None

    def _shard_ids(self) -> List[int]:
        return (list(self._shard_id_list) if self._shard_id_list is not None
                else list(range(self.P)))

    def _ingest_subbatch(self, batch) -> None:
        """Ingest one split of a batch with the watchdog detached: a
        shard declared dead between splits would leave the batch half
        absorbed on the survivors. The probe stays at the outer batch's
        boundary."""
        wd = self._watchdog
        self._watchdog = None
        try:
            self.process_batch(batch)
        finally:
            self._watchdog = wd


    @property
    def _spill_active(self) -> bool:
        return self.max_device_slots > 0

    def _pmap_of(self, p: int) -> Optional[PagedSpillMap]:
        """Shard ``p``'s page map (None: the namespace layout)."""
        return None

    def spill_counters(self) -> Dict[str, int]:
        """Spill traffic summed over shards (zeros when unbudgeted; the
        paged layout adds its maps' counters)."""
        out = PagedSpillMap.zero_counters()
        for k, v in getattr(self, "_ns_counters", {}).items():
            out[k] += v
        return out

    # --------------------------------------- the namespace spill layout

    def _any_spilled(self, slice_ends) -> bool:
        return self._spill_active and any(
            int(se) in self.spills[p]
            for p in range(self.P) for se in slice_ends)

    def _touch(self, p: int, namespaces) -> None:
        self._touch_clock += 1
        clock = self._touch_clock
        touch = self._ns_touch[p]
        for ns in namespaces:
            touch[int(ns)] = clock

    def _make_headroom(self, p: int, needed: int, protect: set) -> None:
        while self.indexes[p].free_headroom() < needed:
            self._evict_cold(p, protect)

    def _reserve(self, p: int, keys: np.ndarray, nss: np.ndarray) -> None:
        """Make room on shard ``p`` for the NEW (key, ns) pairs among
        (keys, nss): one over-counting headroom check when there is room;
        otherwise a read-only probe counts the misses and cold namespaces
        leave, the namespaces of this batch protected."""
        if not self._spill_active:
            return
        uk, un, _ = unique_pairs(np.asarray(keys, dtype=np.int64),
                                 np.asarray(nss, dtype=np.int64))
        if self.indexes[p].free_headroom() >= len(uk):
            return
        needed = int((self.indexes[p].lookup(uk, un) < 0).sum())
        if needed:
            self._make_headroom(
                p, needed, protect={int(x) for x in np.unique(un)})

    def _evict_cold(self, p: int, protect: set) -> None:
        """Move shard ``p``'s least recently touched namespaces to its
        spill tier until an eighth of the shard (at least 1024 rows) is
        free: ONE ``[P, G]`` gather, ONE device-to-host copy and ONE
        ``[P, R]`` reset (the other shards' lanes pad at slot 0). The
        order is ``sorted(namespaces, key=touch)`` — stable over the
        registry's insertion order, as the reference's."""
        idx = self.indexes[p]
        target_free = max(idx.capacity // 8, 1024)
        touch = self._ns_touch[p]
        candidates = sorted(
            (ns for ns in idx.namespaces if int(ns) not in protect),
            key=lambda ns: touch.get(int(ns), 0))
        if not candidates:
            raise SlotTableFullError(
                f"shard {p}: device slot budget exhausted and every "
                "namespace in the current batch is protected — raise "
                "state.slot-table.max-device-slots or reduce batch size")
        chosen: List[Tuple[int, np.ndarray]] = []
        freed = 0
        for ns in candidates:
            if freed >= target_free:
                break
            slots = idx.slots_for_namespace(int(ns))
            chosen.append((int(ns), slots))
            freed += len(slots)
        empty = [ns for ns, s in chosen if len(s) == 0]
        if empty:
            idx.free_namespaces(empty)
        chosen = [(ns, s) for ns, s in chosen if len(s) > 0]
        if not chosen:
            return
        all_slots = np.concatenate([s for _, s in chosen])
        n = len(all_slots)
        G = sticky_bucket(n, self._gather_bucket)
        self._gather_bucket = G
        block = np.zeros((self.P, G), dtype=np.int32)
        block[p, :n] = all_slots
        leaves_host = [g[p][:n] for g in self._harvest_get(
            self._gather_step(self.accs, self._to_device(block)),
            "evict_harvest")]
        off = 0
        for ns, slots in chosen:
            m = len(slots)
            entry = {
                "key_id": np.asarray(idx.slot_key[slots]),
                **{f"leaf_{i}": leaves_host[i][off:off + m]
                   for i in range(len(leaves_host))},
            }
            self.spills[p].put(ns, entry,
                               dirty=bool(self._dirty[p, slots].any()))
            # replica: never-published rows going cold (see
            # _evict_cohorts)
            self._rep_note_cold(p, entry["key_id"],
                                np.full(m, int(ns), dtype=np.int64))
            off += m
            touch.pop(ns, None)
        self._ns_counters["pages_evicted"] += len(chosen)
        self._ns_counters["rows_evicted"] += n
        idx.free_namespaces([ns for ns, _ in chosen])
        self._dirty[p, all_slots] = False
        R = sticky_bucket(n, self._reset_bucket)
        self._reset_bucket = R
        rb = np.zeros((self.P, R), dtype=np.int32)
        rb[p, :n] = all_slots
        self.accs = self._reset_step(self.accs, self._to_device(rb))

    def _ensure_resident(self, per_shard: Dict[int, np.ndarray]) -> None:
        """Reload the spilled namespaces among each shard's touched set:
        headroom first for every shard, then ONE ``[P, B]`` put for all
        shards' rows. Reloaded rows keep the dirtiness they left with
        (``__was_dirty__``: not in any snapshot since)."""
        if not self._spill_active:
            return
        entries: Dict[int, List[Tuple[int, Dict[str, np.ndarray]]]] = {}
        rows: Dict[int, int] = {}
        for p, nss in per_shard.items():
            sp = self.spills[p]
            if len(sp) == 0:
                continue
            es = []
            for ns in nss:
                ns = int(ns)
                if ns in sp:
                    e = sp.pop(ns)
                    if e is not None and len(e["key_id"]):
                        es.append((ns, e))
            if es:
                entries[p] = es
                rows[p] = sum(len(e["key_id"]) for _, e in es)
        if not entries:
            return
        self._ns_counters["pages_reloaded"] += sum(
            len(es) for es in entries.values())
        self._ns_counters["rows_reloaded"] += sum(rows.values())
        for p, need in rows.items():
            self._make_headroom(
                p, need, protect={int(n) for n in per_shard[p]})
        B = sticky_bucket(max(rows.values()), self._reload_bucket)
        self._reload_bucket = B
        slot_block = np.zeros((self.P, B), dtype=np.int32)
        val_blocks = [np.full((self.P, B), l.identity, dtype=l.dtype)
                      for l in self.agg.leaves]
        for p, es in entries.items():
            keys = np.concatenate([
                np.asarray(e["key_id"], dtype=np.int64) for _, e in es])
            nss = np.concatenate([
                np.full(len(e["key_id"]), ns, dtype=np.int64)
                for ns, e in es])
            n = len(keys)
            slots = self.indexes[p].lookup_or_insert(keys, nss)
            slot_block[p, :n] = slots
            for i, l in enumerate(self.agg.leaves):
                np.concatenate(
                    [np.asarray(e[f"leaf_{i}"], dtype=l.dtype)
                     for _, e in es],
                    out=val_blocks[i][p, :n])
            self._dirty[p, slots] = np.concatenate([
                np.full(len(e["key_id"]),
                        bool(e.get("__was_dirty__", False)), dtype=bool)
                for _, e in es])
            self._touch(p, [ns for ns, _ in es])
        self.accs = self._put_step(
            self.accs, self._to_device(slot_block),
            tuple(self._to_device(v) for v in val_blocks))

    def _drop_spilled(self, ends) -> None:
        """Discard spilled namespaces (fired and expired, or merged away)
        and their touch clocks."""
        if not self._spill_active:
            return
        for p in range(self.P):
            sp, touch = self.spills[p], self._ns_touch[p]
            for e in ends:
                if int(e) in sp:
                    sp.drop(int(e))
                touch.pop(int(e), None)

    def _spill_restore_rows(self, key_ids: np.ndarray,
                            namespaces: np.ndarray,
                            leaves: List[np.ndarray]) -> None:
        """Restore under a budget: each shard's rows land in its spill
        tier, one entry per namespace, and reload on first access — a
        snapshot larger than the device budget restores with bounded
        device memory."""
        shards = self._route(key_ids)
        for p in range(self.P):
            mask = shards == p
            if not mask.any():
                continue
            ns_p = namespaces[mask]
            order = np.argsort(ns_p, kind="stable")
            s_ns, s_keys = ns_p[order], key_ids[mask][order]
            s_leaves = [l[mask][order] for l in leaves]
            bounds = np.nonzero(np.diff(s_ns))[0] + 1
            starts = np.concatenate(([0], bounds))
            ends = np.concatenate((bounds, [len(s_ns)]))
            sp = self.spills[p]
            for a, b in zip(starts.tolist(), ends.tolist()):
                ns = int(s_ns[a])
                entry = {"key_id": s_keys[a:b],
                         **{f"leaf_{i}": s_leaves[i][a:b]
                            for i in range(len(s_leaves))}}
                if ns in sp:
                    sp.drop(ns)
                sp.put(ns, entry, dirty=False)

    # ------------------------------------------------------ snapshot/restore

    def _snapshot_table(self, mode: str) -> Dict[str, np.ndarray]:
        """The logical table: every shard's used rows (in shard order), then
        every spilled row. mode "delta": dirty rows and tombstones only;
        "savepoint" keeps the dirty tracking. The planes are read with ONE
        synchronous copy queued behind everything dispatched so far."""
        if mode == "delta":
            return self._snapshot_delta()
        accs_host = harvest_to_host(self.accs)
        parts = []
        for p in range(self.P):
            idx = self.indexes[p]
            used = idx.used_slots()
            key_ids = idx.slot_key[used]
            parts.append({
                "key_id": key_ids,
                "namespace": idx.slot_ns[used],
                "key_group": assign_key_groups(key_ids,
                                               self.max_parallelism),
                **{f"leaf_{i}": accs_host[i][p][used]
                   for i in range(len(self.accs))},
            })
        parts.extend(self._spill_snapshot_parts())
        merged = {k: np.concatenate([pt[k] for pt in parts])
                  for k in parts[0]}
        if mode != "savepoint":
            self._clear_tracking()
        return merged

    def _clear_tracking(self) -> None:
        self._dirty[:] = False
        self._freed_ns.clear()
        for sp in self.spills:
            sp.clear_dirty()

    def _snapshot_delta(self) -> Dict[str, np.ndarray]:
        """Dirty rows gathered off the planes in ONE ``[P, G]`` gather and
        one device-to-host copy, plus the freed-namespace tombstones (the
        format of ``SlotTable.snapshot_delta``)."""
        per_shard = []
        g_max = 0
        for p in range(self.P):
            used = self.indexes[p].slot_used
            dirty = np.nonzero(self._dirty[p][:len(used)]
                               & used)[0].astype(np.int32)
            per_shard.append(dirty)
            g_max = max(g_max, len(dirty))
        freed = (np.unique(np.concatenate(self._freed_ns))
                 if self._freed_ns else np.empty(0, dtype=np.int64))
        if g_max == 0:
            out = {
                "__delta__": np.asarray(True),
                "key_id": np.empty(0, dtype=np.int64),
                "namespace": np.empty(0, dtype=np.int64),
                "key_group": np.empty(0, dtype=np.int32),
                "freed_namespaces": freed,
                **{f"leaf_{i}": np.empty(0, dtype=l.dtype)
                   for i, l in enumerate(self.agg.leaves)},
            }
        else:
            G = sticky_bucket(g_max, self._gather_bucket)
            self._gather_bucket = G
            block = np.zeros((self.P, G), dtype=np.int32)
            for p, dirty in enumerate(per_shard):
                block[p, :len(dirty)] = dirty
            leaves_host = harvest_to_host(
                self._gather_step(self.accs, self._to_device(block)))
            key_cols, ns_cols = [], []
            leaf_cols = [[] for _ in leaves_host]
            for p, dirty in enumerate(per_shard):
                m = len(dirty)
                if m == 0:
                    continue
                idx = self.indexes[p]
                key_cols.append(idx.slot_key[dirty])
                ns_cols.append(idx.slot_ns[dirty])
                for i, lh in enumerate(leaves_host):
                    leaf_cols[i].append(lh[p][:m])
            key_ids = np.concatenate(key_cols)
            out = {
                "__delta__": np.asarray(True),
                "key_id": key_ids,
                "namespace": np.concatenate(ns_cols),
                "key_group": assign_key_groups(key_ids,
                                               self.max_parallelism),
                "freed_namespaces": freed,
                **{f"leaf_{i}": np.concatenate(cols)
                   for i, cols in enumerate(leaf_cols)},
            }
        self._spill_delta_append(out)
        self._dirty[:] = False
        self._freed_ns.clear()
        return out

    def _spill_snapshot_parts(self) -> List[Dict[str, np.ndarray]]:
        """Logical rows of every shard's spill tier (``spilled_rows``)."""
        return [self._spill_part(p, dirty_only=False)
                for p in range(self.P)] if self._spill_active else []

    def _spill_part(self, p: int, dirty_only: bool) -> Dict[str, np.ndarray]:
        keys, nss, leaves = spilled_rows(self.spills[p], self._pmap_of(p),
                                         self.agg.leaves,
                                         dirty_only=dirty_only)
        key_ids = np.concatenate([np.empty(0, np.int64), *keys])
        return {"key_id": key_ids,
                "namespace": np.concatenate([np.empty(0, np.int64), *nss]),
                "key_group": assign_key_groups(key_ids, self.max_parallelism),
                **{f"leaf_{i}": np.concatenate([np.empty(0, l.dtype),
                                                *leaves[i]])
                   for i, l in enumerate(self.agg.leaves)}}

    def _spill_delta_append(self, out: Dict[str, np.ndarray]) -> None:
        """Append the spilled-but-dirty rows to a delta snapshot and clear
        the tiers' dirtiness."""
        if not self._spill_active:
            return
        for p in range(self.P):
            part = self._spill_part(p, dirty_only=True)
            for k, v in part.items():
                out[k] = np.concatenate([out[k], v])
            self.spills[p].clear_dirty()

    def _restore_table(self, table: Dict[str, np.ndarray],
                       key_group_filter=None) -> None:
        """Restore logical rows, re-sharded by key group: each row goes to
        the shard its key's ingest routes to (any snapshot restores at any
        P). With a budget the rows land in the spill tier (pages, or one
        entry per namespace) and reload on access; otherwise every
        shard's rows go onto the planes in ONE ``[P, B]`` put (the index
        allocates from slot 1, so slot 0 is never written with state)."""
        # restored values bypass the scatter sites: the replica shadow is
        # stale wholesale — republish everything at the next boundary
        self._rep_rebuild = True
        key_ids = np.asarray(table.get("key_id", []), dtype=np.int64)
        namespaces = np.asarray(table.get("namespace", []), dtype=np.int64)
        leaves = [np.asarray(table[f"leaf_{i}"]) if len(key_ids) else None
                  for i in range(len(self.agg.leaves))]
        if key_group_filter is not None and len(key_ids):
            groups = assign_key_groups(key_ids, self.max_parallelism)
            keep = np.isin(groups, np.asarray(sorted(key_group_filter)))
            key_ids, namespaces = key_ids[keep], namespaces[keep]
            leaves = [v[keep] for v in leaves]
        if self._spill_active and len(key_ids):
            if self._paged:
                self._paged_restore_rows(key_ids, namespaces, leaves)
            else:
                self._spill_restore_rows(key_ids, namespaces, leaves)
        elif len(key_ids):
            shards = self._route(key_ids)
            # inserts first: growth must settle before the put is staged
            per_shard: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
            for p in range(self.P):
                sel = np.nonzero(shards == p)[0]
                if len(sel):
                    per_shard[p] = (sel, self.indexes[p].lookup_or_insert(
                        key_ids[sel], namespaces[sel]))
            self._land_resident(per_shard, leaves)
        # restored state IS the new incremental base
        self._clear_tracking()

    # ------------------------------------------------ live rescale (reshard)

    #: live rescales completed since construction
    reshards_completed: int = 0
    #: report of the most recent reshard (None until the first)
    last_reshard: Optional[Dict[str, object]] = None
    #: report of the most recent shard loss (None until the first)
    last_shard_loss: Optional[Dict[str, object]] = None

    def _make_shard_indexes(self) -> List:
        """Fresh per-shard host indexes at the CURRENT ``P`` and
        capacity (construction and the mesh rebuild)."""
        return [
            make_slot_index(
                self.capacity, growable=True,
                on_grow=lambda old, new: self._shard_index_grew(new),
                max_capacity=self.max_device_slots,
                track_namespaces=getattr(self, "_track_ns", True),
                full_hint=("state spills to host beyond "
                           "state.slot-table.max-device-slots"
                           if self.max_device_slots
                           else "raise state.slot-table.capacity"))
            for _ in range(self.P)
        ]

    def _reserve_rows(self, rows: int) -> None:
        if self._memory is not None:
            manager, owner = self._memory
            manager.reserve(owner, rows * sum(
                np.dtype(leaf.dtype).itemsize for leaf in self.agg.leaves))

    def release_memory(self) -> None:
        """Return the planes' reservation to the pool (dispose path)."""
        if self._memory is not None:
            manager, owner = self._memory
            manager.release_all(owner)

    def shard_resident_rows(self) -> List[int]:
        """Device-resident rows per shard (the indexes' used counters:
        the quota ledger reads this every scheduler quantum)."""
        return [int(idx.num_used) for idx in self.indexes]

    def key_imbalance(self) -> float:
        """max/mean resident rows per shard (1.0 = balanced): the one
        definition the ``state.key_imbalance`` gauge and the scaling
        policy's skew guard share (``autoscale.policy.key_imbalance``)."""
        from flink_tpu_torch.autoscale.policy import key_imbalance

        return key_imbalance(self.shard_resident_rows())

    def _fresh_planes(self) -> Tuple[torch.Tensor, ...]:
        """``[P, capacity]`` identity planes, one per accumulator leaf
        (their footprint replaces any earlier reservation)."""
        self.release_memory()
        self._reserve_rows(self.P * self.capacity)
        return tuple(
            torch.full((self.P, self.capacity),
                       np.asarray(leaf.identity).item(),
                       dtype=torch_dtype(leaf.dtype), device=self.device)
            for leaf in self.agg.leaves)

    def reshard(self, new_shards: int, devices=None) -> Dict[str, object]:
        """LIVE key-group migration to ``new_shards`` logical shards: the
        dispatch fences drain, every logical row (resident and spilled)
        lifts off the planes with its dirtiness and recency, the
        ``[new_shards, capacity]`` planes and everything sized by P are
        rebuilt, and the rows land on their new owners — resident rows in
        ONE put, cold rows in the new shards' spill tiers. Window and
        session metadata is global host state and never moves; the next
        delta checkpoint is what it would have been without the move.

        Callers must have harvested in-flight async fires first. Not
        exception-atomic: a failure mid-handoff (an injected
        ``rescale.handoff`` fault) leaves the engine unusable, and the
        failover path is a checkpoint restore. ``devices``: the
        reference's device list has no counterpart on one card; only
        None is accepted."""
        if devices is not None:
            raise ValueError(
                "devices=: the logical shards of one card have no device "
                "list (LogicalMesh)")
        new_shards = int(new_shards)
        if new_shards < 1:
            raise ValueError(f"new_shards must be >= 1, got {new_shards}")
        if new_shards == self.P:
            return {"from": self.P, "to": self.P, "rows_moved": 0,
                    "resident_rows": 0, "spilled_rows": 0,
                    "seconds": 0.0, "noop": True}
        if self.max_parallelism < new_shards:
            raise ValueError(
                f"cannot reshard to {new_shards} shards: max_parallelism "
                f"{self.max_parallelism} bounds the shard count (the "
                "key-group space cannot be split finer)")
        if self.key_group_range is not None:
            first, last = self.key_group_range
            span = int(last) - int(first) + 1
            if span < new_shards:
                raise ValueError(
                    f"cannot reshard to {new_shards} shards: this engine "
                    f"owns only {span} key groups "
                    f"[{int(first)}, {int(last)}]")
        t0 = time.perf_counter()
        with flight.span("reshard.handoff"):
            self._quiesce()
            chaos.fault_point("rescale.handoff", stage="drain",
                              from_shards=self.P, to_shards=new_shards)
            rows = self._collect_handoff()
            old_p = self.P
            self._shard_id_list = None
            # a rebalanced table is defined over the OLD shard count: the
            # lifted rows re-route by the contiguous formula (the
            # rebalancer re-detects on the new mesh if the skew persists)
            self._assignment = None
            self._rebuild_mesh_plane(new_shards)
            # the hardest crash point: old state lifted, new planes empty
            chaos.fault_point("rescale.handoff", stage="commit",
                              from_shards=old_p, to_shards=new_shards)
            resident_rows, spilled_rows = self._redistribute_handoff(rows)
        if self._watchdog is not None:
            self._watchdog.rebind(self.P, self._shard_ids())
        self.reshards_completed += 1
        self.last_reshard = {
            "from": old_p, "to": new_shards,
            "rows_moved": int(len(rows["key_id"])),
            "resident_rows": resident_rows,
            "spilled_rows": spilled_rows,
            "seconds": time.perf_counter() - t0,
        }
        return self.last_reshard

    def reassign_key_groups(self, assignment) -> Dict[str, object]:
        """LIVE hot-range rebalance: move key groups BETWEEN shards at a
        batch boundary without changing P. The reshard's handoff (drain
        the fences -> lift every row -> rebuild the planes ->
        redistribute by the NEW routing), with the chaos point
        ``rebalance.handoff`` at ``drain`` and at ``commit``. Not
        exception-atomic: a crash mid-handoff recovers by checkpoint
        restore (snapshots are key-id addressed and carry no assignment,
        so the restoring engine routes by its own)."""
        from flink_tpu_torch.state.keygroups import KeyGroupAssignment

        if not isinstance(assignment, KeyGroupAssignment):
            raise TypeError(
                f"expected KeyGroupAssignment, got {type(assignment).__name__}")
        if assignment.num_shards != self.P:
            raise ValueError(
                f"assignment is for {assignment.num_shards} shards, "
                f"engine has {self.P} — rebalance moves groups, "
                "reshard() changes P")
        if self.key_group_range is not None:
            first = int(self.key_group_range[0])
            span = int(self.key_group_range[1]) - first + 1
        else:
            first, span = 0, self.max_parallelism
        if assignment.first != first or assignment.span != span:
            raise ValueError(
                f"assignment covers groups [{assignment.first}, "
                f"{assignment.first + assignment.span - 1}], engine owns "
                f"[{first}, {first + span - 1}]")
        moved = np.nonzero(
            assignment.table != self.key_group_assignment.table)[0]
        if len(moved) == 0:
            return {"groups_moved": 0, "rows_moved": 0,
                    "resident_rows": 0, "spilled_rows": 0,
                    "seconds": 0.0, "noop": True}
        t0 = time.perf_counter()
        with flight.span("reshard.handoff"):
            self._quiesce()
            chaos.fault_point("rebalance.handoff", stage="drain",
                              groups_moved=len(moved))
            rows = self._collect_handoff()
            # the table goes in BEFORE the redistribution: _route sends
            # the lifted rows to their NEW owners
            self._assignment = (None if assignment.is_contiguous
                                else assignment)
            self._rebuild_mesh_plane(self.P)
            chaos.fault_point("rebalance.handoff", stage="commit",
                              groups_moved=len(moved))
            resident_rows, spilled_rows = self._redistribute_handoff(rows)
        self.rebalances_completed += 1
        self.last_rebalance = {
            "groups_moved": int(len(moved)),
            "rows_moved": int(len(rows["key_id"])),
            "resident_rows": resident_rows,
            "spilled_rows": spilled_rows,
            "seconds": time.perf_counter() - t0,
        }
        return self.last_rebalance

    @property
    def key_group_assignment(self):
        """The EFFECTIVE assignment (the live table, or the contiguous
        default): what serving-side ``host_of_key_group`` routing
        follows after a rebalance."""
        from flink_tpu_torch.state.keygroups import KeyGroupAssignment

        if self._assignment is not None:
            return self._assignment
        return KeyGroupAssignment.contiguous(
            self.P, self.max_parallelism, self.key_group_range)

    def _collect_handoff(self, skip_shards=()) -> Dict[str, np.ndarray]:
        """Lift every logical row off the current mesh: key, namespace and
        leaf columns plus what restore does not need — per-row dirtiness
        (delta snapshots), recency clocks (who stays resident on a scale-
        down) and residency. ``skip_shards``: shards whose state must NOT
        be read (a lost shard: its range restores from its unit)."""
        leaves = self.agg.leaves
        paged = self._paged
        accs_host = harvest_to_host(self.accs)  # ONE device-to-host copy
        keys: List[np.ndarray] = []
        nss: List[np.ndarray] = []
        dirty: List[np.ndarray] = []
        touch: List[np.ndarray] = []
        resident: List[np.ndarray] = []
        leaf_cols: List[List[np.ndarray]] = [[] for _ in leaves]
        skip = set(skip_shards)
        for p in range(self.P):
            if p in skip:
                continue
            idx = self.indexes[p]
            used = idx.used_slots()
            if len(used):
                u_ns = np.asarray(idx.slot_ns[used], dtype=np.int64)
                keys.append(np.asarray(idx.slot_key[used], dtype=np.int64))
                nss.append(u_ns)
                dirty.append(np.asarray(self._dirty[p][used], dtype=bool))
                if paged:
                    touch.append(self._slot_touch[p][used].copy())
                else:
                    nt = self._ns_touch[p]
                    touch.append(np.asarray(
                        [nt.get(int(x), 0) for x in u_ns], dtype=np.int64))
                resident.append(np.ones(len(used), dtype=bool))
                for i in range(len(leaves)):
                    leaf_cols[i].append(accs_host[i][p][used])
            sp = self.spills[p]
            if len(sp) == 0:
                continue
            dirty_set = set(sp.dirty_namespaces())
            pmap = self._pmaps[p] if paged else None
            for ns in sp.namespaces:
                entry = sp.peek(int(ns))
                if entry is None:
                    continue
                ekeys = np.asarray(entry["key_id"], dtype=np.int64)
                if "ns" in entry:  # a page: per-row ns and tombstones
                    rns = np.asarray(entry["ns"], dtype=np.int64)
                    alive = pmap.live_row_mask(int(ns), rns)
                    if not alive.any():
                        continue
                    ekeys, rns = ekeys[alive], rns[alive]
                    # only rows no snapshot shipped since their eviction
                    # are still dirty (the tier flag gates, the per-row
                    # column refines)
                    row_dirty = (
                        np.asarray(entry["dirty"], dtype=bool)[alive]
                        if int(ns) in dirty_set
                        else np.zeros(len(ekeys), dtype=bool))
                    sel = alive
                else:
                    rns = np.full(len(ekeys), int(ns), dtype=np.int64)
                    row_dirty = np.full(len(ekeys), int(ns) in dirty_set,
                                        dtype=bool)
                    sel = slice(None)
                if len(ekeys) == 0:
                    continue
                keys.append(ekeys)
                nss.append(rns)
                dirty.append(row_dirty)
                touch.append(np.zeros(len(ekeys), dtype=np.int64))
                resident.append(np.zeros(len(ekeys), dtype=bool))
                for i, l in enumerate(leaves):
                    leaf_cols[i].append(
                        np.asarray(entry[f"leaf_{i}"], dtype=l.dtype)[sel])
        if not keys:
            return {
                "key_id": np.empty(0, dtype=np.int64),
                "namespace": np.empty(0, dtype=np.int64),
                "dirty": np.empty(0, dtype=bool),
                "touch": np.empty(0, dtype=np.int64),
                "resident": np.empty(0, dtype=bool),
                **{f"leaf_{i}": np.empty(0, dtype=l.dtype)
                   for i, l in enumerate(leaves)},
            }
        return {
            "key_id": np.concatenate(keys),
            "namespace": np.concatenate(nss),
            "dirty": np.concatenate(dirty),
            "touch": np.concatenate(touch),
            "resident": np.concatenate(resident),
            **{f"leaf_{i}": np.concatenate(leaf_cols[i])
               for i in range(len(leaves))},
        }

    def _rebuild_mesh_plane(self, new_shards: int) -> None:
        """Re-point the engine at fresh ``[new_shards, capacity]`` planes
        and EVERYTHING sized by P: the logical mesh, the per-shard indexes
        and spill tiers (page maps and slot touch clocks), the staging
        pool and its fences, the step closures (the exchange+scatter
        captures P), the dirty bits and the sticky buckets. A stale one
        would route rows into the wrong plane without an error.
        Job-lifetime state survives: the recency clock, the spill
        counters and the delta tombstones."""
        # the replica's metadata shadow describes the OLD plane — the
        # next boundary publish rebuilds it over the new mesh
        self._rep_rebuild = True
        self.mesh = LogicalMesh(int(new_shards), self.device)
        self.P = int(new_shards)
        t = self.host_topology
        if t is not None and t.num_shards != self.P:
            # a reshard or a partial failover changed the shard count:
            # the (hosts, local) factorization no longer describes the
            # mesh, so ingest falls back to the flat exchange
            self.host_topology = None
        clock = self._touch_clock
        # the old tiers' file-backed entries would be orphaned on disk
        # (the collect only peeks): reclaim them before the rebuild
        for sp in self.spills:
            for ns in list(sp.namespaces):
                sp.discard(int(ns))
        if self._paged:
            # the outgoing maps' lifetime counters join the engine-held
            # ones spill_counters() also sums
            for pm in self._pmaps:
                for k, v in pm.counters().items():
                    self._ns_counters[k] += v
        self.accs = ()  # the old planes go before the new ones come
        self.indexes = self._make_shard_indexes()
        self._init_spill(self._spill_dir, self._spill_host_max_bytes)
        self._touch_clock = clock
        if self._paged:
            self._init_paged()
        self.accs = self._fresh_planes()
        self._build_steps()
        self._dirty = np.zeros((self.P, self.capacity), dtype=bool)
        self._gather_bucket = 0
        self._reset_bucket = 0
        self._fire_bucket = 0
        self._merge_bucket = 0

    def _land_resident(self, per_shard: Dict[int, Tuple[np.ndarray,
                                                        np.ndarray]],
                       leaves: List[np.ndarray]) -> None:
        """ONE ``[P, B]`` put of every shard's rows: ``per_shard`` maps a
        shard to (row positions into ``leaves``, their resolved slots)."""
        B = sticky_bucket(max(len(sel) for sel, _ in per_shard.values()),
                          self._reload_bucket)
        self._reload_bucket = B
        slot_block = np.zeros((self.P, B), dtype=np.int32)
        val_blocks = [np.full((self.P, B), l.identity, dtype=l.dtype)
                      for l in self.agg.leaves]
        for p, (sel, slots) in per_shard.items():
            m = len(sel)
            slot_block[p, :m] = slots
            for vb, vals in zip(val_blocks, leaves):
                vb[p, :m] = vals[sel]
        self.accs = self._put_step(
            self.accs, self._to_device(slot_block),
            tuple(self._to_device(v) for v in val_blocks))

    def _redistribute_handoff(
            self, rows: Dict[str, np.ndarray]) -> Tuple[int, int]:
        """Land the collected rows on their new owners (the key-group
        routing). Returns (resident_rows, spilled_rows). Under a device
        budget previously resident rows stay resident while they fit; on
        a scale-down the hottest (by carried recency) win and the overflow
        lands in the new shard's spill tier — per NAMESPACE in the
        namespace layout (its eviction unit), per ROW in the paged one.
        Rows land through a put, never a fold, with their dirtiness."""
        leaves = self.agg.leaves
        keys = rows["key_id"]
        nss = rows["namespace"]
        if len(keys) == 0:
            return 0, 0
        paged = self._paged
        shards = self._route(keys)
        stay = rows["resident"].copy()
        if self._spill_active:
            # slot 0 is the reserved identity row
            budget = self.max_device_slots - 1
            if paged:
                for p in range(self.P):
                    sel = np.nonzero(stay & (shards == p))[0]
                    if len(sel) > budget:
                        order = np.argsort(rows["touch"][sel],
                                           kind="stable")
                        stay[sel[order[: len(sel) - budget]]] = False
            else:
                for p in range(self.P):
                    sel = np.nonzero(shards == p)[0]
                    if not len(sel):
                        continue
                    uniq, inv = np.unique(nss[sel], return_inverse=True)
                    grp_res = np.zeros(len(uniq), dtype=bool)
                    np.logical_or.at(grp_res, inv, rows["resident"][sel])
                    grp_touch = np.zeros(len(uniq), dtype=np.int64)
                    np.maximum.at(grp_touch, inv, rows["touch"][sel])
                    grp_rows = np.bincount(inv, minlength=len(uniq))
                    stay_grp = np.zeros(len(uniq), dtype=bool)
                    free = budget
                    cand = np.nonzero(grp_res)[0]
                    for g in cand[np.argsort(-grp_touch[cand],
                                             kind="stable")].tolist():
                        if grp_rows[g] <= free:
                            stay_grp[g] = True
                            free -= int(grp_rows[g])
                    stay[sel] = stay_grp[inv]
        leaf_vals = [rows[f"leaf_{i}"] for i in range(len(leaves))]
        # resident rows: every slot resolved FIRST (inserts may grow the
        # planes), then all shards' values in ONE put
        per_shard: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for p in range(self.P):
            sel = np.nonzero(stay & (shards == p))[0]
            if len(sel):
                per_shard[p] = (sel, self.indexes[p].lookup_or_insert(
                    keys[sel], nss[sel]))
        if per_shard:
            for p, (sel, slots) in per_shard.items():
                self._dirty[p, slots] = rows["dirty"][sel]
                if paged:
                    self._slot_touch[p][slots] = rows["touch"][sel]
                elif self._spill_active:
                    self._touch(p, np.unique(nss[sel]).tolist())
            self._land_resident(per_shard, leaf_vals)
        # cold rows re-home in the new shards' spill tiers, dirtiness kept
        cold_total = 0
        cold = ~stay
        if cold.any():
            for p in range(self.P):
                sel = np.nonzero(cold & (shards == p))[0]
                if not len(sel):
                    continue
                cold_total += len(sel)
                c_keys, c_nss = keys[sel], nss[sel]
                c_dirty = rows["dirty"][sel]
                c_leaves = [v[sel] for v in leaf_vals]
                if paged:
                    restore_into_pages(
                        self.spills[p], self._pmaps[p], c_keys, c_nss,
                        c_leaves,
                        page_rows=max(self.indexes[p].capacity // 8, 1024),
                        dirty=c_dirty)
                else:
                    order = np.argsort(c_nss, kind="stable")
                    s_ns, s_keys = c_nss[order], c_keys[order]
                    s_dirty = c_dirty[order]
                    s_leaves = [l[order] for l in c_leaves]
                    bounds = np.nonzero(np.diff(s_ns))[0] + 1
                    starts = np.concatenate(([0], bounds))
                    stops = np.concatenate((bounds, [len(s_ns)]))
                    sp = self.spills[p]
                    for a, b in zip(starts.tolist(), stops.tolist()):
                        entry = {"key_id": s_keys[a:b],
                                 **{f"leaf_{i}": s_leaves[i][a:b]
                                    for i in range(len(leaves))}}
                        sp.put(int(s_ns[a]), entry,
                               dirty=bool(s_dirty[a:b].any()))
        return int(stay.sum()), cold_total

    # ---------------------------------------------- partial failover (shard)

    def shard_key_groups(self) -> List[Tuple[int, int]]:
        """GLOBAL ``(first, last)`` inclusive key groups per shard — the
        unit of failure and recovery, and the split shard-granular
        checkpoints key their units by (the inverse of ``_route``).
        Undefined under a live rebalanced assignment (a shard's groups
        are no longer one range): :meth:`shard_key_group_runs` there."""
        if self._assignment is not None:
            raise ValueError(
                "shard->key-group ownership is non-contiguous under a "
                "live rebalanced assignment — shard_key_group_runs() "
                "gives the per-run decomposition")
        return shard_key_group_ranges(self.P, self.max_parallelism,
                                      self.key_group_range)

    def shard_key_group_runs(self) -> List[Tuple[int, int, int]]:
        """GLOBAL ``(first, last, shard)`` maximal same-shard runs in
        key-group order — the checkpoint-unit granularity (one run per
        shard on the contiguous layout, the table's runs under a live
        assignment)."""
        if self._assignment is not None:
            return self._assignment.runs()
        return [(g0, g1, p) for p, (g0, g1)
                in enumerate(self.shard_key_groups())]

    def lose_shard(self, dead: int) -> Tuple[int, int]:
        """Simulated loss of shard ``dead``: its plane rows, spill tier
        and key-range metadata are gone wholesale. The survivors' fences
        land, their rows lift intact (dirtiness and recency kept — the
        reshard machinery), the mesh rebuilds over ``P - 1`` shards, and
        the survivors' rows land on their new owners. Returns the dead
        shard's (first, last) key groups: the caller restores that range
        from its checkpoint unit (:meth:`restore_key_groups`) and replays
        only that range's records from the unit's source position."""
        return self.lose_shards([dead])

    def lose_shards(self, dead) -> Tuple[int, int]:
        """Loss of a CONTIGUOUS set of shards in one evacuation (their
        merged key-group span is one range, so the bounded replay is one
        contiguous range). Not exception-atomic: a failure mid-evacuation
        falls back to a whole-job restore. Refused under a live
        rebalanced assignment: a dead shard's groups are no longer one
        range, so the bounded contiguous replay does not hold."""
        if self._assignment is not None:
            raise ValueError(
                "partial failover under a live rebalanced assignment is "
                "not supported: a dead shard's groups are no longer one "
                "contiguous range, so the bounded contiguous replay "
                "contract does not hold — whole-job restore applies")
        dead_set = sorted({int(d) for d in dead})
        if not dead_set:
            raise ValueError("no shards to lose")
        for d in dead_set:
            if not (0 <= d < self.P):
                raise ValueError(f"no shard {d} on a {self.P}-shard mesh")
        if dead_set != list(range(dead_set[0], dead_set[-1] + 1)):
            raise ValueError(
                f"dead shards must be contiguous, got {dead_set}")
        if len(dead_set) >= self.P:
            raise ValueError(
                "cannot partially fail over the whole mesh — whole-job "
                "restore applies")
        t0 = time.perf_counter()
        ranges = self.shard_key_groups()
        dead_range = (int(ranges[dead_set[0]][0]),
                      int(ranges[dead_set[-1]][1]))
        # quiesce the survivors: every dispatched batch lands before the
        # planes are torn down (the dead shards' rows are never read)
        self._quiesce()
        rows = self._collect_handoff(skip_shards=set(dead_set))
        t1 = time.perf_counter()
        ids = self._shard_ids()
        old_p = self.P
        self._shard_id_list = [s for i, s in enumerate(ids)
                               if i not in dead_set]
        self._rebuild_mesh_plane(old_p - len(dead_set))
        t2 = time.perf_counter()
        resident_rows, spilled_rows = self._redistribute_handoff(rows)
        # the dead ranges' host metadata dies with their shards (the
        # session engine's intervals; the window engines' book is global)
        self._drop_meta_key_groups(range(dead_range[0], dead_range[1] + 1))
        if self._watchdog is not None:
            # survivors renumber 0..P-k-1 and keep their identities; the
            # dead ones stay in the quarantine history
            self._watchdog.rebind(self.P, self._shard_ids())
        t3 = time.perf_counter()
        self.last_shard_loss = {
            "dead_shard": dead_set[0], "dead_shards": dead_set,
            "dead_ids": [ids[d] for d in dead_set],
            "from": old_p, "to": self.P,
            "key_groups": dead_range,
            "survivor_rows": int(len(rows["key_id"])),
            "resident_rows": resident_rows,
            "spilled_rows": spilled_rows,
            "evacuate_seconds": t1 - t0,
            "rebuild_seconds": t2 - t1,
            "land_seconds": t3 - t2,
            "seconds": t3 - t0,
        }
        return dead_range

    def restore_key_groups(self, snap: Dict[str, object], groups) -> int:
        """Partial restore INTO a live engine: land only ``groups``' rows
        (survivors untouched) and merge the unit's metadata (the engine
        hook rolls the watermark and staleness guards back to the
        checkpoint, so the range's replayed records are accepted).
        Restored rows are CLEAN — they are in the checkpoint; survivors
        keep their dirtiness. Returns rows restored."""
        # restored values bypass the scatter sites — republish wholesale
        self._rep_rebuild = True
        table = snap.get("table", {}) or {}
        key_ids = np.asarray(table.get("key_id", []), dtype=np.int64)
        gset = np.asarray(sorted(int(g) for g in groups), dtype=np.int64)
        n_restored = 0
        if len(key_ids):
            kg = table.get("key_group")
            kg = (np.asarray(kg, dtype=np.int64) if kg is not None
                  else assign_key_groups(key_ids, self.max_parallelism))
            keep = np.isin(kg, gset)
            key_ids = key_ids[keep]
            namespaces = np.asarray(table["namespace"],
                                    dtype=np.int64)[keep]
            leaves = [np.asarray(table[f"leaf_{i}"])[keep]
                      for i in range(len(self.agg.leaves))]
            n_restored = int(len(key_ids))
        if n_restored:
            shards = self._route(key_ids)
            if self._paged:
                for p in range(self.P):
                    mask = shards == p
                    if not mask.any():
                        continue
                    # APPEND: the survivors' pages stay intact; the
                    # restored namespaces were never in the surviving tiers
                    restore_into_pages(
                        self.spills[p], self._pmaps[p], key_ids[mask],
                        namespaces[mask], [l[mask] for l in leaves],
                        page_rows=max(self.indexes[p].capacity // 8, 1024),
                        append=True)
            else:
                # resident: all slots resolved first (growth settles),
                # then ONE put for all shards
                per_shard: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
                for p in range(self.P):
                    mask = shards == p
                    if not mask.any():
                        continue
                    if self._spill_active:
                        self._reserve(p, key_ids[mask], namespaces[mask])
                    slots = self.indexes[p].lookup_or_insert(
                        key_ids[mask], namespaces[mask])
                    per_shard[p] = (np.nonzero(mask)[0], slots)
                for p, (sel, slots) in per_shard.items():
                    self._dirty[p, slots] = False
                    if self._spill_active:
                        self._touch(p, np.unique(namespaces[sel]).tolist())
                self._land_resident(per_shard, leaves)
        self._merge_restored_meta(snap, groups)
        return n_restored

    # engine hooks (the window engine: its global book; the session
    # engine: per-key interval metadata) ----------------------------------

    def _drop_meta_key_groups(self, groups) -> None:
        """Discard the host metadata owned by ``groups`` (no-op for an
        engine whose lifecycle metadata carries no per-key state)."""

    def _merge_restored_meta(self, snap: Dict[str, object],
                             groups) -> None:
        """Fold a checkpoint unit's metadata for ``groups`` into the live
        engine (partial failover)."""

    def _filter_meta_snapshot(self, snap: Dict[str, object],
                              groups) -> Dict[str, object]:
        """The non-table part of ``snap`` restricted to ``groups`` — by
        default global metadata replicates whole into every unit."""
        return {k: v for k, v in snap.items() if k != "table"}

    def _merge_meta_snapshots(self, units: List[Dict[str, object]]
                              ) -> Dict[str, object]:
        """Merge units' metadata for a whole-job restore assembled from
        (possibly different-age) shard units."""
        raise NotImplementedError

    #: delta and tombstone fields that replicate whole into every unit:
    #: another range's tombstones are a no-op on a unit's base, and each
    #: unit stays independently restorable
    _UNIT_PASSTHROUGH = ("__delta__", "freed_namespaces",
                         "tombstone_key_id", "tombstone_namespace")

    def snapshot_sharded(self, mode: str = "full"
                         ) -> Dict[Tuple[int, int], Dict[str, object]]:
        """One independently restorable unit per shard: the logical
        snapshot split by the shards' key-group ranges (rows by their
        ``key_group`` column), plus each unit's slice of the metadata.
        The union of the units is exactly ``snapshot(mode)``."""
        snap = self.snapshot(mode)
        table = snap.get("table", {}) or {}
        kg = np.asarray(table.get("key_group", ()), dtype=np.int64)
        units: Dict[Tuple[int, int], Dict[str, object]] = {}
        for g0, g1, _p in self.shard_key_group_runs():
            if len(kg):
                mask = (kg >= g0) & (kg <= g1)
                unit_table = {
                    k: (v if k in self._UNIT_PASSTHROUGH
                        else np.asarray(v)[mask])
                    for k, v in table.items()
                }
            else:
                unit_table = dict(table)
            units[(int(g0), int(g1))] = {
                "table": unit_table,
                **self._filter_meta_snapshot(
                    snap, range(int(g0), int(g1) + 1)),
            }
        return units

    def merge_unit_snapshots(self, units: List[Dict[str, object]]
                             ) -> Dict[str, object]:
        """Reassemble one engine snapshot from shard units (a whole-job
        restore; units may come from DIFFERENT checkpoints when a torn
        unit fell back — the caller replays each range from its own
        unit's source position)."""
        tables = [u.get("table", {}) or {} for u in units]
        tables = [t for t in tables if t]
        merged: Dict[str, object] = {}
        if tables:
            cols = set().union(*(set(t) for t in tables))
            for k in sorted(cols):
                parts = [np.asarray(t[k]) for t in tables if k in t]
                if k == "__delta__":
                    merged[k] = np.asarray(True)
                elif k == "freed_namespaces":
                    merged[k] = (np.unique(np.concatenate(parts))
                                 if parts else np.empty(0, dtype=np.int64))
                else:
                    # the tombstone columns are row-PAIRED: plain
                    # concatenation keeps the pairs (duplicates apply
                    # idempotently)
                    merged[k] = (np.concatenate(parts) if parts
                                 else np.empty(0, dtype=np.int64))
        return {"table": merged, **self._merge_meta_snapshots(units)}

    # ------------------------------------------------------ read replica
    # (tenancy/replica.py — the boundary-published serving plane)

    #: armed by the tenancy layer (session cluster / tests); None keeps
    #: every hook a single attribute check on the ingest path
    _replica = None
    #: set where the replica's shadow of the slot metadata goes stale
    #: wholesale (restore, reshard, shard loss) — the next publish
    #: rebuilds the plane and republishes every resident row
    _rep_rebuild = False

    def arm_replica(self, plane=None):
        """Attach (or build) the read-replica plane this engine
        publishes into at watermark boundaries. Must run on the task
        thread (single-owner), before or between batches."""
        from flink_tpu_torch.tenancy.replica import ReplicaPlane

        if plane is None:
            plane = ReplicaPlane(self.mesh, self.agg.leaves,
                                 self.capacity)
        self._replica = plane
        self._rep_cold_pending: Dict[int, list] = {}
        self._rep_rebuild = True
        return plane

    def _rep_note_cold(self, p: int, keys, nss) -> None:
        """Record rows leaving residency (evictions) so a row created
        AND evicted within one publish interval still reaches the
        replica index as a cold entry at the next boundary."""
        if self._replica is not None:
            self._rep_cold_pending.setdefault(p, []).append(
                (np.asarray(keys, dtype=np.int64).copy(),
                 np.asarray(nss, dtype=np.int64).copy()))

    def _rep_mark(self, p: int, slots) -> None:
        """Note value-changing scatters for the next publish delta
        (residency/identity changes are derived by the publish diff
        instead — see _publish_replica). While a rebuild is pending
        (reshard/restore/growth changed the plane shape under the
        shadow) marks are moot — the rebuild republishes everything."""
        rep = self._replica
        if rep is not None and not self._rep_rebuild \
                and not rep.needs_rebuild(self.P, self.capacity):
            rep.mark_dirty(p, slots)

    def _rep_extra(self, p: int, keys: np.ndarray,
                   nss: np.ndarray):
        """Per-row adapter payload published with the index entries
        (sessions: the session END; windows: none — the namespace IS
        the slice end)."""
        return None

    def _rep_hidden(self, keys: np.ndarray, nss: np.ndarray):
        """Hook: ``(drop_mask, cold_mask)`` over resident rows the index
        must not serve as they are, or None (the default: serve every
        resident row). The session engine's hot-key splitting drops its
        salted sub-rows and enters a split key's main rows cold."""
        return None

    def _rep_probe_cold(self, p: int, keys: np.ndarray,
                        nss: np.ndarray) -> np.ndarray:
        """For pairs that left the resident set since the last publish:
        True = the row serves from the page tier (evicted), False =
        freed (fired/expired — drop from the index). Namespace-layout
        default: a namespace present in the shard's spill tier is cold
        (eviction moves whole namespaces)."""
        if not self._spill_active:
            return np.zeros(len(nss), dtype=bool)
        spilled = np.fromiter((int(x) for x in self.spills[p].namespaces),
                              dtype=np.int64)
        return np.isin(np.asarray(nss, dtype=np.int64), spilled)

    def _publish_replica(self, watermark: int) -> None:
        """Publish the boundary delta into the replica plane: diff the
        engine's per-shard slot metadata against the replica's shadow
        (plus the scatter-site dirty marks), hand the changed slots to
        ONE device-to-device copy program, and seal the next
        generation. Runs at the END of on_watermark — the fires and
        frees of this boundary are already applied, so the sealed view
        is exactly the engine state a checkpoint cut here would
        capture."""
        rep = self._replica
        if rep is None:
            return
        if rep.min_interval_s and not self._rep_rebuild:
            s = rep.sealed
            if s is not None and (time.monotonic() - s.published_at
                                  < rep.min_interval_s):
                # batch this boundary into the next publish: the dirty
                # marks keep accumulating, the diff/copy cost is paid
                # once per interval, and the cache invalidation rate is
                # bounded (staleness <= the interval, by construction)
                return
        with flight.span("serving.replica_publish",
                         watermark=int(watermark)):
            include_spilled = False
            if self._rep_rebuild or rep.needs_rebuild(self.P,
                                                      self.capacity):
                rep.rebuild(self.mesh, self.capacity)
                self._rep_cold_pending = {}
                self._rep_rebuild = False
                # the rebuild's full republish covers resident rows;
                # rows already cold (restored/re-homed pages) must
                # re-enter the index too — enumerated below
                include_spilled = self._spill_active
            per_shard = {}
            for p in range(self.P):
                idx = self.indexes[p]
                used = idx.slot_used
                L = len(used)
                cur_used = np.asarray(used[:L], dtype=bool)
                cur_key = np.asarray(idx.slot_key[:L])
                cur_ns = np.asarray(idx.slot_ns[:L])
                r_used = rep.rep_used[p][:L]
                r_key = rep.rep_key[p][:L]
                r_ns = rep.rep_ns[p][:L]
                moved = (cur_key != r_key) | (cur_ns != r_ns)
                ident_change = cur_used & (~r_used | moved)
                up = np.nonzero(ident_change
                                | (rep.rep_dirty[p][:L] & cur_used))[0]
                gone = np.nonzero(r_used & (~cur_used | moved))[0]
                cold: List[Tuple[int, int]] = []
                freed = np.zeros((0, 2), dtype=np.int64)
                if len(gone):
                    g_keys = r_key[gone].copy()
                    g_ns = r_ns[gone].copy()
                    # a pair re-homed to a NEW slot is covered by its
                    # upsert there; only pairs no longer resident at
                    # all need the cold/freed split
                    miss = idx.lookup(g_keys, g_ns) < 0
                    if miss.any():
                        mk, mn = g_keys[miss], g_ns[miss]
                        is_cold = self._rep_probe_cold(p, mk, mn)
                        cold.extend(_rows(mk[is_cold], mn[is_cold], None))
                        freed = np.stack([mk[~is_cold], mn[~is_cold]], 1)
                # rows created AND evicted since the last publish were
                # never resident at a boundary — the eviction sites
                # recorded them; enter them cold (skipping any that
                # reloaded back to residency, covered by the diff)
                pend = self._rep_cold_pending.get(p)
                if pend:
                    pk = np.concatenate([a for a, _ in pend])
                    pn = np.concatenate([b for _, b in pend])
                    nonres = idx.lookup(pk, pn) < 0
                    if nonres.any():
                        ck, cn = pk[nonres], pn[nonres]
                        still = self._rep_probe_cold(p, ck, cn)
                        cx = self._rep_extra(p, ck, cn)
                        cold.extend(_rows(ck[still], cn[still],
                                          None if cx is None else cx[still]))
                    # cleared after the publish SUCCEEDS (torn-publish
                    # re-derivability — see below)
                hidden = None
                split = self._rep_hidden(cur_key, cur_ns)
                if split is not None:
                    drop, coldm = split
                    hidden = (drop | coldm) & cur_used
                    # a split key's main rows serve cold (the live
                    # combined fold); its salted rows never serve
                    hc = up[coldm[up]]
                    if len(hc):
                        cx = self._rep_extra(p, cur_key[hc], cur_ns[hc])
                        cold.extend(_rows(cur_key[hc], cur_ns[hc], cx))
                    up = up[~hidden[up]]
                up_keys = cur_key[up].copy()
                up_ns = cur_ns[up].copy()
                per_shard[p] = {
                    "resident": (cur_used, cur_key, cur_ns),
                    "hidden": hidden,
                    "up_slots": up.astype(np.int32),
                    "up_keys": up_keys,
                    "up_ns": up_ns,
                    "up_extra": self._rep_extra(p, up_keys, up_ns),
                    "cold": cold,
                    "freed": freed,
                    "fresh": bool(ident_change.any()),
                }
            if include_spilled:
                cold0 = per_shard[0]["cold"]
                for part in self._spill_snapshot_parts():
                    ck = np.asarray(part["key_id"], dtype=np.int64)
                    cn = np.asarray(part["namespace"], dtype=np.int64)
                    split = self._rep_hidden(ck, cn)
                    if split is not None:
                        keep = ~split[0]  # spilled rows are cold already
                        ck, cn = ck[keep], cn[keep]
                    cold0.extend(_rows(ck, cn, self._rep_extra(0, ck, cn)))
                if cold0:
                    per_shard[0]["fresh"] = True
            # the metadata shadow (the published index's slot metadata),
            # dirty marks and pending cold events move ONLY when the
            # publish succeeds: a fault inside the publish
            # (serving.replica_publish chaos, a device error) must leave
            # the delta re-derivable — otherwise the torn boundary's rows
            # silently never reach the replica
            rep.publish(self.accs, per_shard, int(watermark))
            rep.rep_dirty[:] = False
            self._rep_cold_pending = {}

    # ---------------------------------------------------- tenant quota

    def enforce_resident_budget(self, max_total_rows: int) -> int:
        """Quota backstop (``tenancy/quotas.py``): evict this engine's OWN
        coldest rows until its device-resident total is at most
        ``max_total_rows`` — rows land in the engine's private spill
        tier, exactly like steady-state eviction. The method only walks
        ``self``'s shards, so one job's enforcement can never reclaim
        another job's rows. Returns rows shed; raises when no spill tier
        is configured (the ledger counts a quota violation)."""
        if not self._spill_active:
            raise RuntimeError(
                "engine has no spill tier — a resident-row quota needs "
                "state.slot-table.max-device-slots (+ spill dir) so "
                "over-budget rows have somewhere to go")
        max_total_rows = max(int(max_total_rows), 0)
        if self._paged:
            # the current batch's rows carry the live clock; the backstop
            # runs between scheduling quanta, so advancing it makes every
            # resident row evictable
            self._touch_clock += 1
        per = self.shard_resident_rows()
        shed = 0
        while sum(per) > max_total_rows:
            p = int(np.argmax(np.asarray(per)))
            if per[p] <= 0:
                break
            try:
                if self._paged:
                    self._evict_cohorts({p: self._choose_eviction_cohort(p)})
                else:
                    self._evict_cold(p, protect=set())
            except SlotTableFullError:
                break
            new = self.shard_resident_rows()
            freed = sum(per) - sum(new)
            if freed <= 0:
                break
            shed += freed
            per = new
        return shed


class MeshPagedSpillSupport(MeshSpillSupport):
    """The paged (cohort) spill tier for session-shaped mesh state: per
    shard, an eviction moves a cohort of the coldest rows (slot-granular
    touch clocks) as one page, a reload takes exactly the requested rows
    out of their pages (lazy tombstones, threshold compaction —
    ``state/paged_spill.py``), and the host indexes run registry-free.

    Device traffic stays batched across shards: every shard's reloads
    land in ONE put, and every shard short on headroom evicts in ONE
    gather (and ONE device-to-host copy) plus ONE reset per round, the
    other shards' lanes padding at slot 0. Hosts also provide
    ``indexes``, ``capacity``, ``agg``, ``_dirty``, the ``_gather_step``,
    ``_reset_step`` and ``_put_step`` programs and the buckets
    ``_gather_bucket``/``_reset_bucket``."""

    def _init_paged(self) -> None:
        #: one membership map (+ counters) per shard
        self._pmaps = [PagedSpillMap() for _ in range(self.P)]
        # fire-path extractions queue their page sweeps (reap/compact);
        # the next ingest drains them, so a fire stays a bounded delta
        for pm in self._pmaps:
            pm.defer_sweeps = True
        #: [P, capacity] per-slot touch clocks
        self._slot_touch = np.zeros((self.P, self.capacity), dtype=np.int64)

    def _pmap_of(self, p: int) -> Optional[PagedSpillMap]:
        return self._pmaps[p] if self._paged else None

    def _drain_deferred_sweeps(self) -> None:
        """Run the page sweeps queued by fire-path extractions (called at
        the start of an ingest step)."""
        for p, pm in enumerate(self._pmaps):
            if pm.deferred_pages:
                run_deferred_sweeps(self.spills[p], pm)

    def _paged_grow(self, new_capacity: int) -> None:
        if new_capacity <= self._slot_touch.shape[1]:
            return
        grown = np.zeros((self.P, new_capacity), dtype=np.int64)
        grown[:, : self._slot_touch.shape[1]] = self._slot_touch
        self._slot_touch = grown

    def spill_counters(self) -> Dict[str, int]:
        out = super().spill_counters()
        for pm in getattr(self, "_pmaps", ()):
            for k, v in pm.counters().items():
                out[k] += v
        return out

    def _resolve_slots_paged(
            self, per_shard: Dict[int, Tuple[np.ndarray, np.ndarray]],
            fresh: Optional[Dict[int, np.ndarray]] = None,
            hints: Optional[Dict[int, np.ndarray]] = None,
    ) -> Dict[int, np.ndarray]:
        """Batched slot resolution over shards with page reload and cohort
        eviction: resident rows of this batch take the current clock
        (protecting them from the eviction the batch itself triggers),
        missing pairs reload by row (ONE put for all shards), then only
        the still-missing pairs insert.

        ``fresh``: per-shard masks of pairs allocated by this batch's
        absorb — never resident nor paged, so they skip the probe and the
        page query. ``hints``: per-shard folded slots of the native
        metadata plane (-1 unknown), verified against the index before
        use (``resolve_slot_hints``) — the same hits, misses and insert
        order as the hint-free path."""
        self._touch_clock += 1
        clock = self._touch_clock
        leaf_dtypes = [l.dtype for l in self.agg.leaves]
        reloads: Dict[int, Tuple[np.ndarray, List[np.ndarray]]] = {}
        extracted: Dict[int, Tuple] = {}
        out: Dict[int, np.ndarray] = {}
        missing_by_shard: Dict[int, np.ndarray] = {}
        needs: Dict[int, int] = {}
        for p, (keys, nss) in per_shard.items():
            keys = np.asarray(keys, dtype=np.int64)
            nss = np.asarray(nss, dtype=np.int64)
            idx = self.indexes[p]
            fr = fresh.get(p) if fresh is not None else None
            hint = hints.get(p) if hints is not None else None
            if hint is not None:
                pre = resolve_slot_hints(idx, keys, nss, hint, skip=fr)
            elif fr is not None and fr.any():
                pre = np.full(len(keys), -1, dtype=np.int32)
                probe = ~fr
                if probe.any():
                    pre[probe] = idx.lookup(keys[probe], nss[probe])
            else:
                pre = idx.lookup(keys, nss)
                fr = None
            hit = pre >= 0
            self._slot_touch[p][pre[hit]] = clock
            missing = ~hit
            n_missing = int(missing.sum())
            if n_missing:
                if len(self._pmaps[p]):
                    # rows leave their pages by index (host work only);
                    # fresh pairs are never spilled
                    q = missing if fr is None else (missing & ~fr)
                    rl = reload_rows_for(self.spills[p], self._pmaps[p],
                                         nss[q], leaf_dtypes) \
                        if q.any() else None
                    if rl is not None:
                        extracted[p] = rl
                missing_by_shard[p] = missing
                needs[p] = n_missing
            out[p] = pre
            per_shard[p] = (keys, nss)
        # one eviction round covers every shard short on headroom
        if needs:
            self._make_headroom_paged_multi(needs)
        for p, rl in extracted.items():
            rkeys, rns, rdirty, rvals = rl
            rslots = self.indexes[p].lookup_or_insert(rkeys, rns)
            # reloaded rows keep their dirtiness and take the current
            # clock (the cohort is likely about to fire)
            self._dirty[p, rslots] = rdirty
            self._slot_touch[p][rslots] = clock
            reloads[p] = (rslots.astype(np.int32), rvals)
        if reloads:
            B = sticky_bucket(max(len(r[0]) for r in reloads.values()),
                              self._reload_bucket)
            self._reload_bucket = B
            slot_block = np.zeros((self.P, B), dtype=np.int32)
            val_blocks = [np.full((self.P, B), l.identity, dtype=l.dtype)
                          for l in self.agg.leaves]
            for p, (rslots, rvals) in reloads.items():
                n = len(rslots)
                slot_block[p, :n] = rslots
                for i in range(len(val_blocks)):
                    val_blocks[i][p, :n] = rvals[i]
            self.accs = self._put_step(
                self.accs, self._to_device(slot_block),
                tuple(self._to_device(v) for v in val_blocks))
        for p, missing in missing_by_shard.items():
            keys, nss = per_shard[p]
            # insert ONLY the pre-lookup misses (reloaded rows resolve as
            # hits here; fresh sids insert)
            slots = out[p]
            slots[missing] = self.indexes[p].lookup_or_insert(
                keys[missing], nss[missing])
            self._slot_touch[p][slots[missing]] = clock
        return out

    def _make_headroom_paged_multi(self, needs: Dict[int, int]) -> None:
        """Evict cold cohorts for EVERY shard short on headroom in one
        round (one gather + one reset, however many shards evict)."""
        pending = {p: n for p, n in needs.items()
                   if self.indexes[p].free_headroom() < n}
        while pending:
            self._evict_cohorts({p: self._choose_eviction_cohort(p)
                                 for p in pending})
            pending = {p: n for p, n in pending.items()
                       if self.indexes[p].free_headroom() < n}

    def _choose_eviction_cohort(self, p: int) -> np.ndarray:
        """Shard ``p``'s coldest slots (touch < current clock): a quarter
        of the table per round, so the fixed costs of a round (a gather,
        a device-to-host copy, a pass over the used set) amortize."""
        idx = self.indexes[p]
        used = idx.used_slots()
        touch = self._slot_touch[p][used]
        evictable = used[touch < self._touch_clock]
        if len(evictable) == 0:
            raise SlotTableFullError(
                f"shard {p}: device slot budget exhausted and every "
                "resident row was touched by the current batch — raise "
                "state.slot-table.max-device-slots or reduce batch size")
        target = min(max(idx.capacity // 4, 1024), len(evictable))
        if target < len(evictable):
            et = self._slot_touch[p][evictable]
            sel = np.argpartition(et, target - 1)[:target]
            chosen = evictable[sel]
        else:
            chosen = evictable
        return np.asarray(chosen, dtype=np.int32)

    def _evict_cohorts(self, cohorts: Dict[int, np.ndarray]) -> None:
        """Move each shard's cohort to its spill tier as one page: ONE
        gather, ONE device-to-host copy and ONE reset for all shards (the
        reset is queued behind the gather on the same stream)."""
        n_max = max(len(c) for c in cohorts.values())
        G = sticky_bucket(n_max, self._gather_bucket)
        self._gather_bucket = G
        block = np.zeros((self.P, G), dtype=np.int32)
        for p, chosen in cohorts.items():
            block[p, : len(chosen)] = chosen
        gathered = self._harvest_get(
            self._gather_step(self.accs, self._to_device(block)),
            "evict_harvest")
        for p, chosen in cohorts.items():
            idx = self.indexes[p]
            n = len(chosen)
            entry = {
                "key_id": np.asarray(idx.slot_key[chosen]),
                "ns": np.asarray(idx.slot_ns[chosen]),
                "dirty": self._dirty[p, chosen].copy(),
                **{f"leaf_{i}": g[p][:n] for i, g in enumerate(gathered)},
            }
            # replica: a row evicted before it was ever published
            # resident must still enter the index cold at the next
            # boundary (the publish drains these events)
            self._rep_note_cold(p, entry["key_id"], entry["ns"])
            spill_page(self.spills[p], self._pmaps[p], entry)
            idx.free_slots(chosen)
            self._dirty[p, chosen] = False
        R = sticky_bucket(n_max, self._reset_bucket)
        self._reset_bucket = R
        rb = np.zeros((self.P, R), dtype=np.int32)
        for p, chosen in cohorts.items():
            rb[p, : len(chosen)] = chosen
        self.accs = self._reset_step(self.accs, self._to_device(rb))

    def _free_rows_paged(self, p: int, slots: np.ndarray, nss) -> None:
        """Slot-addressed free for the registry-free index; spilled copies
        (rare: resolves reload first) are tombstoned."""
        if self._spill_active and len(self._pmaps[p]):
            drop_spilled_sessions(self.spills[p], self._pmaps[p],
                                  np.asarray(nss, dtype=np.int64))
        slots = np.asarray(slots, dtype=np.int32)
        if len(slots):
            self.indexes[p].free_slots(slots)
            self._dirty[p, slots] = False

    def _paged_restore_rows(self, key_ids: np.ndarray,
                            namespaces: np.ndarray,
                            leaves: List[np.ndarray]) -> None:
        """Paged restore: each shard's rows land in its page tier as
        page-sized entries and reload lazily by page (stale pages of a
        shard without rows are cleared)."""
        shards = self._route(key_ids)
        for p in range(self.P):
            mask = shards == p
            if not mask.any():
                if len(self._pmaps[p]):
                    restore_into_pages(
                        self.spills[p], self._pmaps[p],
                        np.empty(0, dtype=np.int64),
                        np.empty(0, dtype=np.int64),
                        [np.empty(0, dtype=l.dtype)
                         for l in self.agg.leaves], 1024)
                continue
            restore_into_pages(
                self.spills[p], self._pmaps[p], key_ids[mask],
                namespaces[mask], [l[mask] for l in leaves],
                page_rows=max(self.indexes[p].capacity // 8, 1024))


class MeshWindowEngine(MeshSpillSupport):
    """Windowed keyed aggregation over a P-shard logical mesh. Fires may
    be dispatched async: ``on_watermark(async_ok=True)`` returns
    PendingFire handles, harvested once their host copies land."""

    def __init__(
        self,
        assigner: WindowAssigner,
        agg: AggregateFunction,
        mesh: LogicalMesh,
        capacity_per_shard: int = 1 << 16,
        max_parallelism: int = 128,
        allowed_lateness: int = 0,
        fire_projector=None,
        max_device_slots: int = 0,
        spill_dir: Optional[str] = None,
        spill_host_max_bytes: int = 0,
        key_group_range: Optional[Tuple[int, int]] = None,
        max_dispatch_ahead: int = 2,
        shuffle_mode: str = "device",
        host_topology=None,
        memory=None,
    ) -> None:
        self.shuffle_mode = self._check_shuffle_mode(shuffle_mode)
        self._memory = memory
        self.assigner = assigner
        self.agg = agg
        self.mesh = mesh
        self.P = int(mesh.size)
        self.device = mesh.device
        self._set_host_topology(host_topology)
        self.fire_projector = fire_projector
        self.key_group_range = key_group_range
        self.max_dispatch_ahead = max(int(max_dispatch_ahead or 1), 1)
        #: per-SHARD row budget (state.slot-table.max-device-slots):
        #: beyond it the coldest namespaces (window slices) spill to the
        #: shard's host tier and reload on access
        self.max_device_slots = int(max_device_slots or 0)
        self.capacity = max(int(capacity_per_shard), 1024)
        if self.max_device_slots:
            self.max_device_slots = max(self.max_device_slots, 1024)
            self.capacity = min(self.capacity, self.max_device_slots)
        self.max_parallelism = max_parallelism
        self.allowed_lateness = allowed_lateness
        if max_parallelism < self.P:
            raise ValueError(
                f"max_parallelism {max_parallelism} < mesh size {self.P}")
        # growable per-shard host indexes; the planes stay uniform
        # [P, cap] sized to the LARGEST shard index
        self.indexes = self._make_shard_indexes()
        self._init_spill(spill_dir, spill_host_max_bytes)
        self.accs: Tuple[torch.Tensor, ...] = self._fresh_planes()
        self._build_steps()
        # window lifecycle metadata is global across shards
        self.book = SliceBookkeeper(assigner, allowed_lateness)
        self._init_tracking()
        self._fire_bucket = 0
        self._reset_bucket = 0
        #: fires that merged spilled slices on the host
        self.hybrid_fires = 0
        #: window end -> key groups: a window the book merge re-opened
        #: after it fired for everyone fires again for those groups only
        self._refire_groups: Dict[int, set] = {}

    def _build_steps(self) -> None:
        # the [P, B] scatter steps serve host shuffle mode
        (self._scatter_step, self._fire_step, self._reset_step,
         self._gather_step, self._put_step, self._merge_step,
         self._valued_scatter_step) = build_mesh_steps(self.mesh, self.agg)
        self._exchange_scatter_step = build_exchange_scatter(self.mesh,
                                                             self.agg)
        # explicit per-accumulator-leaf partials (the two-phase agg's
        # global half, runtime/local_agg.py)
        self._exchange_valued_step = build_exchange_scatter(
            self.mesh, self.agg, valued=True)
        if self._two_level_active():
            self._exchange2_steps = build_exchange2_steps(
                self.mesh, self.host_topology, self.agg, valued=False)
            self._exchange2_valued = build_exchange2_steps(
                self.mesh, self.host_topology, self.agg, valued=True)

    # --------------------------------------------------------------- ingest

    def _ns_group_plan(self, key_ids: np.ndarray,
                       slice_ends: np.ndarray) -> Optional[List[List[int]]]:
        """When one batch's namespaces need more rows than half the
        per-shard budget, groups of namespaces (in ascending order) each
        within it, so one group at a time is resident; None when no
        split is needed. A namespace costs, on its worst shard, its
        resident rows plus its spilled rows plus this batch's pairs of
        it."""
        pk, pns, _ = unique_pairs(
            np.asarray(key_ids, dtype=np.int64),
            np.asarray(slice_ends, dtype=np.int64))
        uniq_ns = np.unique(pns)
        if len(uniq_ns) <= 1:
            return None
        budget = max(self.max_device_slots // 2, 1024)
        pshards = self._route(pk)
        costs: Dict[int, int] = {}
        for ns in uniq_ns.tolist():
            ns = int(ns)
            per_shard_new = np.bincount(pshards[pns == ns],
                                        minlength=self.P)
            costs[ns] = max(
                len(self.indexes[p].slots_for_namespace(ns))
                + self.spills[p].rows(ns) + int(per_shard_new[p])
                for p in range(self.P))
        if sum(costs.values()) <= budget:
            return None
        groups: List[List[int]] = []
        cur: List[int] = []
        cur_cost = 0
        for ns in sorted(costs):
            c = costs[ns]
            if cur and cur_cost + c > budget:
                groups.append(cur)
                cur, cur_cost = [], 0
            cur.append(ns)
            cur_cost += c
        groups.append(cur)
        return groups if len(groups) > 1 else None

    @property
    def late_records_dropped(self) -> int:
        return self.book.late_records_dropped

    def process_batch(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        with self._flight_ingest():
            self._process_batch_inner(batch)

    def _process_batch_inner(self, batch: RecordBatch) -> None:
        # batch boundary: the engine is consistent at a known source
        # position — the one point the watchdog may declare a shard dead
        self._wd_boundary()
        with flight.span("prep.route"):
            slice_ends = self.assigner.assign_slice_ends(batch.timestamps)
            groups = (self._ns_group_plan(batch.key_ids, slice_ends)
                      if self._spill_active and len(batch) > 1 else None)
            routed = None if groups is not None else \
                self._route_batch(batch, slice_ends)
        if groups is not None:
            for g in groups:
                mask = np.isin(slice_ends, np.asarray(g))
                if mask.any():
                    self._ingest_subbatch(batch.filter(mask))
            return
        if routed is None:
            return
        batch, key_ids, slice_ends, shards, grouped = routed
        partial = is_partial_batch(batch)
        if partial:
            # locally pre-aggregated rows: one explicit value per
            # accumulator leaf, folded with the valued scatter
            values = partial_leaf_values(batch, self.agg)
            leaves = self.agg.leaves
        else:
            values = self.agg.map_input(batch)
            leaves = self.agg.input_leaves
        if self.shuffle_mode == "host":
            self._process_batch_host(key_ids, slice_ends, shards, values,
                                     leaves, partial)
        else:
            self._process_batch_device(grouped, shards, values, leaves,
                                       partial)

    def _route_batch(self, batch: RecordBatch, slice_ends: np.ndarray):
        """The live mask, the slices' registration and the key-group
        route of one batch; in device mode also its records grouped by
        shard: ``(order, offsets, keys, namespaces)`` in shard order.
        Returns ``(batch, key_ids, slice_ends, shards, grouped)``, or None
        when no record is live."""
        key_ids = batch.key_ids
        live = self.book.live_mask(slice_ends)
        if live is not None:
            key_ids, slice_ends = key_ids[live], slice_ends[live]
            batch = batch.filter(live)
            if len(batch) == 0:
                return None
        self.book.register_slices(slice_ends)
        shards = self._route(key_ids)
        grouped = None
        if self.shuffle_mode != "host":
            order = np.argsort(shards, kind="stable")
            offsets = np.zeros(self.P + 1, dtype=np.int64)
            np.cumsum(np.bincount(shards, minlength=self.P),
                      out=offsets[1:])
            grouped = (order, offsets, key_ids[order], slice_ends[order])
        return batch, key_ids, slice_ends, shards, grouped

    def _process_batch_host(self, key_ids, slice_ends, shards, values,
                            leaves, partial: bool) -> None:
        """Host shuffle mode: bucket the records into ``[P, B]`` blocks on
        the host (``bucket_by_shard``, whose chaos points may drop or
        duplicate a shard's bucket before its slots resolve), resolve
        each block's slots, and fold the blocks with the ``[P, B]``
        scatter step."""
        self._await_dispatch_slot()
        self._shuffle_pool.flip()
        with flight.span("prep.stage"):
            counts, blocked = bucket_by_shard(
                shards, self.P,
                columns=[key_ids, slice_ends,
                         *[np.asarray(v, dtype=l.dtype)
                           for v, l in zip(values, leaves)]],
                fills=[0, 0, *[l.identity for l in leaves]],
                pool=self._shuffle_pool)
        key_block, ns_block = blocked[0], blocked[1]
        if self._spill_active:
            touched = {p: np.unique(ns_block[p, :int(counts[p])])
                       for p in range(self.P) if int(counts[p])}
            self._ensure_resident(touched)
            for p, nss in touched.items():
                self._touch(p, nss.tolist())
        slot_block = np.zeros(key_block.shape, dtype=np.int32)
        for p in range(self.P):
            c = int(counts[p])
            if not c:
                continue
            with flight.span("prep.slots", shard=p):
                self._reserve(p, key_block[p, :c], ns_block[p, :c])
                slot_block[p, :c] = self.indexes[p].lookup_or_insert(
                    key_block[p, :c], ns_block[p, :c])
                self._dirty[p, slot_block[p, :c]] = True
                self._rep_mark(p, slot_block[p, :c])
        step = self._valued_scatter_step if partial else self._scatter_step
        with flight.span("device.dispatch"):
            self.accs = step(
                self.accs, self._to_device(slot_block),
                tuple(self._to_device(v) for v in blocked[2:]))
        self._push_dispatch_fence()

    def _process_batch_device(self, grouped, shards, values, leaves,
                              partial: bool = False) -> None:
        """The host resolves slots (the index is host state) but never
        sorts or blocks the record columns: flat padded columns go to the
        device and the exchange+scatter step routes them to their shards.
        ``grouped``: the batch's records by shard (``_route_batch``)."""
        order, offsets, s_keys, s_ns = grouped
        n = len(order)
        if self._spill_active:
            # reload this batch's spilled namespaces (all shards in one
            # put), then refresh their recency
            touched = {
                p: np.unique(s_ns[offsets[p]:offsets[p + 1]])
                for p in range(self.P) if offsets[p + 1] > offsets[p]}
            self._ensure_resident(touched)
            for p, nss in touched.items():
                self._touch(p, nss.tolist())
        slots_sorted = np.empty(n, dtype=np.int32)
        for p in range(self.P):
            a, b = int(offsets[p]), int(offsets[p + 1])
            if a == b:
                continue
            with flight.span("prep.slots", shard=p):
                self._reserve(p, s_keys[a:b], s_ns[a:b])
                slots = self.indexes[p].lookup_or_insert(s_keys[a:b],
                                                         s_ns[a:b])
                slots_sorted[a:b] = slots
                self._dirty[p, slots] = True
                self._rep_mark(p, slots)
        rec_slots = np.empty(n, dtype=np.int32)
        rec_slots[order] = slots_sorted
        self._dispatch_exchange(
            shards,
            [rec_slots, *[np.asarray(v, dtype=l.dtype)
                          for v, l in zip(values, leaves)]],
            [0, *[l.identity for l in leaves]],
            self._exchange_valued_step if partial
            else self._exchange_scatter_step,
            (self._exchange2_valued if partial
             else self._exchange2_steps) if self._two_level_active()
            else None,
            self._valued_scatter_step if partial else self._scatter_step,
            n)

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int,
                     async_ok: bool = False) -> List[object]:
        self._wd_boundary()
        with flight.fire_span(watermark):
            out = self._on_watermark_inner(watermark, async_ok)
        # replica publish AFTER the fires and frees of this boundary (and
        # outside the fire span: serving-plane work, under its own
        # serving.replica_publish span)
        self._publish_replica(watermark)
        return out

    def _on_watermark_inner(self, watermark: int,
                            async_ok: bool) -> List[object]:
        out: List[object] = []
        while True:
            w_end = self.book.next_window(watermark)
            if w_end is None:
                break
            batch = self._fire_window(w_end, async_ok=async_ok)
            groups = self._refire_groups.pop(w_end, None)
            if batch is not None and groups is not None:
                batch = self._keep_groups(batch, groups)
            if batch is not None:
                out.append(batch)
            self.book.mark_fired(w_end)
        expired = self.book.expired_slices(watermark)
        if expired:
            # the reset is stream-ordered BEHIND the fires dispatched
            # above, so a deferred host read of their outputs never races
            # the frees
            self._free_slices(expired)
        return out

    def _fire_window(self, window_end: int, async_ok: bool = False):
        chaos.fault_point("mesh.window_fire", window_end=window_end)
        slice_ends = self.assigner.slice_ends_for_window(window_end)
        if self._any_spilled(slice_ends):
            # resident slices merge on the device, spilled ones on the
            # host: synchronous, the merged values are on the host already
            return self._fire_window_hybrid(window_end, slice_ends)
        per_shard_keys, sm = self._slice_matrices(slice_ends)
        if sm is None:
            return None
        with flight.span("device.dispatch"):
            fire_out = self._fire_step(self.accs, self._to_device(sm))
        names = sorted(fire_out.keys())
        projector = self.fire_projector
        w_start = self.assigner.window_start(window_end)
        per_keys = per_shard_keys

        def build(host: List[np.ndarray]) -> Optional[RecordBatch]:
            key_cols: List[np.ndarray] = []
            res_cols: Dict[str, List[np.ndarray]] = {n: [] for n in names}
            for p in range(len(per_keys)):
                m = len(per_keys[p])
                if m == 0:
                    continue
                key_cols.append(per_keys[p])
                for name, arr in zip(names, host):
                    res_cols[name].append(arr[p][:m])
            keys = np.concatenate(key_cols)
            merged = {name: np.concatenate(chunks)
                      for name, chunks in res_cols.items()}
            if projector is not None:
                keys, merged = projector.project_host(keys, merged)
            m = len(keys)
            cols = {
                KEY_ID_FIELD: keys,
                WINDOW_START_FIELD: np.full(m, w_start, dtype=np.int64),
                WINDOW_END_FIELD: np.full(m, window_end, dtype=np.int64),
                TIMESTAMP_FIELD: np.full(m, window_end - 1, dtype=np.int64),
            }
            cols.update(merged)
            return RecordBatch(cols)

        with flight.span("device.dispatch"):
            # the device-to-host copies of the outputs start here
            pending = PendingFire([fire_out[n] for n in names], build,
                                  watchdog=self._watchdog)
        return pending if async_ok else pending.harvest()

    def _slice_matrices(self, slice_ends
                        ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
        """Per shard, the keys with a RESIDENT row in any of the window's
        slices (ascending) and the ``[P, W, k]`` slot matrix over them
        (slot 0 where a key has no row in a slice; None when no shard has
        a row)."""
        k = len(slice_ends)
        per_shard_mats: List[np.ndarray] = []
        per_shard_keys: List[np.ndarray] = []
        w_max = 0
        for p in range(self.P):
            with flight.span("fire.shard", shard=p):
                keys, mat = self._shard_slice_matrix(p, slice_ends)
            per_shard_mats.append(mat)
            per_shard_keys.append(keys)
            w_max = max(w_max, len(keys))
        if w_max == 0:
            return per_shard_keys, None
        W = sticky_bucket(w_max, self._fire_bucket, minimum=64)
        self._fire_bucket = W
        sm = np.zeros((self.P, W, k), dtype=np.int32)
        for p, mat in enumerate(per_shard_mats):
            sm[p, : len(mat)] = mat
        return per_shard_keys, sm

    def _shard_slice_matrix(self, p: int, slice_ends
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Shard ``p``'s keys with a resident row in any of
        ``slice_ends`` (ascending) and their ``[keys, k]`` slot matrix."""
        k = len(slice_ends)
        idx = self.indexes[p]
        chunks = [(i, idx.slots_for_namespace(int(se)))
                  for i, se in enumerate(slice_ends)]
        chunks = [(i, s) for i, s in chunks if len(s) > 0]
        if not chunks:
            return (np.empty(0, dtype=np.int64),
                    np.zeros((0, k), dtype=np.int32))
        all_slots = np.concatenate([s for _, s in chunks])
        all_sidx = np.concatenate(
            [np.full(len(s), i, dtype=np.int32) for i, s in chunks])
        keys, inv = np.unique(idx.slot_key[all_slots], return_inverse=True)
        mat = np.zeros((len(keys), k), dtype=np.int32)
        mat[inv, all_sidx] = all_slots
        return keys, mat

    def _fire_window_hybrid(self, window_end: int,
                            slice_ends) -> Optional[RecordBatch]:
        """A window with spilled slices: the resident slices merge on the
        device (the raw merge step, no finish: a left fold over the k
        slices), then every chunk — the device-merged keys shard by
        shard, then each shard's spilled slices in slice order — is
        combined on the host with NumPy's ``ufunc.at`` in chunk order,
        and finished there."""
        self.hybrid_fires += 1
        leaves = self.agg.leaves
        key_chunks: List[np.ndarray] = []
        leaf_chunks: List[List[np.ndarray]] = [[] for _ in leaves]
        per_shard_keys, sm = self._slice_matrices(slice_ends)
        if sm is not None:
            merged_host = self._harvest_get(
                self._merge_step(self.accs, self._to_device(sm)))
            for p in range(self.P):
                m = len(per_shard_keys[p])
                if m == 0:
                    continue
                key_chunks.append(per_shard_keys[p])
                for i in range(len(leaves)):
                    leaf_chunks[i].append(merged_host[i][p][:m])
        for p in range(self.P):
            sp = self.spills[p]
            for se in slice_ends:
                entry = sp.peek(int(se))
                if entry is None or len(entry["key_id"]) == 0:
                    continue
                key_chunks.append(
                    np.asarray(entry["key_id"], dtype=np.int64))
                for i, l in enumerate(leaves):
                    leaf_chunks[i].append(
                        np.asarray(entry[f"leaf_{i}"], dtype=l.dtype))
        if not key_chunks:
            return None
        uniq, inv = np.unique(np.concatenate(key_chunks),
                              return_inverse=True)
        out_leaves = []
        # inf + -inf is NaN in any order: no warning for the data's specials
        with np.errstate(invalid="ignore", over="ignore"):
            for i, l in enumerate(leaves):
                acc = np.full(len(uniq), l.identity, dtype=l.dtype)
                HOST_COMBINE[l.reduce].at(acc, inv,
                                          np.concatenate(leaf_chunks[i]))
                out_leaves.append(acc)
        finished = self.agg.finish(
            tuple(torch.from_numpy(a) for a in out_leaves))
        merged_cols = {name: np.asarray(col)
                       for name, col in finished.items()}
        keys = uniq
        if self.fire_projector is not None:
            keys, merged_cols = self.fire_projector.project_host(
                keys, merged_cols)
        m = len(keys)
        if m == 0:
            return None
        cols = {
            KEY_ID_FIELD: keys,
            WINDOW_START_FIELD: np.full(
                m, self.assigner.window_start(window_end), dtype=np.int64),
            WINDOW_END_FIELD: np.full(m, window_end, dtype=np.int64),
            TIMESTAMP_FIELD: np.full(m, window_end - 1, dtype=np.int64),
        }
        cols.update(merged_cols)
        return RecordBatch(cols)

    def _free_slices(self, ends: List[int]) -> None:
        f_max = 0
        freed: List[Optional[np.ndarray]] = []
        self._freed_ns.append(np.asarray(list(ends), dtype=np.int64))
        self._drop_spilled(ends)
        for p in range(self.P):
            # a shard's fire-path host work, like its resolve
            with flight.span("fire.shard", shard=p):
                slots = self.indexes[p].free_namespaces(ends)
                if slots is not None:
                    self._dirty[p, slots] = False
            freed.append(slots)
            if slots is not None:
                f_max = max(f_max, len(slots))
        if f_max == 0:
            return
        F = sticky_bucket(f_max, self._reset_bucket)
        self._reset_bucket = F
        block = np.zeros((self.P, F), dtype=np.int32)
        for p, slots in enumerate(freed):
            if slots is not None:
                block[p, : len(slots)] = slots
        with flight.span("device.dispatch"):
            self.accs = self._reset_step(self.accs, self._to_device(block))

    # ---------------------------------------------------------- point query

    def query_windows(self, key_id: int) -> Dict[int, Dict[str, float]]:
        """{window_end -> result columns} for one key: a batch of one
        (reference ``flink_tpu/parallel/sharded_windower.py:2656``)."""
        return self.query_batch(np.asarray([key_id], dtype=np.int64))[0]

    def query_batch(self, key_ids) -> List[Dict[int, Dict[str, float]]]:
        """One ``{window_end -> columns}`` dict per requested key, in
        request order (reference ``:2662``). Each key routes to its owning
        shard (``_route``, the data path's formula); every shard's resident
        hits go into one ``[P, G]`` block, one ``_gather_step`` and ONE
        device-to-host copy (``_harvest_get(..., "serving_lookup")``, a
        watchdog section); slices spilled under a device budget answer
        from their shard's host tier (``peek``: no residency change); the
        windows compose on the host (``compose_windows_pairs``).
        Read-only: no sticky bucket moves."""
        key_ids = np.asarray(key_ids, dtype=np.int64)
        n = len(key_ids)
        if n == 0:
            return []
        leaves = self.agg.leaves
        shards = self._route(key_ids)
        #: the answered (request row, slice end) pairs and their leaves,
        #: resident first, then spilled (a later pair wins)
        p_rows: List[np.ndarray] = []
        p_ns: List[np.ndarray] = []
        p_leaves: List[List[np.ndarray]] = [[] for _ in leaves]
        lanes: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        g_max = 0
        for p in range(self.P):
            rows_p = np.nonzero(shards == p)[0]
            if not len(rows_p):
                continue
            idx = self.indexes[p]
            live_ns = np.asarray([int(x) for x in idx.namespaces],
                                 dtype=np.int64)
            if not len(live_ns):
                continue
            pk = np.repeat(key_ids[rows_p], len(live_ns))
            pn = np.tile(live_ns, len(rows_p))
            prow = np.repeat(rows_p, len(live_ns))
            slots = idx.lookup(pk, pn)
            hit = slots >= 0
            if hit.any():
                lanes[p] = (slots[hit].astype(np.int32), prow[hit],
                            pn[hit])
                g_max = max(g_max, int(hit.sum()))
        if lanes:
            G = pad_bucket_size(g_max, minimum=64)
            block = np.zeros((self.P, G), dtype=np.int32)
            for p, (hs, _, _) in lanes.items():
                block[p, : len(hs)] = hs
            g_host = self._harvest_get(
                self._gather_step(self.accs, self._to_device(block)),
                "serving_lookup")
            for p, (hs, prow, pn) in lanes.items():
                p_rows.append(prow)
                p_ns.append(pn)
                for i, g in enumerate(g_host):
                    p_leaves[i].append(g[p][: len(hs)])
        if self._spill_active:
            for p in range(self.P):
                rows_p = np.nonzero(shards == p)[0]
                if not len(rows_p):
                    continue
                sp = self.spills[p]
                if len(sp) == 0:
                    continue
                want = key_ids[rows_p]
                for ns in sp.namespaces:
                    entry = sp.peek(int(ns))
                    if entry is None:
                        continue
                    ek = np.asarray(entry["key_id"], dtype=np.int64)
                    if not len(ek):
                        continue
                    order = np.argsort(ek, kind="stable")
                    pos = np.searchsorted(ek[order], want)
                    pos = np.minimum(pos, len(ek) - 1)
                    ok = ek[order][pos] == want
                    if not ok.any():
                        continue
                    src = order[pos[ok]]
                    p_rows.append(rows_p[ok])
                    p_ns.append(np.full(int(ok.sum()), int(ns),
                                        dtype=np.int64))
                    for i, l in enumerate(leaves):
                        p_leaves[i].append(np.asarray(
                            entry[f"leaf_{i}"], dtype=l.dtype)[src])
        if not p_rows:
            return [{} for _ in range(n)]
        return compose_windows_pairs(
            self.assigner, self.agg, np.concatenate(p_rows),
            np.concatenate(p_ns),
            [np.concatenate(c) for c in p_leaves], n)

    # ------------------------------------------------------------- snapshot

    def snapshot(self, mode: str = "full") -> Dict[str, object]:
        """Logical snapshot merged over shards, re-shardable by key group —
        the format of ``SliceSharedWindower.snapshot``, so mesh and
        single-device checkpoints restore into each other. mode: "full",
        "delta" or "savepoint"."""
        return {"table": self._snapshot_table(mode), **self.book.snapshot()}

    def restore(self, snap: Dict[str, object],
                key_group_filter=None) -> None:
        """Restore, re-sharding by key group (works across mesh sizes);
        ``key_group_filter`` keeps only the rows of those key groups."""
        self._restore_table(snap["table"], key_group_filter)
        self.book.restore(snap)
        self._refire_groups = {}

    # ------------------------------------------------ partial-failover hooks

    def _merge_restored_meta(self, snap, groups) -> None:
        # window lifecycle metadata is global: the book merge re-opens
        # the windows the restored range must fire again during replay.
        # A re-opened window that already fired fired for the survivors
        # too; with sliding windows its slices are shared with later
        # windows and still live on them, so a second fire would emit a
        # partial sum over the slices left. It fires again for the
        # restored groups only (the reference fires it for every key:
        # ROADMAP.md Queue C R5).
        fired = self.book.max_fired_end
        self.book.merge_restore(snap)
        refire = dict(self._refire_groups)
        for w in self.book.pending_windows():
            if w <= fired:
                refire.setdefault(w, set()).update(int(g) for g in groups)
        self._refire_groups = refire

    def _keep_groups(self, fired, groups):
        """A fired batch (or a PendingFire) cut to the keys of ``groups``."""
        gset = np.asarray(sorted(groups), dtype=np.int64)

        def keep(batch):
            if batch is None:
                return None
            kg = assign_key_groups(batch.key_ids, self.max_parallelism)
            return batch.filter(np.isin(kg, gset))

        if isinstance(fired, PendingFire):
            fired.build = (lambda host, build=fired.build:
                           keep(build(host)))
            return fired
        return keep(fired)

    def _merge_meta_snapshots(self, units):
        _NEG = -(1 << 62)
        pending = sorted({int(w) for u in units
                          for w in u.get("pending", ())})
        slw: Dict[int, int] = {}
        for u in units:
            slw.update(dict(u.get("slice_last_window", {})))
        return {
            "pending": pending,
            "slice_last_window": slw,
            # the OLDEST unit decides: its range's records replay from
            # its position and must pass the late-record guard exactly
            # as they first did
            "watermark": min((u.get("watermark", _NEG) for u in units),
                             default=_NEG),
            "max_fired_end": min(
                (u.get("max_fired_end", _NEG) for u in units),
                default=_NEG),
            "late_records_dropped": max(
                (u.get("late_records_dropped", 0) for u in units),
                default=0),
        }


def build_mesh_steps(mesh: LogicalMesh, agg: AggregateFunction):
    """Shared through ``PROGRAM_CACHE`` (kind ``mesh-steps``) per
    (device, shards, aggregate layout): jobs and rebuilt
    engines reuse one family of steps (see ``_build_mesh_steps``)."""
    key = (str(mesh.device), int(mesh.size), agg.cache_key())
    return PROGRAM_CACHE.get_or_build(
        "mesh-steps", key, lambda: _build_mesh_steps(mesh, agg))


def _build_mesh_steps(mesh: LogicalMesh, agg: AggregateFunction):
    """(scatter, fire, reset, gather, put, merge, valued scatter) steps
    over ``[P, capacity]``
    planes. The planes are updated IN PLACE where the reference donated
    them.

    - ``scatter(accs, slots [P, B], values)``: fold per-shard record
      blocks (one ``[P, B]`` block per *input* leaf; const leaves derive
      on the device; lanes at slot 0 are padding).
    - ``fire(accs, slot_matrix [P, W, k]) -> {name: [P, W]}``: gather each
      row's k slices, merge over the slice axis, finish.
    - ``reset(accs, slots [P, F])``: set freed slots to identity.
    - ``gather(accs, slots [P, G]) -> per-leaf [P, G]``: raw accumulator
      values, fresh tensors (the eviction read).
    - ``put(accs, slots [P, B], values)``: overwrite the slots with one
      ``[P, B]`` block per leaf (the reload); padded lanes target slot 0
      with the identity.
    - ``valued_scatter(accs, slots [P, B], values)``: fold one explicit
      ``[P, B]`` block per accumulator leaf (host shuffle mode's
      two-phase partials).
    - ``merge(accs, slot_matrix [P, W, k]) -> per-leaf [P, W]``: fire
      without the finish — the raw merged accumulators a hybrid fire
      combines with spilled slices on the host.
    """
    leaves = agg.leaves
    tdtypes = tuple(torch_dtype(l.dtype) for l in leaves)
    methods = tuple(scatter_fold(l.reduce, td)
                    for l, td in zip(leaves, tdtypes))
    merges = tuple(MERGE_FN[l.reduce] for l in leaves)
    idents = tuple(np.asarray(l.identity).item() for l in leaves)
    finish = agg.finish

    def scatter_step(accs, slots, values):
        vals = iter(values)
        for a, m, idx, l, td, ident in zip(accs, methods,
                                           fold_slots(slots, tdtypes),
                                           leaves, tdtypes, idents):
            if l.const is not None:
                # padded lanes target identity slot 0 — keep it pure
                v = torch.full(slots.shape, l.const, dtype=td,
                               device=slots.device)
                v.masked_fill_(slots == 0, ident)
            else:
                v = next(vals)
            m(a, idx, v)
        return accs

    def valued_scatter_step(accs, slots, values):
        # one explicit [P, B] block per accumulator leaf (locally
        # pre-aggregated partials); padded lanes fold identities into 0
        for a, m, idx, v in zip(accs, methods, fold_slots(slots, tdtypes),
                                values):
            m(a, idx, v)
        return accs

    def merge_step(accs, slot_matrix):
        P, W, k = slot_matrix.shape
        idx = slot_matrix.reshape(P, W * k).to(torch.int64)
        return tuple(m(torch.gather(a, 1, idx).view(P, W, k))
                     for a, m in zip(accs, merges))

    def fire_step(accs, slot_matrix):
        return finish(merge_step(accs, slot_matrix))

    def reset_step(accs, slots):
        idx = slots.to(torch.int64)
        for a, ident in zip(accs, idents):
            a.scatter_(1, idx, ident)
        return accs

    def gather_step(accs, slots):
        idx = slots.to(torch.int64)
        return tuple(torch.gather(a, 1, idx) for a in accs)

    def put_step(accs, slots, values):
        idx = slots.to(torch.int64)
        for a, v in zip(accs, values):
            a.scatter_(1, idx, v)
        return accs

    return (scatter_step, fire_step, reset_step, gather_step, put_step,
            merge_step, valued_scatter_step)


def build_delta_fire_step(mesh: LogicalMesh, agg: AggregateFunction):
    """Shared through ``PROGRAM_CACHE`` (kind ``delta-fire``) per
    (device, shards, aggregate layout): jobs and rebuilt
    engines reuse one family of steps (see ``_build_delta_fire_step``)."""
    key = (str(mesh.device), int(mesh.size), agg.cache_key())
    return PROGRAM_CACHE.get_or_build(
        "delta-fire", key, lambda: _build_delta_fire_step(mesh, agg))


def _build_delta_fire_step(mesh: LogicalMesh, agg: AggregateFunction):
    """``(accs, slot_matrix [P, W, k], reset_slots [P, W]) -> (accs,
    {name: [P, W]})``: merge and finish each row's slots, then reset
    ``reset_slots`` to identity, in one call. The results are fresh
    tensors computed from a gather that is queued on the stream before
    the reset, so an asynchronous host copy of them never sees a reset
    row. Padded lanes target slot 0 (their outputs are cut off by the
    caller; resetting slot 0 keeps it the identity)."""
    leaves = agg.leaves
    merges = tuple(MERGE_FN[l.reduce] for l in leaves)
    idents = tuple(np.asarray(l.identity).item() for l in leaves)
    finish = agg.finish
    names = sorted(agg.output_names)

    def delta_fire_step(accs, slot_matrix, reset_slots):
        P, W, k = slot_matrix.shape
        idx = slot_matrix.reshape(P, W * k).to(torch.int64)
        merged = tuple(m(torch.gather(a, 1, idx).view(P, W, k))
                       for a, m in zip(accs, merges))
        out = finish(merged)
        rs = reset_slots.to(torch.int64)
        for a, ident in zip(accs, idents):
            a.scatter_(1, rs, ident)
        return accs, {name: out[name] for name in names}

    return delta_fire_step
