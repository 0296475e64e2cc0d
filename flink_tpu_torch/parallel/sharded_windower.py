"""Mesh-sharded keyed state (port of
``flink_tpu/parallel/sharded_windower.py``: the window engine reduced to
the Q5 path, and the per-shard spill tier the mesh session engine runs
on).

State lives in ``[P, capacity]`` planes on the mesh's device, one per
accumulator leaf, dim 0 being the key-group shard. Records are routed to
their owning shard by the reference's key-group formula; ingest runs the
fused exchange+scatter step (``parallel/shuffle.py``), a fire gathers and
merges a window's slices per shard on the device, and expired slices are
reset to identity. Every key's slices live on one shard, so fires and
resets are shard-local.

- :class:`MeshSpillSupport`: the routing, the dispatch-ahead pipeline and
  the per-shard spill tiers both mesh engines share.
- :class:`MeshPagedSpillSupport`: the paged (cohort) spill tier of the
  session engine (``parallel/sharded_sessions.py``): per shard the
  coldest rows leave as one page (``state/paged_spill.py``), every
  shard's cohort in ONE ``[P, G]`` gather, ONE device-to-host copy and
  ONE reset; reloads of all shards land in ONE ``[P, B]`` put.
- :func:`build_mesh_steps` (scatter, fire, reset, gather, put) and
  :func:`build_delta_fire_step` (fire and reset in one call).

Left out, each raising ``NotImplementedError`` naming its ROADMAP item
where a user would select it: the window engine's device budget and the
namespace spill layout (item 7c), host shuffle mode, the two-level
exchange, managed memory, the watchdog and the read replica (item 12),
snapshots, restore and reshard (item 8).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.ops.segment_ops import (
    MERGE_FN,
    fold_slots,
    scatter_fold,
    sticky_bucket,
    torch_dtype,
)
from flink_tpu_torch.parallel.mesh import LogicalMesh
from flink_tpu_torch.parallel.shuffle import (
    ShuffleBufferPool,
    build_exchange_scatter,
    shard_records,
    stage_device_exchange,
)
from flink_tpu_torch.runtime.pending import Fence, PendingFire
from flink_tpu_torch.state.paged_spill import (
    PagedSpillMap,
    drop_spilled_sessions,
    reload_rows_for,
    run_deferred_sweeps,
    spill_page,
)
from flink_tpu_torch.state.slot_table import (
    SlotTableFullError,
    SpillTier,
    _not_ported,
    make_slot_index,
    resolve_slot_hints,
)
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.bookkeeping import SliceBookkeeper
from flink_tpu_torch.windowing.windower import (
    WINDOW_END_FIELD,
    WINDOW_START_FIELD,
)


def harvest_to_host(tensors) -> List[np.ndarray]:
    """Host copies of ``tensors`` through ONE device-to-host copy: their
    bytes are concatenated on the device (widest dtype first, so every
    part stays aligned) and split again on the host. CPU tensors come
    back as their arrays."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    flat = torch.cat([tensors[i].contiguous().view(-1).view(torch.uint8)
                      for i in order]).cpu()
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    off = 0
    for i in order:
        t = tensors[i]
        nb = t.numel() * t.element_size()
        out[i] = flat[off:off + nb].view(t.dtype).view(t.shape).numpy()
        off += nb
    return out


class MeshSpillSupport:
    """What both mesh engines share: key-group routing, host-to-device
    staging, the dispatch-ahead pipeline and one spill tier per shard.
    Hosts provide ``P``, ``device``, ``max_parallelism``,
    ``key_group_range``, ``agg``, ``accs``, ``capacity`` and
    ``max_dispatch_ahead``."""

    max_device_slots: int = 0

    def _route(self, key_ids) -> np.ndarray:
        """key id -> owning shard (the contiguous key-group formula)."""
        return shard_records(key_ids, self.P, self.max_parallelism,
                             self.key_group_range)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        # an async copy from PAGEABLE host memory has staged `host` when
        # it returns (no stream sync), so a pooled buffer may be
        # rewritten afterwards; on the CPU this is the array itself
        return torch.from_numpy(np.ascontiguousarray(host)).to(
            self.device, non_blocking=True)

    def _shard_index_grew(self, new_capacity: int) -> None:
        """One shard's index outgrew the plane width: widen every plane
        (the other shards' indexes address a prefix)."""
        if new_capacity <= self.capacity:
            return
        old = self.capacity
        self.capacity = new_capacity
        grown = []
        for a, leaf in zip(self.accs, self.agg.leaves):
            g = torch.full((self.P, new_capacity),
                           np.asarray(leaf.identity).item(), dtype=a.dtype,
                           device=self.device)
            g[:, :old] = a
            grown.append(g)
        self.accs = tuple(grown)

    def _init_spill(self, spill_dir: Optional[str],
                    spill_host_max_bytes: int) -> None:
        #: one spill tier per shard: spilled rows are shard-local like
        #: the device rows
        self.spills = [
            SpillTier(
                f"{spill_dir.rstrip('/')}/shard-{p}" if spill_dir else None,
                spill_host_max_bytes // self.P
                if spill_host_max_bytes else 0)
            for p in range(self.P)
        ]
        self._touch_clock = 0
        self._reload_bucket = 0
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
        while len(self._dispatch_fences) >= self._pipeline_depth:
            self._dispatch_fences.popleft().block_until_ready()
        self.pipeline_wait_s += time.perf_counter() - t0

    def _push_dispatch_fence(self) -> None:
        self._dispatch_fences.append(self.make_fence())

    @property
    def _spill_active(self) -> bool:
        return self.max_device_slots > 0

    def spill_counters(self) -> Dict[str, int]:
        """Spill traffic summed over shards (zeros when unbudgeted)."""
        return PagedSpillMap.zero_counters()

    # ------------------------------------------------ not in this slice

    def attach_watchdog(self, wd) -> None:
        raise _not_ported("the device watchdog", 12)

    def arm_replica(self, plane=None):
        raise _not_ported("the serving read replica", 12)

    def snapshot(self, mode: str = "full"):
        raise _not_ported("mesh engine snapshots", 8)

    def restore(self, snap, key_group_filter=None):
        raise _not_ported("mesh engine restore", 8)

    def reshard(self, new_shards: int, devices=None):
        raise _not_ported("live reshard", 12)

    def reassign_key_groups(self, assignment):
        raise _not_ported("hot key-group rebalance", 12)


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
        gathered = harvest_to_host(
            self._gather_step(self.accs, self._to_device(block)))
        for p, chosen in cohorts.items():
            idx = self.indexes[p]
            n = len(chosen)
            entry = {
                "key_id": np.asarray(idx.slot_key[chosen]),
                "ns": np.asarray(idx.slot_ns[chosen]),
                "dirty": self._dirty[p, chosen].copy(),
                **{f"leaf_{i}": g[p][:n] for i, g in enumerate(gathered)},
            }
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

    def _paged_restore_rows(self, key_ids, namespaces, leaves) -> None:
        raise _not_ported("restoring rows into the mesh page tier", 8)


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
        key_group_range: Optional[Tuple[int, int]] = None,
        max_dispatch_ahead: int = 2,
        shuffle_mode: str = "device",
        host_topology=None,
    ) -> None:
        if max_device_slots:
            raise _not_ported("the mesh window engine's spill tier "
                              "(state.slot-table.max-device-slots)", "7c")
        if shuffle_mode != "device":
            raise _not_ported(f"shuffle.mode={shuffle_mode!r}", 12)
        if host_topology is not None:
            raise _not_ported("the two-level exchange (shuffle.hosts)", 12)
        self.assigner = assigner
        self.agg = agg
        self.mesh = mesh
        self.P = int(mesh.size)
        self.device = mesh.device
        self.fire_projector = fire_projector
        self.key_group_range = key_group_range
        self.capacity = max(int(capacity_per_shard), 1024)
        self.max_parallelism = max_parallelism
        self.allowed_lateness = allowed_lateness
        if max_parallelism < self.P:
            raise ValueError(
                f"max_parallelism {max_parallelism} < mesh size {self.P}")
        # growable per-shard host indexes; the planes stay uniform
        # [P, cap] sized to the LARGEST shard index
        self.indexes = [
            make_slot_index(
                self.capacity, growable=True,
                on_grow=lambda old, new: self._shard_index_grew(new))
            for _ in range(self.P)
        ]
        self.accs: Tuple[torch.Tensor, ...] = tuple(
            torch.full((self.P, self.capacity),
                       np.asarray(leaf.identity).item(),
                       dtype=torch_dtype(leaf.dtype), device=self.device)
            for leaf in agg.leaves)
        # the [P, B] scatter step serves host shuffle mode (not ported)
        _, self._fire_step, self._reset_step, _, _ = build_mesh_steps(
            mesh, agg)
        self._exchange_scatter_step = build_exchange_scatter(mesh, agg)
        # window lifecycle metadata is global across shards
        self.book = SliceBookkeeper(assigner, allowed_lateness)
        self._init_pipeline(max_dispatch_ahead)
        self._fire_bucket = 0
        self._reset_bucket = 0

    # --------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        key_ids = batch.key_ids
        slice_ends = self.assigner.assign_slice_ends(batch.timestamps)
        live = self.book.live_mask(slice_ends)
        if live is not None:
            key_ids, slice_ends = key_ids[live], slice_ends[live]
            batch = batch.filter(live)
            if len(batch) == 0:
                return
        self.book.register_slices(slice_ends)
        shards = self._route(key_ids)
        self._process_batch_device(key_ids, slice_ends, shards,
                                   self.agg.map_input(batch),
                                   self.agg.input_leaves)

    def _process_batch_device(self, key_ids, slice_ends, shards, values,
                              leaves) -> None:
        """The host resolves slots (the index is host state) but never
        sorts or blocks the record columns: flat padded columns go to the
        device and the exchange+scatter step routes them to their shards."""
        n = len(key_ids)
        order = np.argsort(shards, kind="stable")
        counts = np.bincount(shards, minlength=self.P)
        offsets = np.zeros(self.P + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        s_keys = key_ids[order]
        s_ns = slice_ends[order]
        slots_sorted = np.empty(n, dtype=np.int32)
        for p in range(self.P):
            a, b = int(offsets[p]), int(offsets[p + 1])
            if a == b:
                continue
            slots_sorted[a:b] = self.indexes[p].lookup_or_insert(
                s_keys[a:b], s_ns[a:b])
        rec_slots = np.empty(n, dtype=np.int32)
        rec_slots[order] = slots_sorted
        # claim a dispatch slot BEFORE rewriting the pooled buffers
        self._await_dispatch_slot()
        self._shuffle_pool.flip()
        dst, staged, width = stage_device_exchange(
            shards, self.P,
            columns=[rec_slots,
                     *[np.asarray(v, dtype=l.dtype)
                       for v, l in zip(values, leaves)]],
            fills=[0, *[l.identity for l in leaves]],
            pool=self._shuffle_pool)
        cols = [self._to_device(c) for c in (dst, *staged)]
        self.accs = self._exchange_scatter_step(
            self.accs, cols[0], cols[1], tuple(cols[2:]), width)
        self._push_dispatch_fence()

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int,
                     async_ok: bool = False) -> List[object]:
        out: List[object] = []
        while True:
            w_end = self.book.next_window(watermark)
            if w_end is None:
                break
            batch = self._fire_window(w_end, async_ok=async_ok)
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
        slice_ends = self.assigner.slice_ends_for_window(window_end)
        k = len(slice_ends)
        per_shard_mats: List[np.ndarray] = []
        per_shard_keys: List[np.ndarray] = []
        w_max = 0
        for p in range(self.P):
            idx = self.indexes[p]
            chunks = [(i, idx.slots_for_namespace(se))
                      for i, se in enumerate(slice_ends)]
            chunks = [(i, s) for i, s in chunks if len(s) > 0]
            if not chunks:
                per_shard_mats.append(np.zeros((0, k), dtype=np.int32))
                per_shard_keys.append(np.empty(0, dtype=np.int64))
                continue
            all_slots = np.concatenate([s for _, s in chunks])
            all_sidx = np.concatenate(
                [np.full(len(s), i, dtype=np.int32) for i, s in chunks])
            keys, inv = np.unique(idx.slot_key[all_slots],
                                  return_inverse=True)
            mat = np.zeros((len(keys), k), dtype=np.int32)
            mat[inv, all_sidx] = all_slots
            per_shard_mats.append(mat)
            per_shard_keys.append(keys)
            w_max = max(w_max, len(keys))
        if w_max == 0:
            return None
        W = sticky_bucket(w_max, self._fire_bucket, minimum=64)
        self._fire_bucket = W
        sm = np.zeros((self.P, W, k), dtype=np.int32)
        for p, mat in enumerate(per_shard_mats):
            sm[p, : len(mat)] = mat
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

        pending = PendingFire([fire_out[n] for n in names], build)
        return pending if async_ok else pending.harvest()

    def _free_slices(self, ends: List[int]) -> None:
        f_max = 0
        freed: List[Optional[np.ndarray]] = []
        for p in range(self.P):
            slots = self.indexes[p].free_namespaces(ends)
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
        self.accs = self._reset_step(self.accs, self._to_device(block))


def build_mesh_steps(mesh: LogicalMesh, agg: AggregateFunction):
    """(scatter, fire, reset, gather, put) steps over ``[P, capacity]``
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

    def fire_step(accs, slot_matrix):
        P, W, k = slot_matrix.shape
        idx = slot_matrix.reshape(P, W * k).to(torch.int64)
        merged = tuple(m(torch.gather(a, 1, idx).view(P, W, k))
                       for a, m in zip(accs, merges))
        return finish(merged)

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

    return scatter_step, fire_step, reset_step, gather_step, put_step


def build_delta_fire_step(mesh: LogicalMesh, agg: AggregateFunction):
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
