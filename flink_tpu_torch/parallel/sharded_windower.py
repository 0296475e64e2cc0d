"""Mesh-sharded windowed keyed aggregation (port of
``flink_tpu/parallel/sharded_windower.py``, reduced to the Q5 path).

State lives in ``[P, capacity]`` planes on the mesh's device, one per
accumulator leaf, dim 0 being the key-group shard. Records are routed to
their owning shard by the reference's key-group formula; ingest runs the
fused exchange+scatter step (``parallel/shuffle.py``), a fire gathers and
merges a window's slices per shard on the device, and expired slices are
reset to identity. Every key's slices live on one shard, so fires and
resets are shard-local.

Left out of this slice, each raising ``NotImplementedError`` where a user
would select it: the spill tier, host shuffle mode, the two-level
exchange, snapshots and restore, live reshard and rebalance, the read
replica.
"""

from __future__ import annotations

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
from flink_tpu_torch.state.slot_table import make_slot_index
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.bookkeeping import SliceBookkeeper
from flink_tpu_torch.windowing.windower import (
    WINDOW_END_FIELD,
    WINDOW_START_FIELD,
)


def _not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to flink_tpu_torch yet (see ROADMAP.md, "
        "Queue A)")


class MeshWindowEngine:
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
            raise _not_ported("the spill tier "
                              "(state.slot-table.max-device-slots)")
        if shuffle_mode != "device":
            raise _not_ported(f"shuffle.mode={shuffle_mode!r}")
        if host_topology is not None:
            raise _not_ported("the two-level exchange (shuffle.hosts)")
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
        _, self._fire_step, self._reset_step = build_mesh_steps(mesh, agg)
        self._exchange_scatter_step = build_exchange_scatter(mesh, agg)
        # window lifecycle metadata is global across shards
        self.book = SliceBookkeeper(assigner, allowed_lateness)
        # double-buffered dispatch-ahead: the host stages batch k+1 while
        # the device runs batch k; the pool rotates as many buffer
        # generations as batches may be in flight
        self._pipeline_depth = max(int(max_dispatch_ahead or 1), 1)
        self._shuffle_pool = ShuffleBufferPool(
            generations=self._pipeline_depth)
        self._dispatch_fences: deque = deque()
        self._fire_bucket = 0
        self._reset_bucket = 0

    def _route(self, key_ids) -> np.ndarray:
        """key id -> owning shard (the contiguous key-group formula)."""
        return shard_records(key_ids, self.P, self.max_parallelism,
                             self.key_group_range)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        # an async copy from PAGEABLE host memory has staged `host` when
        # it returns (no stream sync), so a pooled buffer may be
        # rewritten afterwards; on the CPU this is the array itself
        return torch.from_numpy(host).to(self.device, non_blocking=True)

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

    # ----------------------------------------------------------- pipelining

    def make_fence(self) -> Fence:
        """A completion marker enqueued after everything dispatched so far
        (the engine's dispatch-ahead bound and the task loop's fences)."""
        return Fence(self.device)

    def _await_dispatch_slot(self) -> None:
        """Block until < depth dispatches are outstanding. MUST run before
        this batch's staging buffers are (re)written."""
        while len(self._dispatch_fences) >= self._pipeline_depth:
            self._dispatch_fences.popleft().block_until_ready()

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
        self._dispatch_fences.append(self.make_fence())

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

    # ------------------------------------------------ not in this slice

    def snapshot(self, mode: str = "full"):
        raise _not_ported("mesh engine snapshots")

    def restore(self, snap, key_group_filter=None):
        raise _not_ported("mesh engine restore")

    def reshard(self, new_shards: int, devices=None):
        raise _not_ported("live reshard")

    def reassign_key_groups(self, assignment):
        raise _not_ported("hot key-group rebalance")

    def arm_replica(self, plane=None):
        raise _not_ported("the serving read replica")


def build_mesh_steps(mesh: LogicalMesh, agg: AggregateFunction):
    """(scatter, fire, reset) steps over ``[P, capacity]`` planes. The
    planes are updated IN PLACE where the reference donated them.

    - ``scatter(accs, slots [P, B], values)``: fold per-shard record
      blocks (one ``[P, B]`` block per *input* leaf; const leaves derive
      on the device; lanes at slot 0 are padding).
    - ``fire(accs, slot_matrix [P, W, k]) -> {name: [P, W]}``: gather each
      row's k slices, merge over the slice axis, finish.
    - ``reset(accs, slots [P, F])``: set freed slots to identity.
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

    return scatter_step, fire_step, reset_step
