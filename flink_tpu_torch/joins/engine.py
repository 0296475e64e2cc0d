"""Two-input join engines over dual keyed row tables on the logical mesh
(port of ``flink_tpu/joins/engine.py``).

Both inputs ride the device exchange co-partitioned onto the same P
key-group shards by the same routing, so a key's left and right rows
share a shard and every probe is shard-local. Per batch the device runs at
most three programs (``joins/kernels.py``): the ingest exchange-put (with
one launch of the exchange-rank kernel), the banded probe, and, under
budget pressure, one eviction gather.

- :class:`MeshIntervalJoinEngine`: keyed interval join (a left row at
  ``t`` matches right rows in ``[t+lower, t+upper]``). A new batch probes
  the OTHER side's table before inserting into its own (a pair is emitted
  by whichever side arrives second), with each probe's band
  ``[lo, lo+cnt)`` resolved on the host metadata and the candidates
  gathered by ONE banded-probe program per batch.
- :class:`MeshTemporalJoinEngine`: event-time temporal join (``FOR
  SYSTEM_TIME AS OF``): the right side is a versioned row table; left rows
  wait for the combined watermark, then one probe per watermark picks each
  row's latest version at-or-before its time (the band of width 1).
  Version state compacts on every watermark.

``backend="host"`` runs the numpy oracle: the same metadata code and
emission order, value movement in host arrays; the device backend must
equal it bit for bit.

Side replicas (``arm_side_replica``, ``tenancy/replica.py``): after every
watermark's prunes each armed side publishes its identity churn (inserts,
evictions, prunes — rows never change after insert) into the next sealed
generation.

Live ``reshard`` lifts both sides through their snapshots onto a
rebuilt logical mesh. The device-backend ingest runs the flat device
exchange, its two-level form under a multi-host ``host_topology``
(``parallel/exchange2.py``), or host bucketing into ``[P, B]`` blocks
(``shuffle_mode="host"``). ``query_side_batch`` reads a
side's buffered rows per key: resident values through one gather and one
copy back, cold rows from the page tiers.
Each ingest and watermark is a flight-recorder span. Shard-granular
units (``snapshot_sharded``, ``merge_unit_snapshots``,
``restore(key_group_filter=)``) and the device watchdog's hooks are as in
the mesh window engines. The reference's flight-recorder spans are not carried: the port's profiles
wrap the engine's methods in host timers instead
(``benchmarks/joins.py --profile``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.core.device import DeviceLike
from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.joins import kernels
from flink_tpu_torch.joins.side_table import JoinSideTable, pair_lower_bound
from flink_tpu_torch.ops.segment_ops import (
    pad_bucket_size,
    sticky_bucket,
    torch_dtype,
)
from flink_tpu_torch.parallel.exchange2 import (
    ExchangeTraffic,
    build_join_exchange2_steps,
    stage_two_level_exchange,
    two_level_active,
)
from flink_tpu_torch.parallel.mesh import LogicalMesh, make_mesh
from flink_tpu_torch.parallel.shuffle import (
    ShuffleBufferPool,
    bucket_by_shard,
    shard_records,
    stage_device_exchange,
)
from flink_tpu_torch.runtime.pending import Fence, harvest_to_host
from flink_tpu_torch.runtime.watchdog import WatchdogHooks
from flink_tpu_torch.state.keygroups import (
    assign_key_groups,
    shard_key_group_ranges,
)
from flink_tpu_torch.state.paged_spill import restore_into_pages

_NEG = -(1 << 62)

SIDE_NAMES = ("left", "right")


def _suffixed_names(left_names: Sequence[str],
                    right_names: Sequence[str],
                    suffixes: Tuple[str, str]
                    ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Output column name per input column, as the host join operators'
    ``_merge_columns``: a name present on both sides gets the side
    suffix, everything else passes through."""
    overlap = set(left_names) & set(right_names)
    lmap = {n: (n + suffixes[0] if n in overlap else n)
            for n in left_names}
    rmap = {n: (n + suffixes[1] if n in overlap else n)
            for n in right_names}
    return lmap, rmap


class JoinEngineBase(WatchdogHooks):
    """Shared machinery of the two-input engines: the dual side tables,
    the staging, eviction, probing and checkpoints."""

    #: subclasses set: "interval" or "temporal"
    kind: str = ""

    def __init__(self, mesh: Optional[LogicalMesh] = None,
                 num_shards: int = 1,
                 capacity_per_shard: int = 1 << 16,
                 max_parallelism: int = 128,
                 max_device_slots: int = 0,
                 spill_dir: Optional[str] = None,
                 spill_host_max_bytes: int = 0,
                 key_group_range: Optional[Tuple[int, int]] = None,
                 backend: str = "device",
                 shuffle_mode: str = "device",
                 host_topology=None,
                 suffixes: Tuple[str, str] = ("_l", "_r"),
                 device: DeviceLike = None) -> None:
        if backend not in ("device", "host"):
            raise ValueError(
                f"backend must be 'device' or 'host', got {backend!r}")
        if shuffle_mode not in ("device", "host"):
            raise ValueError(
                f"shuffle_mode must be 'device' or 'host', got "
                f"{shuffle_mode!r}")
        self.backend = backend
        self.shuffle_mode = shuffle_mode
        self.mesh: Optional[LogicalMesh] = None
        self.device = torch.device("cpu")
        if backend == "device":
            if mesh is None:
                mesh = make_mesh(num_shards, device)
            self.mesh = mesh
            self.P = int(mesh.size)
            self.device = mesh.device
        else:
            self.P = int(num_shards)
        self.capacity = max(int(capacity_per_shard), 256)
        self.max_device_slots = int(max_device_slots or 0)
        if self.max_device_slots:
            self.capacity = min(self.capacity,
                                max(self.max_device_slots, 256))
        self.max_parallelism = int(max_parallelism)
        if self.max_parallelism < self.P:
            raise ValueError(
                f"max_parallelism {max_parallelism} < shard count "
                f"{self.P}")
        self.key_group_range = key_group_range
        self.spill_dir = spill_dir
        self.spill_host_max_bytes = int(spill_host_max_bytes or 0)
        self.suffixes = tuple(suffixes)
        #: per-side state, created at the side's first batch (the value
        #: schema is observed)
        self.sides: List[Optional[JoinSideTable]] = [None, None]
        self._planes: List[Optional[Tuple[torch.Tensor, ...]]] = [None, None]
        self._next_rid = 1
        # sticky power-of-two shapes of the probe's staging (per side):
        # the pool keeps one buffer per shape, so its shapes stay few
        self._mirror_bucket = [0, 0]
        self._probe_bucket = [0, 0]
        self._band_bucket = [0, 0]
        if backend == "device":
            self._pool = ShuffleBufferPool(generations=2)
            self._fences: List[Fence] = []
        #: (hosts, local) factorization of the mesh: device-mode ingest
        #: then runs the two-level exchange
        self.host_topology = None
        self._exchange2_traffic = None
        if host_topology is not None:
            if backend != "device":
                raise ValueError(
                    "host_topology requires the device backend")
            host_topology.check_covers(self.P)
            self.host_topology = host_topology
            self._exchange2_traffic = ExchangeTraffic()

    def _two_level_active(self) -> bool:
        return two_level_active(self.host_topology, self.shuffle_mode)

    def exchange2_traffic(self) -> Dict[str, int]:
        """The two-level exchange's traffic split (zeros when flat)."""
        return ExchangeTraffic.dict_of(self._exchange2_traffic)


    # ----------------------------------------------------------- data plane

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        # an async copy from PAGEABLE host memory has staged `host` when
        # it returns, so a pooled buffer may be rewritten afterwards; the
        # fences below bound how far the host runs ahead all the same
        return torch.from_numpy(np.ascontiguousarray(host)).to(
            self.device, non_blocking=True)

    def _drain_fences(self) -> None:
        if self.backend != "device":
            return
        with self._wd_section("fence_drain"):
            while self._fences:
                self._fences.pop(0).block_until_ready()

    def _push_fence(self) -> None:
        with self._wd_section("dispatch_fence"):
            self._fences.append(Fence(self.device))
        # one staging generation may be in flight; the next must wait
        if len(self._fences) > 1:
            with self._wd_section("fence_drain"):
                self._fences.pop(0).block_until_ready()

    def _ensure_side(self, side_idx: int, batch: RecordBatch
                     ) -> JoinSideTable:
        side = self.sides[side_idx]
        if side is not None:
            return side
        schema = sorted(
            (n, np.asarray(batch[n]).dtype) for n in batch.names()
            if n not in (KEY_ID_FIELD, TIMESTAMP_FIELD))
        return self._init_side(side_idx, schema)

    def _init_side(self, side_idx: int, schema) -> JoinSideTable:
        sdir = (f"{self.spill_dir.rstrip('/')}/{SIDE_NAMES[side_idx]}"
                if self.spill_dir else None)
        side = JoinSideTable(
            self.P, self.capacity, schema,
            max_device_slots=self.max_device_slots,
            spill_dir=sdir,
            # the operator's host page-memory budget splits across the
            # two sides (each side then splits per shard)
            spill_host_max_bytes=self.spill_host_max_bytes // 2,
            backend=self.backend)
        self.sides[side_idx] = side
        if self.backend == "device":
            self._planes[side_idx] = tuple(
                torch.zeros((self.P, side.capacity),
                            dtype=torch_dtype(side.schema[i][1]),
                            device=self.device)
                for i in side.device_cols)
        return side

    def _check_schema(self, side: JoinSideTable,
                      batch: RecordBatch, side_idx: int) -> None:
        names = set(batch.names()) - {KEY_ID_FIELD, TIMESTAMP_FIELD}
        declared = {n for n, _ in side.schema}
        if names != declared:
            raise RuntimeError(
                f"{SIDE_NAMES[side_idx]} join input changed columns "
                f"mid-stream: {sorted(declared)} -> {sorted(names)}")

    def _shards_of(self, keys: np.ndarray) -> np.ndarray:
        return shard_records(keys, self.P, self.max_parallelism,
                             self.key_group_range)

    # --------------------------------------------------------------- ingest

    def _ingest(self, side_idx: int, keys: np.ndarray, ts: np.ndarray,
                values: List[np.ndarray], shards=None) -> None:
        """Insert rows into ``side_idx``'s table: route, make headroom,
        allocate slots, merge metadata, move values (the fused exchange or
        the host shadow). ``values`` in schema order; ``shards`` lets a
        caller that already routed these keys skip the second pass."""
        n = len(keys)
        if n == 0:
            return
        if shards is None:
            shards = self._shards_of(keys)
        # chaos: the two-input data plane. Payload kinds (drop /
        # duplicate) mutate one shard's rows BEFORE any state mutation —
        # a bucket lost or replayed in flight; raise/delay fire at the
        # post-dispatch site below (a crash mid-batch with the put on the
        # device queue)
        if chaos.armed():
            mutations: Dict[int, str] = {}
            for p in np.unique(shards).tolist():
                rule = chaos.payload_action(
                    "join.exchange",
                    kinds=("drop", "duplicate", "delay"),
                    shard=int(p), side=side_idx)
                if rule is not None and rule.kind in ("drop",
                                                      "duplicate"):
                    mutations[int(p)] = rule.kind
            for p, mkind in mutations.items():
                sel = shards == p
                if mkind == "drop":
                    keep = ~sel
                    keys, ts, shards = keys[keep], ts[keep], shards[keep]
                    values = [v[keep] for v in values]
                else:
                    keys = np.concatenate([keys, keys[sel]])
                    ts = np.concatenate([ts, ts[sel]])
                    shards = np.concatenate([shards, shards[sel]])
                    values = [np.concatenate([v, v[sel]])
                              for v in values]
            n = len(keys)
            if n == 0:
                return
        self._ingest_rows(side_idx, keys, ts, values, shards)
        chaos.fault_point("join.exchange", records=n, side=side_idx)

    def _ingest_rows(self, side_idx: int, keys, ts, values,
                     shards) -> None:
        """Route/allocate/insert, bisecting when one batch's per-shard rows
        exceed the plane (rows of the SAME chunk cannot evict each
        other)."""
        side = self.sides[side_idx]
        n = len(keys)
        counts = np.bincount(shards, minlength=self.P)
        if side.spill_active and int(counts.max()) > side.capacity - 1 \
                and n > 1:
            half = n // 2
            self._ingest_rows(side_idx, keys[:half], ts[:half],
                              [v[:half] for v in values],
                              shards[:half])
            self._ingest_rows(side_idx, keys[half:], ts[half:],
                              [v[half:] for v in values],
                              shards[half:])
            return
        rids = np.arange(self._next_rid, self._next_rid + n,
                         dtype=np.int64)
        self._next_rid += n
        if side.spill_active:
            self._make_headroom(side_idx, counts)
        else:
            need = int(counts.max()) if n else 0
            while any(side.free_headroom(p) < counts[p]
                      for p in range(self.P)):
                self._grow_side(side_idx, max(
                    side.capacity * 2,
                    pad_bucket_size(side.capacity + need)))
        slots = np.zeros(n, dtype=np.int32)
        order = np.argsort(shards, kind="stable")
        offs = np.concatenate(([0], np.cumsum(counts)))
        for p in np.nonzero(counts)[0].tolist():
            sel = order[offs[p]:offs[p + 1]]
            sl = side.allocate(p, len(sel))
            slots[sel] = sl
            side.meta[p].merge_rows(
                keys[sel], ts[sel], rids[sel], sl,
                np.ones(len(sel), dtype=bool))
            for i in side.shadow:
                side.shadow[i][p][sl] = np.asarray(
                    values[i], dtype=side.schema[i][1])[sel]
        if self.backend == "device" and side.device_cols:
            self._device_put_rows(side_idx, shards, slots, values)

    def _device_put_rows(self, side_idx: int, shards, slots,
                         values) -> None:
        """Stage the rows' flat columns (one H2D each) and run the fused
        exchange-put on the side's planes."""
        side = self.sides[side_idx]
        cols = [np.asarray(slots, dtype=np.int32)] + [
            np.asarray(values[i], dtype=side.schema[i][1])
            for i in side.device_cols]
        fills = [0] + [side.schema[i][1].type(0)
                       for i in side.device_cols]
        self._pool.flip()
        planes = self._planes[side_idx]
        if self._two_level_active():
            # the two-level exchange, then the plane write: stream order
            # is kept, so the last write wins as in the flat exchange
            dst, staged, w1, w2 = stage_two_level_exchange(
                shards, self.host_topology, columns=cols, fills=fills,
                pool=self._pool, traffic=self._exchange2_traffic)
            s1, s2 = build_join_exchange2_steps(
                self.mesh, self.host_topology,
                tuple(side.schema[i][1].name for i in side.device_cols))
            put = [self._to_device(c) for c in (dst, *staged)]
            inter = s1(put[0], put[1], tuple(put[2:]), w1)
            s2(planes, inter[0], inter[1], tuple(inter[2:]), w2)
        elif self.shuffle_mode == "device":
            dst, staged, width = stage_device_exchange(
                shards, self.P, columns=cols, fills=fills, pool=self._pool)
            put = [self._to_device(c) for c in (dst, *staged)]
            kernels.join_exchange_put(planes, put[0], put[1], put[2:],
                                      width)
        else:
            _, blocked = bucket_by_shard(
                shards, self.P, columns=cols, fills=fills, pool=self._pool)
            put = [self._to_device(b) for b in blocked]
            kernels.join_put(planes, put[0], put[1:])
        self._push_fence()

    # ------------------------------------------------------------- eviction

    def _make_headroom(self, side_idx: int, needed: np.ndarray) -> None:
        """Evict the coldest (oldest-ts) rows of every shard that cannot
        absorb its share of the batch: cohorts gathered in ONE program +
        ONE device->host copy across shards."""
        side = self.sides[side_idx]
        cohorts: Dict[int, np.ndarray] = {}
        for p in range(self.P):
            if side.free_headroom(p) >= int(needed[p]):
                continue
            pos = side.choose_eviction(
                p, int(needed[p]) - side.free_headroom(p))
            cohorts[p] = pos
        if not cohorts:
            return
        # host backend: shadow_values already carries every column
        vals = (self._gather_rows(side_idx, {
            p: side.meta[p].slot[pos] for p, pos in cohorts.items()})
            if self.backend == "device" and side.device_cols else None)
        for p, pos in cohorts.items():
            columns = side.shadow_values(p, pos)
            if vals is not None:
                for j, i in enumerate(side.device_cols):
                    columns[i] = vals[p][j]
            side.evict_rows(p, pos, columns)

    def _gather_rows(self, side_idx: int,
                     per_shard_slots: Dict[int, np.ndarray]
                     ) -> Dict[int, List[np.ndarray]]:
        """Device-column values at the given slots, per shard: one gather
        + ONE device->host copy for all shards."""
        G = max(len(s) for s in per_shard_slots.values())
        block = np.zeros((self.P, G), dtype=np.int32)
        for p, slots in per_shard_slots.items():
            block[p, :len(slots)] = slots
        host = self._harvest_get(
            kernels.join_gather(self._planes[side_idx],
                                self._to_device(block)), "evict_harvest")
        return {p: [h[p][:len(slots)] for h in host]
                for p, slots in per_shard_slots.items()}

    # --------------------------------------------------- read replica
    # (tenancy/replica.py — publish hooks for the join side tables;
    # rows are immutable after insert, so the boundary delta is pure
    # identity churn: inserts, evictions, prunes)

    #: per-side ReplicaPlane (armed by arm_side_replica)
    _side_replicas = (None, None)

    def arm_side_replica(self, side_idx: int):
        """Arm a read replica over one side table (device backend; the
        side must have seen its first batch — the value schema is
        late-bound). Returns a
        :class:`~flink_tpu_torch.tenancy.replica.JoinSideReplicaAdapter`."""
        from flink_tpu_torch.tenancy.replica import (
            JoinSideReplicaAdapter,
            ReplicaPlane,
        )

        side = self.sides[side_idx]
        if side is None:
            raise RuntimeError(
                "side table not initialized yet — the value schema is "
                "observed at the side's first batch")
        if self.backend != "device":
            raise RuntimeError(
                "side replicas ride the device value planes; the host "
                "oracle backend serves reads directly")

        class _Leaf:
            def __init__(self, dtype):
                self.dtype = dtype
                self.identity = np.dtype(dtype).type(0)

        plane = ReplicaPlane(
            self.mesh, [_Leaf(side.schema[i][1])
                        for i in side.device_cols], side.capacity)
        reps = list(self._side_replicas)
        reps[side_idx] = plane
        self._side_replicas = tuple(reps)
        return JoinSideReplicaAdapter(plane, side)

    def _publish_side_replicas(self, watermark: int) -> None:
        for side_idx in (0, 1):
            rep = self._side_replicas[side_idx]
            side = self.sides[side_idx]
            if rep is None or side is None:
                continue
            with flight.span("serving.replica_publish",
                             watermark=int(watermark)):
                self._publish_one_side(rep, side, side_idx,
                                       int(watermark))

    def _publish_one_side(self, rep, side, side_idx: int,
                          watermark: int) -> None:
        """The join form of the boundary publish: derive per-slot
        metadata from the sorted row metadata, diff against the
        replica's shadow (rows are immutable — identity changes ARE
        the delta), split disappeared rows into cold (still mapped in
        the page tier) vs pruned, and hand the changed slots to the
        shared publish program."""
        if not hasattr(self, "_rep_last_rid"):
            self._rep_last_rid = [0, 0]
        if rep.needs_rebuild(self.P, side.capacity):
            rep.rebuild(self.mesh, side.capacity)
            # a rebuild's republish covers resident rows; resetting the
            # rid watermark makes every COLD row re-enter the index too
            self._rep_last_rid[side_idx] = 0
        last_rid = self._rep_last_rid[side_idx]
        per_shard = {}
        for p in range(self.P):
            m = side.meta[p]
            cap = side.capacity
            cur_used = np.zeros(cap, dtype=bool)
            cur_key = np.zeros(cap, dtype=np.int64)
            cur_rid = np.zeros(cap, dtype=np.int64)
            cur_ts = np.zeros(cap, dtype=np.int64)
            res = np.nonzero(m.slot >= 0)[0]
            slots_res = m.slot[res]
            cur_used[slots_res] = True
            cur_key[slots_res] = m.key[res]
            cur_rid[slots_res] = m.rid[res]
            cur_ts[slots_res] = m.ts[res]
            r_used = rep.rep_used[p]
            r_key = rep.rep_key[p]
            r_rid = rep.rep_ns[p]
            moved = (cur_key != r_key) | (cur_rid != r_rid)
            ident_change = cur_used & (~r_used | moved)
            up = np.nonzero(ident_change)[0]
            gone = np.nonzero(r_used & (~cur_used | moved))[0]
            cold: List[Tuple[int, int]] = []
            freed: List[Tuple[int, int]] = []
            if len(gone):
                from flink_tpu_torch.joins.side_table import _rid_positions

                g_keys = r_key[gone].copy()
                g_rids = r_rid[gone].copy()
                # still resident at another slot? covered by its upsert
                found, src = _rid_positions(m.rid, g_rids)
                still = np.zeros(len(g_rids), dtype=bool)
                still[found] = m.slot[src] >= 0
                miss = ~still
                if miss.any():
                    mk, mr = g_keys[miss], g_rids[miss]
                    is_cold = side.pmaps[p].spilled_mask(
                        np.asarray(mr, dtype=np.int64))
                    for j in range(len(mk)):
                        if is_cold[j]:
                            cold.append((int(mk[j]), int(mr[j]), None))
                        else:
                            freed.append((int(mk[j]), int(mr[j])))
            # rows created AND evicted since the last publish (never
            # resident at a boundary): rids are allocation-monotonic,
            # so "new" is one vectorized compare
            new_cold = np.nonzero((m.slot < 0) & (m.rid > last_rid))[0]
            for pos in new_cold.tolist():
                cold.append((int(m.key[pos]), int(m.rid[pos]),
                             (int(m.ts[pos]), None)))
            # extra payload: (ts, host-shadow column values) per row —
            # device-ineligible columns never ride the device plane
            extra = None
            if len(up):
                host_cols = [side.shadow[i][p][up]
                             for i in side.host_cols]
                extra = [
                    (int(cur_ts[s]),
                     tuple(hc[j] for hc in host_cols))
                    for j, s in enumerate(up)]
            per_shard[p] = {
                "resident": (cur_used, cur_key, cur_rid),
                "up_slots": up.astype(np.int32),
                "up_keys": cur_key[up].copy(),
                "up_ns": cur_rid[up].copy(),
                "up_extra": extra,
                "cold": cold,
                "freed": freed,
                "fresh": bool(ident_change.any()),
            }
        # the shadow (the published index's slot metadata) and the rid
        # watermark move ONLY when the publish succeeds (a torn publish
        # must leave the delta re-derivable)
        rep.publish(self._planes[side_idx] or (), per_shard, watermark)
        self._rep_last_rid[side_idx] = self._next_rid - 1

    def query_side_batch(self, side_idx: int, key_ids
                         ) -> List[List[dict]]:
        """Live point lookup against one side table (reference
        ``flink_tpu/joins/engine.py:1171``): per requested key, the side's
        buffered rows as ``[{"ts", "rid", <col>: v}, ...]`` sorted by
        (ts, rid), values as Python scalars. Resident rows through ONE
        gather and ONE device-to-host copy for all shards (the host
        backend reads its shadow store), cold rows from their shards' page
        tiers (``cold_rows_served`` counts them). No row moves."""
        side_idx = int(side_idx)
        side = self.sides[side_idx]
        key_ids = np.asarray(key_ids, dtype=np.int64)
        n = len(key_ids)
        results: List[List[dict]] = [[] for _ in range(n)]
        if side is None or n == 0:
            return results
        shards = self._shards_of(key_ids)
        #: (request row, meta position) per matched row, per shard
        rows_of: Dict[int, List[Tuple[int, int]]] = {}
        for p in np.unique(shards).tolist():
            m = side.meta[p]
            if not len(m):
                continue
            sel = np.nonzero(shards == p)[0]
            lo = pair_lower_bound(m.key, m.ts, key_ids[sel],
                                  np.full(len(sel), -(1 << 62)))
            hi = pair_lower_bound(m.key, m.ts, key_ids[sel],
                                  np.full(len(sel), (1 << 62)))
            lanes = []
            for j, r in enumerate(sel.tolist()):
                for pos in range(int(lo[j]), int(hi[j])):
                    lanes.append((r, pos))
            if lanes:
                rows_of[int(p)] = lanes
        per_shard_slots = {
            p: np.clip(side.meta[p].slot[[pos for _, pos in lanes]],
                       0, None)
            for p, lanes in rows_of.items()}
        if not rows_of:
            gathered = {}
        elif self.backend == "host" or not side.device_cols:
            gathered = {p: [side.shadow[i][p][sc] for i in side.device_cols]
                        for p, sc in per_shard_slots.items()}
        else:
            gathered = self._gather_rows(side_idx, per_shard_slots)
        names = [nm for nm, _ in side.schema]
        for p, lanes in rows_of.items():
            m = side.meta[p]
            cold_wants: List[Tuple[int, int, int]] = []
            sinks = [np.zeros(len(lanes), dtype=dt)
                     for _, dt in side.schema]
            rows_arr = np.arange(len(lanes))
            for j, (r, pos) in enumerate(lanes):
                if m.slot[pos] < 0:
                    cold_wants.append((j, int(m.key[pos]),
                                       int(m.rid[pos])))
                else:
                    for i in side.shadow:
                        sinks[i][j] = side.shadow[i][p][m.slot[pos]]
                    for gi, i in enumerate(side.device_cols):
                        sinks[i][j] = gathered[p][gi][j]
            if cold_wants:
                side.fill_cold(p, cold_wants, sinks, rows_arr)
            for j, (r, pos) in enumerate(lanes):
                row = {"ts": int(m.ts[pos]), "rid": int(m.rid[pos])}
                for i, nm in enumerate(names):
                    row[nm] = sinks[i][j].item()
                results[r].append(row)
        for r in range(n):
            results[r].sort(key=lambda d: (d["ts"], d["rid"]))
        return results

    def _grow_side(self, side_idx: int, new_capacity: int) -> None:
        side = self.sides[side_idx]
        old = side.capacity
        if new_capacity <= old:
            return
        side.grow(new_capacity)
        if self.backend == "device" and side.device_cols:
            grown = []
            for pl in self._planes[side_idx]:
                wide = torch.zeros((self.P, new_capacity), dtype=pl.dtype,
                                   device=self.device)
                wide[:, :old] = pl
                grown.append(wide)
            self._planes[side_idx] = tuple(grown)

    # --------------------------------------------------------------- probes

    def _probe_banded(self, store_idx: int,
                      per_shard: Dict[int, Tuple[np.ndarray,
                                                 np.ndarray,
                                                 np.ndarray]],
                      band) -> Dict[int, dict]:
        """The banded probe: ``per_shard[p] = (orig_rows, keys, ts)``;
        ``band(meta, keys, ts) -> (lo, cnt)`` resolves each probe's
        candidate band over the shard's sorted metadata. Returns per shard
        the flattened match structure and the stored side's value columns
        (device-gathered for resident candidates, page-served for cold
        ones), identical in both backends."""
        side = self.sides[store_idx]
        bounds: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        w_max = 0
        b_max = 0
        s_max = 0
        total = 0
        for p, (_, pk, pt) in per_shard.items():
            m = side.meta[p]
            lo, cnt = band(m, pk, pt)
            bounds[p] = (lo, cnt)
            if len(cnt):
                w_max = max(w_max, int(cnt.max()))
                total += int(cnt.sum())
            b_max = max(b_max, len(pk))
            s_max = max(s_max, len(m))
        gathered_host = None
        W = 0
        if total and w_max:
            W = sticky_bucket(w_max, self._band_bucket[store_idx],
                              minimum=8)
            self._band_bucket[store_idx] = W
        if (self.backend == "device" and side.device_cols and total
                and W):
            gathered_host = self._dispatch_probe(
                store_idx, per_shard, bounds, W, b_max, s_max)
        out: Dict[int, dict] = {}
        for p, (orig, pk, pt) in per_shard.items():
            lo, cnt = bounds[p]
            t = int(cnt.sum()) if len(cnt) else 0
            if t == 0:
                continue
            m = side.meta[p]
            l_rep = np.repeat(np.arange(len(pk), dtype=np.int64), cnt)
            off = (np.arange(t, dtype=np.int64)
                   - np.repeat(np.cumsum(cnt) - cnt, cnt))
            cand = lo[l_rep] + off
            cslot = m.slot[cand]
            resident = cslot >= 0
            cols: List[np.ndarray] = []
            for i, (_, dt) in enumerate(side.schema):
                if i in side.shadow:
                    cols.append(side.shadow[i][p]
                                [np.clip(cslot, 0, None)].copy())
                else:
                    g = gathered_host[side.device_cols.index(i)][p]
                    cols.append(np.ascontiguousarray(
                        g[l_rep, off]).astype(dt, copy=False))
            cold = np.nonzero(~resident)[0]
            if len(cold):
                side.fill_cold(
                    p,
                    [(int(j), int(pk[l_rep[j]]), int(m.rid[cand[j]]))
                     for j in cold.tolist()],
                    cols, np.arange(t, dtype=np.int64))
            out[p] = {
                "orig": orig, "l_rep": l_rep, "cand": cand,
                "cols": cols, "ts": m.ts[cand], "resident": resident,
            }
        return out

    def _dispatch_probe(self, store_idx, per_shard, bounds, W,
                        b_max, s_max) -> List[np.ndarray]:
        """Stage the sorted-order slot mirror + band bounds, run the
        banded probe and copy every output column to the host in ONE
        synchronous copy."""
        side = self.sides[store_idx]
        S = sticky_bucket(max(s_max, 1),
                          self._mirror_bucket[store_idx])
        self._mirror_bucket[store_idx] = S
        B = sticky_bucket(max(b_max, 1),
                          self._probe_bucket[store_idx], minimum=64)
        self._probe_bucket[store_idx] = B
        # NO pool flip here: the probe is synchronous (its harvest below
        # completes before this method returns), so its tagged buffers are
        # free to rewrite next batch; a second flip per batch would break
        # the ingest's double buffer
        mirror = self._pool.get((self.P, S), np.int32, -1,
                                tag=("probe", "mirror", store_idx))
        lo_b = self._pool.get((self.P, B), np.int32, 0,
                              tag=("probe", "lo", store_idx))
        cnt_b = self._pool.get((self.P, B), np.int32, 0,
                               tag=("probe", "cnt", store_idx))
        for p, (_, pk, _pt) in per_shard.items():
            m = side.meta[p]
            mirror[p, :len(m)] = m.slot
            lo, cnt = bounds[p]
            lo_b[p, :len(pk)] = lo
            cnt_b[p, :len(pk)] = cnt
        outs = kernels.banded_probe(
            self._planes[store_idx], self._to_device(mirror),
            self._to_device(lo_b), self._to_device(cnt_b), W)
        return self._harvest_get(outs, "join_probe_harvest")

    # ------------------------------------------------------ match assembly

    def _assemble(self, probe_idx: int, probe_cols: Dict[str,
                                                         np.ndarray],
                  probe_ts: np.ndarray,
                  probe_keys: np.ndarray,
                  probed: Dict[int, dict],
                  out_ts) -> Optional[RecordBatch]:
        """One output batch from the per-shard probe results: shard-major,
        probe stream order within shard, band order within probe.
        ``out_ts(lt, rt)`` computes the emitted timestamp column."""
        store_idx = 1 - probe_idx
        store = self.sides[store_idx]
        if not probed:
            return None
        store_names = [n for n, _ in store.schema]
        probe_names = sorted(probe_cols)
        # _suffixed_names takes (left, right); the probe side is left only
        # when it is input 0
        if probe_idx == 0:
            pmap_names, smap_names = _suffixed_names(
                probe_names, store_names, self.suffixes)
        else:
            smap_names, pmap_names = _suffixed_names(
                store_names, probe_names, self.suffixes)
        chunks: List[Dict[str, np.ndarray]] = []
        for p in sorted(probed):
            r = probed[p]
            rows = r["orig"][r["l_rep"]]
            cols: Dict[str, np.ndarray] = {
                KEY_ID_FIELD: probe_keys[rows]}
            for n in probe_names:
                cols[pmap_names[n]] = probe_cols[n][rows]
            for i, n in enumerate(store_names):
                cols[smap_names[n]] = r["cols"][i]
            lt = probe_ts[rows]
            rt = r["ts"]
            cols[TIMESTAMP_FIELD] = out_ts(lt, rt)
            chunks.append(cols)
        if not chunks:
            return None
        merged = {k: (np.concatenate([c[k] for c in chunks])
                      if len(chunks) > 1 else chunks[0][k])
                  for k in chunks[0]}
        return RecordBatch(merged)

    # ------------------------------------------------------------ snapshots

    def _side_snapshot(self, side_idx: int) -> Dict[str, object]:
        side = self.sides[side_idx]
        if side is None:
            return {"table": {}, "schema": []}
        if self.backend == "device" and side.device_cols:
            host = self._harvest_get(self._planes[side_idx],
                                     "snapshot_harvest")
            device_values = [
                {i: host[j][p]
                 for j, i in enumerate(side.device_cols)}
                for p in range(self.P)]
        else:
            device_values = [{} for _ in range(self.P)]
        return {
            "table": side.snapshot_rows(self.max_parallelism,
                                        device_values),
            "schema": [(n, dt.str) for n, dt in side.schema],
        }

    def snapshot(self, mode: str = "full") -> Dict[str, object]:
        """The engine's logical state in the reference's format (the
        side tables' rows in rid order, resident and paged alike); every
        mode writes it whole."""
        self._drain_fences()
        return {
            "kind": self.kind,
            "left": self._side_snapshot(0),
            "right": self._side_snapshot(1),
            "next_rid": int(self._next_rid),
            **self._meta_snapshot(),
        }

    def _meta_snapshot(self) -> Dict[str, object]:
        return {}

    def _restore_meta(self, snap: Dict[str, object]) -> None:
        pass

    def restore(self, snap: Dict[str, object],
                key_group_filter=None) -> None:
        """Restore both side tables, re-sharded by key group;
        ``key_group_filter`` keeps only the rows of those key groups (a
        shard unit's range)."""
        for side_idx, name in ((0, "left"), (1, "right")):
            s = snap.get(name) or {}
            table = s.get("table") or {}
            schema = [(n, np.dtype(d)) for n, d in
                      s.get("schema", [])]
            self.sides[side_idx] = None
            self._planes[side_idx] = None
            if not schema:
                continue
            self._init_side(side_idx, schema)
            self._restore_rows(side_idx, table, key_group_filter)
        self._next_rid = max(int(snap.get("next_rid", 1)),
                             self._next_rid)
        self._restore_meta(snap)

    def _restore_rows(self, side_idx: int, table: Dict[str, object],
                      key_group_filter=None) -> None:
        side = self.sides[side_idx]
        keys = np.asarray(table.get("key_id", ()), dtype=np.int64)
        if not len(keys):
            return
        rids = np.asarray(table["namespace"], dtype=np.int64)
        ts = np.asarray(table["ts"], dtype=np.int64)
        dirty = np.asarray(table.get("dirty",
                                     np.zeros(len(keys), bool)),
                           dtype=bool)
        leaves = [np.asarray(table[f"leaf_{i}"],
                             dtype=side.schema[i][1])
                  for i in range(len(side.schema))]
        if key_group_filter is not None:
            kg = table.get("key_group")
            kg = (np.asarray(kg, dtype=np.int64) if kg is not None
                  else assign_key_groups(keys, self.max_parallelism))
            keep = np.isin(kg, np.asarray(sorted(
                int(g) for g in key_group_filter)))
            keys, rids, ts, dirty = (keys[keep], rids[keep], ts[keep],
                                     dirty[keep])
            leaves = [lv[keep] for lv in leaves]
            if not len(keys):
                return
        self._next_rid = max(self._next_rid, int(rids.max()) + 1)
        shards = self._shards_of(keys)
        if not side.spill_active:
            # an engine that grew during the run must be able to restore
            # its own snapshot: grow exactly like ingest does
            counts = np.bincount(shards, minlength=self.P)
            need = int(counts.max())
            while any(side.free_headroom(p) < counts[p]
                      for p in range(self.P)):
                self._grow_side(side_idx, max(
                    side.capacity * 2,
                    pad_bucket_size(side.capacity + need)))
        put_slots: Dict[int, np.ndarray] = {}
        put_sel: Dict[int, np.ndarray] = {}
        for p in range(self.P):
            sel = np.nonzero(shards == p)[0]
            if not len(sel):
                continue
            # newest rows stay resident (they expire last and are the
            # likeliest band candidates); the rest re-home as pages
            order = sel[np.argsort(-ts[sel], kind="stable")]
            n_res = min(len(order), side.free_headroom(p))
            res, cold = order[:n_res], order[n_res:]
            slots = side.allocate(p, n_res)
            slot_col = np.full(len(sel), -1, dtype=np.int32)
            if len(cold):
                restore_into_pages(
                    side.spills[p], side.pmaps[p], keys[cold],
                    rids[cold], [lv[cold] for lv in leaves],
                    page_rows=max(side.capacity // 8, 256),
                    dirty=dirty[cold], append=True)
            # metadata rows for everything (cold rows carry slot -1);
            # merge_rows sorts them
            both = np.concatenate([res, cold]).astype(np.int64)
            slot_col[:n_res] = slots
            side.meta[p].merge_rows(keys[both], ts[both], rids[both],
                                    slot_col, dirty[both])
            for i in side.shadow:
                side.shadow[i][p][slots] = leaves[i][res]
            if len(res):
                put_slots[p] = slots
                put_sel[p] = res
        if self.backend == "device" and side.device_cols and put_slots:
            B = max(len(s) for s in put_slots.values())
            slot_block = np.zeros((self.P, B), dtype=np.int32)
            val_blocks = [np.zeros((self.P, B),
                                   dtype=side.schema[i][1])
                          for i in side.device_cols]
            for p, slots in put_slots.items():
                m = len(slots)
                slot_block[p, :m] = slots
                for j, i in enumerate(side.device_cols):
                    val_blocks[j][p, :m] = leaves[i][put_sel[p]]
            kernels.join_put(self._planes[side_idx],
                             self._to_device(slot_block),
                             [self._to_device(v) for v in val_blocks])

    # ---------------------------------------------- shard-granular units

    def shard_key_groups(self) -> List[Tuple[int, int]]:
        return shard_key_group_ranges(self.P, self.max_parallelism,
                                      self.key_group_range)

    def snapshot_sharded(self, mode: str = "full"
                         ) -> Dict[Tuple[int, int], Dict[str, object]]:
        """One independently restorable unit per shard's key-group range:
        both sides' rows split by their ``key_group`` column, the scalar
        metadata replicated. The union of the units is ``snapshot()``."""
        snap = self.snapshot(mode)
        units: Dict[Tuple[int, int], Dict[str, object]] = {}
        for g0, g1 in self.shard_key_groups():
            unit = {"kind": snap["kind"],
                    "next_rid": snap["next_rid"],
                    **{k: v for k, v in snap.items()
                       if k not in ("kind", "left", "right",
                                    "next_rid")}}
            for name in ("left", "right"):
                s = snap[name]
                table = s.get("table") or {}
                kg = np.asarray(table.get("key_group", ()), dtype=np.int64)
                if len(kg):
                    mask = (kg >= g0) & (kg <= g1)
                    unit[name] = {
                        "table": {k: np.asarray(v)[mask]
                                  for k, v in table.items()},
                        "schema": s.get("schema", []),
                    }
                else:
                    unit[name] = {"table": dict(table),
                                  "schema": s.get("schema", [])}
            units[(int(g0), int(g1))] = unit
        return units

    def merge_unit_snapshots(self, units: List[Dict[str, object]]
                             ) -> Dict[str, object]:
        """Reassemble one snapshot from shard units (rows in rid order)."""
        merged: Dict[str, object] = {
            "kind": self.kind,
            "next_rid": max((int(u.get("next_rid", 1)) for u in units),
                            default=1),
            **self._merge_meta_units(units),
        }
        for name in ("left", "right"):
            tables = [u.get(name, {}).get("table") or {} for u in units]
            tables = [t for t in tables
                      if t and len(np.asarray(t.get("key_id", ())))]
            schema = next((u[name]["schema"] for u in units
                           if u.get(name, {}).get("schema")), [])
            if not tables:
                merged[name] = {"table": {}, "schema": schema}
                continue
            cols = sorted(set().union(*(set(t) for t in tables)))
            table = {k: np.concatenate([np.asarray(t[k]) for t in tables])
                     for k in cols}
            order = np.argsort(table["namespace"], kind="stable")
            merged[name] = {
                "table": {k: v[order] for k, v in table.items()},
                "schema": schema,
            }
        return merged

    def _merge_meta_units(self, units) -> Dict[str, object]:
        return {}

    # ------------------------------------------------------------- reshard

    def reshard(self, new_shards: int, devices=None) -> Dict[str, object]:
        """LIVE key-group migration to ``new_shards`` logical shards: both
        sides' logical rows (resident and paged, dirtiness kept) lift
        through their snapshots, the mesh and the side tables rebuild,
        and the rows land on their new owners. The job-lifetime spill
        counters survive. ``devices``: the logical shards of one card
        have no device list; only None is accepted. (The two-level
        exchange's host topology drops when it no longer covers P.)"""
        if devices is not None:
            raise ValueError(
                "devices=: the logical shards of one card have no device "
                "list (LogicalMesh)")
        new_shards = int(new_shards)
        if new_shards < 1:
            raise ValueError("new_shards must be >= 1")
        t0 = time.perf_counter()
        self._drain_fences()
        chaos.fault_point("rescale.handoff", stage="drain",
                          shards=new_shards)
        snaps = [self._side_snapshot(i) for i in (0, 1)]
        rows_moved = sum(
            len(np.asarray((s.get("table") or {}).get("key_id", ())))
            for s in snaps)
        if self.backend == "device":
            self.mesh = LogicalMesh(new_shards, self.device)
        self.P = new_shards
        t = self.host_topology
        if t is not None and t.num_shards != self.P:
            # the factorization no longer covers the resized mesh: the
            # flat exchange takes over
            self.host_topology = None
        if self.max_parallelism < self.P:
            raise ValueError(
                f"cannot reshard to {new_shards}: max_parallelism "
                f"{self.max_parallelism}")
        chaos.fault_point("rescale.handoff", stage="commit",
                          shards=new_shards)
        old_counters = [side.spill_counters() if side else None
                        for side in self.sides]
        for side_idx, snap in enumerate(snaps):
            schema = [(n, np.dtype(d)) for n, d in snap.get("schema", [])]
            self.sides[side_idx] = None
            self._planes[side_idx] = None
            if not schema:
                continue
            self._init_side(side_idx, schema)
            c = old_counters[side_idx]
            if c:
                side = self.sides[side_idx]
                pm = side.pmaps[0]
                for name in ("pages_evicted", "rows_evicted",
                             "pages_reloaded", "rows_reloaded",
                             "rows_compacted"):
                    setattr(pm, name, getattr(pm, name) + c[name])
                side.cold_rows_served = c["cold_rows_served"]
            # lifted rows keep their dirtiness (the snapshot's column)
            self._restore_rows(side_idx, snap.get("table") or {}, None)
        if self._watchdog is not None:
            self._watchdog.rebind(self.P, self._shard_ids())
        return {"shards": self.P, "rows_moved": rows_moved,
                "seconds": time.perf_counter() - t0}

    # ------------------------------------------------------------ counters

    def spill_counters(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for side in self.sides:
            if side is None:
                continue
            for k, v in side.spill_counters().items():
                out[k] = out.get(k, 0) + v
        return out

    #: the flight recorder's per-engine batch sequence
    _flight_batch = 0

    def process_batch(self, batch: RecordBatch,
                      input_index: int = 0) -> List[RecordBatch]:
        """One side's batch, in a ``batch.ingest`` span."""
        if len(batch) == 0:
            return []
        self._flight_batch += 1
        with flight.ingest_span(self._flight_batch):
            return self._process_batch_inner(batch, int(input_index))

    def on_watermark(self, watermark: int) -> List[RecordBatch]:
        """Fires and prunes of one watermark, in a ``fire.dispatch``
        span; then the side replicas' publish of this boundary."""
        with flight.fire_span(watermark):
            out = self._on_watermark_inner(watermark)
        self._publish_side_replicas(int(watermark))
        return out


class MeshIntervalJoinEngine(JoinEngineBase):
    """Keyed interval join over the dual row tables (INNER)."""

    kind = "interval"

    def __init__(self, lower: int, upper: int, **kw) -> None:
        if lower > upper:
            raise ValueError(f"lower {lower} > upper {upper}")
        super().__init__(**kw)
        self.lower = int(lower)
        self.upper = int(upper)

    # band of STORED rows matching a probe at time t:
    #   probe = left  -> stored right rows in [t+lower, t+upper]
    #   probe = right -> stored left rows with t in [lts+lower, lts+upper],
    #   i.e. lts in [t-upper, t-lower]
    def _band_for(self, probe_idx: int):
        if probe_idx == 0:
            blo, bhi = self.lower, self.upper
        else:
            blo, bhi = -self.upper, -self.lower

        def band(m, pk, pt):
            lo = pair_lower_bound(m.key, m.ts, pk, pt + blo)
            hi = pair_lower_bound(m.key, m.ts, pk, pt + bhi + 1)
            return lo, (hi - lo).astype(np.int64)

        return band

    def _process_batch_inner(self, batch: RecordBatch,
                             input_index: int) -> List[RecordBatch]:
        self._wd_boundary()
        side_idx = int(input_index)
        side = self._ensure_side(side_idx, batch)
        self._check_schema(side, batch, side_idx)
        keys = np.asarray(batch.key_ids, dtype=np.int64)
        ts = np.asarray(batch.timestamps, dtype=np.int64)
        values = [np.asarray(batch[n]) for n, _ in side.schema]
        out: List[RecordBatch] = []
        store_idx = 1 - side_idx
        store = self.sides[store_idx]
        shards = self._shards_of(keys)
        if store is not None and store.num_rows():
            per_shard: Dict[int, Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]] = {}
            for p in np.unique(shards).tolist():
                sel = np.nonzero(shards == p)[0]
                per_shard[int(p)] = (sel, keys[sel], ts[sel])
            probed = self._probe_banded(store_idx, per_shard,
                                        self._band_for(side_idx))
            probe_cols = {n: np.asarray(batch[n])
                          for n in batch.names()
                          if n not in (KEY_ID_FIELD,
                                       TIMESTAMP_FIELD)}
            m = self._assemble(side_idx, probe_cols, ts, keys, probed,
                               out_ts=np.maximum)
            if m is not None and len(m):
                out.append(m)
        # insert AFTER the probe: a pair is emitted by whichever side
        # arrives second (never joins its own batch)
        self._ingest(side_idx, keys, ts, values, shards=shards)
        return out

    def _on_watermark_inner(self, watermark: int) -> List[RecordBatch]:
        """Prune expired rows: a left row at t is dead once the watermark
        passes ``t + upper``; a right row at t once it passes ``t -
        lower``."""
        self._wd_boundary()
        if self.sides[0] is not None:
            self.sides[0].prune(int(watermark) - self.upper)
        if self.sides[1] is not None:
            self.sides[1].prune(int(watermark) + self.lower)
        return []

    def _meta_snapshot(self) -> Dict[str, object]:
        return {"lower": self.lower, "upper": self.upper}

    def _merge_meta_units(self, units) -> Dict[str, object]:
        return {"lower": self.lower, "upper": self.upper}


class MeshTemporalJoinEngine(JoinEngineBase):
    """Event-time temporal join against the versioned right table."""

    kind = "temporal"

    def __init__(self, **kw) -> None:
        super().__init__(**kw)
        #: pending left rows (host columnar, drained per watermark:
        #: transient ordering state, not keyed state)
        self._pending: List[RecordBatch] = []
        self._emitted_wm = _NEG
        self.late_left_dropped = 0

    def _process_batch_inner(self, batch: RecordBatch,
                             input_index: int) -> List[RecordBatch]:
        self._wd_boundary()
        if int(input_index) == 0:
            late = np.asarray(batch.timestamps,
                              dtype=np.int64) <= self._emitted_wm
            if late.any():
                self.late_left_dropped += int(late.sum())
                batch = batch.filter(~late)
            if len(batch):
                self._pending.append(batch)
            return []
        side = self._ensure_side(1, batch)
        self._check_schema(side, batch, 1)
        self._ingest(1, np.asarray(batch.key_ids, dtype=np.int64),
                     np.asarray(batch.timestamps, dtype=np.int64),
                     [np.asarray(batch[n]) for n, _ in side.schema])
        return []

    @staticmethod
    def _version_band(m, pk, pt):
        """Latest version at-or-before each probe time: the width-1 band
        ``[ub(k, t) - 1]`` where the candidate's key matches."""
        hi = pair_lower_bound(m.key, m.ts, pk, pt + 1)
        pos = hi - 1
        ok = pos >= 0
        ok[ok] &= m.key[pos[ok]] == pk[ok]
        return np.maximum(pos, 0), ok.astype(np.int64)

    def _on_watermark_inner(self, watermark: int) -> List[RecordBatch]:
        self._wd_boundary()
        watermark = int(watermark)
        out: List[RecordBatch] = []
        if self._pending:
            left = (self._pending[0] if len(self._pending) == 1
                    else RecordBatch.concat(self._pending))
            ready_mask = left.timestamps <= watermark
            ready = left.filter(ready_mask)
            if len(ready) and self.sides[1] is not None \
                    and self.sides[1].num_rows():
                # sort once by (key, ts): the per-key ordered probe,
                # vectorized (the left side must know its schema even when
                # it never stores rows)
                self._ensure_side(0, ready)
                order = np.lexsort((ready.timestamps, ready.key_ids))
                ready = ready.take(order)
                keys = np.asarray(ready.key_ids, dtype=np.int64)
                ts = np.asarray(ready.timestamps, dtype=np.int64)
                shards = self._shards_of(keys)
                per_shard = {}
                for p in np.unique(shards).tolist():
                    sel = np.nonzero(shards == p)[0]
                    per_shard[int(p)] = (sel, keys[sel], ts[sel])
                # a crash/stall at the versioned lookup: the probe is
                # read-only and the pending left buffer still intact, so
                # recovery replays this watermark consistently
                chaos.fault_point("join.versioned_lookup",
                                  probes=len(ready))
                probed = self._probe_banded(1, per_shard,
                                            self._version_band)
                probe_cols = {n: np.asarray(ready[n])
                              for n in ready.names()
                              if n not in (KEY_ID_FIELD,
                                           TIMESTAMP_FIELD)}
                m = self._assemble(0, probe_cols, ts, keys, probed,
                                   out_ts=lambda lt, rt: lt)
                if m is not None and len(m):
                    out.append(m)
            elif len(ready) and self.sides[0] is None:
                self._ensure_side(0, ready)
            # buffer mutation AFTER the probe: a crash mid-probe replays
            # with the pending rows intact
            keep = ~ready_mask
            self._pending = ([left.filter(keep)] if keep.any()
                             else [])
        self._emitted_wm = max(self._emitted_wm, watermark)
        self._compact_versions(watermark)
        return out

    def _compact_versions(self, watermark: int) -> None:
        """Keep versions newer than the watermark plus each key's single
        latest at-or-before it (the cleanupState contract)."""
        side = self.sides[1]
        if side is None:
            return
        for p in range(self.P):
            m = side.meta[p]
            if not len(m):
                continue
            future = m.ts > watermark
            last_of_prefix = np.r_[
                (m.key[1:] != m.key[:-1]) | future[1:], True] & ~future
            dead = ~(future | last_of_prefix)
            if dead.any():
                side.drop_positions(p, np.nonzero(dead)[0])

    def _meta_snapshot(self) -> Dict[str, object]:
        pend = (RecordBatch.concat(self._pending)
                if self._pending else None)
        return {
            "emitted_wm": int(self._emitted_wm),
            "late_left_dropped": int(self.late_left_dropped),
            "pending": (dict(pend.columns) if pend is not None
                        else None),
        }

    def _restore_meta(self, snap: Dict[str, object]) -> None:
        self._emitted_wm = int(snap.get("emitted_wm", _NEG))
        self.late_left_dropped = int(snap.get("late_left_dropped", 0))
        pend = snap.get("pending")
        self._pending = (
            [RecordBatch({k: np.asarray(v) for k, v in pend.items()})]
            if pend else [])

    def _merge_meta_units(self, units) -> Dict[str, object]:
        pend_tabs = [u.get("pending") for u in units if u.get("pending")]
        pending = None
        if pend_tabs:
            pending = {k: np.concatenate([np.asarray(t[k])
                                          for t in pend_tabs])
                       for k in pend_tabs[0]}
        return {
            # the OLDEST unit's horizon: its range replays from its
            # position and must not be judged late
            "emitted_wm": min((int(u.get("emitted_wm", _NEG))
                               for u in units), default=_NEG),
            "late_left_dropped": max(
                (int(u.get("late_left_dropped", 0)) for u in units),
                default=0),
            "pending": pending,
        }

    def snapshot_sharded(self, mode: str = "full"):
        units = super().snapshot_sharded(mode)
        # the pending left rows split by key group like table rows: each
        # unit replays only its own range
        for (g0, g1), unit in units.items():
            pend = unit.get("pending")
            if not pend:
                continue
            kid = np.asarray(pend[KEY_ID_FIELD], dtype=np.int64)
            kg = assign_key_groups(kid, self.max_parallelism)
            mask = (kg >= g0) & (kg <= g1)
            unit["pending"] = {k: np.asarray(v)[mask]
                               for k, v in pend.items()}
        return units
