"""Device CEP engine over the key-group mesh (port of
``flink_tpu/cep/mesh_engine.py``).

Each key's live partial matches live as ONE int32 bitmask row of a
``[P, capacity]`` ``alive`` plane (the settled-state automaton —
``cep/kernels.py``), the last ``R`` event sequence numbers ride ``R``
ring planes (the bounded SharedBuffer of the all-consecutive pattern
class), and a watermark fire advances EVERY due key's NFA through its due
events with one :func:`~flink_tpu_torch.cep.kernels.cep_advance` call.

Per batch the device runs at most four programs — the pending ingest
(the fused keyBy exchange-put, with one launch of the exchange-rank
kernel), the NFA advance, one eviction gather under budget pressure and
the within-expiry prune. Staging rides ``stage_device_exchange`` with a
double-buffer fence (``runtime/pending.Fence``); cold keys spill as
``state/paged_spill.py`` cohorts (within-expiry applied LAZILY at reload
— exact, because a spilled key saw no events since it spilled and the
keep-test is monotone in the watermark); completed matches land in a
bounded FIFO **matched-pattern store** on its own ``[P, match_capacity]``
planes (``query_match_batch``).

``backend="host"`` wraps the host :class:`CepOperator` — the
bit-identity oracle (values AND emission order) for every pattern the
device path accepts. Patterns outside the bounded-partial class raise
:class:`UnsupportedCepPattern` at construction; callers fall back LOUDLY
(``record_host_fallback``).

Documented deviations from the oracle, none visible in emitted rows:

- Both backends drop events at-or-before the last fired watermark at
  ingest (``late_dropped``) BEFORE stage evaluation.
- ``Match.events_by_stage`` carries synthetic per-match event indices
  (0..depth-1 split by stage), not the oracle NFA's internal event-log
  ids; the resolved event ROWS handed to ``select`` are bit-identical.
- Spilled keys whose partials all expired stay in the page tier until
  their next event reloads them (the oracle deletes idle NFAs at every
  watermark).

Shard-granular units (``snapshot_sharded``, ``merge_unit_snapshots``,
``restore(key_group_filter=)``) and the device watchdog's hooks are as in
the mesh window engines; live ``reshard`` lifts every row through the
snapshot onto a rebuilt logical mesh. ``shuffle_mode="host"`` buckets
the pending rows into ``[P, B]`` blocks on the host
(``bucket_by_shard``) instead of the device exchange. The
matched-pattern read replica (``arm_match_replica``) publishes the match
store's churn at every fire: :class:`CepMatchReplicaAdapter` composes the
live ``query_match_batch`` shape, :class:`CepMatchServingAdapter` the
``{rid -> columns}`` shape the shared-memory hot cache packs. The ``cep``
metric group registers (``register_metrics``), and each ingest and fire
is a flight-recorder span; the port's profile also wraps the engine's
methods in host timers
(``benchmarks/cep.py --profile``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.cep import kernels
from flink_tpu_torch.cep.nfa import Match
from flink_tpu_torch.cep.operator import CepOperator, default_select
from flink_tpu_torch.cep.pattern import Pattern
from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.core.device import DeviceLike
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.ops.segment_ops import pad_bucket_size, sticky_bucket
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
from flink_tpu_torch.state.paged_spill import (
    PagedSpillMap,
    reload_rows_for,
    restore_into_pages,
    run_deferred_sweeps,
    spill_page,
)
from flink_tpu_torch.state.slot_table import SpillTier

_log = logging.getLogger(__name__)

_NEG = -(1 << 62)

#: job-global count of device-ineligible patterns routed to the host
#: operator (the reference's ``cep.host_fallbacks`` metric)
HOST_FALLBACKS = 0


def record_host_fallback(reason: str) -> None:
    """Count + log one device-path rejection: ``MeshCepOperator`` calls
    this when ``UnsupportedCepPattern`` sends a pattern to the host
    ``CepOperator`` — the fallback is correct but never silent."""
    global HOST_FALLBACKS
    HOST_FALLBACKS += 1
    _log.warning(
        "cep device engine: pattern outside the bounded-partial device "
        "class, falling back to the host CepOperator: %s", reason)


def host_fallbacks() -> int:
    return HOST_FALLBACKS


def _item(v):
    return v.item() if hasattr(v, "item") else v


class _CepShard:
    """One shard's host bookkeeping: the slot directory over the state
    planes, the host halves of the ring (int64 timestamps + event value
    columns never ride the device), the pending-event mirror, the paged
    spill tier and the match-store mirror."""

    def __init__(self, capacity: int, ring: int, match_capacity: int,
                 spill_dir: Optional[str],
                 spill_host_max_bytes: int) -> None:
        C, R, M = capacity, ring, match_capacity
        self.slot_of: Dict[int, int] = {}
        # slot 0 reserved: padded staging lanes scatter there
        self.free: List[int] = list(range(C - 1, 0, -1))
        self.key_of = np.zeros(C, dtype=np.int64)
        self.alive = np.zeros(C, dtype=np.int32)
        self.ring_seq = np.zeros((C, R), dtype=np.int32)
        self.ts_hist = np.full((C, R), _NEG, dtype=np.int64)
        #: {col -> [C, R]} value ring, bound at the first batch
        self.ring_vals: Optional[Dict[str, np.ndarray]] = None
        self.touch = np.zeros(C, dtype=np.int64)
        self.spill = SpillTier(spill_dir, spill_host_max_bytes)
        self.pmap = PagedSpillMap()
        # pending mirror, append (arrival) order — the order the oracle
        # ties equal-timestamp due events by
        self.p_pos = np.zeros(0, dtype=np.int32)
        self.p_key = np.zeros(0, dtype=np.int64)
        self.p_ts = np.zeros(0, dtype=np.int64)
        self.p_seq = np.zeros(0, dtype=np.int32)
        self.p_hits = np.zeros(0, dtype=np.int32)
        self.p_vals: Optional[Dict[str, np.ndarray]] = None
        self.cursor = 1  # device pending row 0 reserved (padding sink)
        # matched-pattern store mirror (FIFO over slots 1..M-1)
        self.m_used = np.zeros(M, dtype=bool)
        self.m_key = np.zeros(M, dtype=np.int64)
        self.m_rid = np.zeros(M, dtype=np.int64)
        self.m_start = np.zeros(M, dtype=np.int64)
        self.m_end = np.zeros(M, dtype=np.int64)
        self.m_depth = np.zeros(M, dtype=np.int32)
        self.m_fseq = np.zeros(M, dtype=np.int32)
        self.m_lseq = np.zeros(M, dtype=np.int32)
        self.m_count = 0

    def bind_schema(self, schema, capacity: int, ring: int) -> None:
        if self.ring_vals is not None:
            return
        self.ring_vals = {n: np.zeros((capacity, ring), dtype=dt)
                          for n, dt in schema}
        self.p_vals = {n: np.zeros(0, dtype=dt) for n, dt in schema}


class MeshCepEngine(WatchdogHooks):
    """Keyed CEP over device-resident NFA state planes.

    ``backend="device"`` requires the pattern to compile to a
    :class:`~flink_tpu_torch.cep.kernels.DevicePatternLayout` (raises
    :class:`~flink_tpu_torch.cep.kernels.UnsupportedCepPattern`
    otherwise) and runs on ``mesh`` (default: ``num_shards`` logical
    shards on ``device``, the card unless the caller asks for the CPU);
    ``backend="host"`` wraps the host operator behind the same
    interface."""

    def __init__(self, pattern: Pattern,
                 key_field: Optional[str] = None,
                 select: Optional[Callable] = None,
                 mesh: Optional[LogicalMesh] = None, num_shards: int = 1,
                 capacity_per_shard: int = 1 << 16,
                 max_parallelism: int = 128,
                 match_capacity: int = 1 << 10,
                 spill_dir: Optional[str] = None,
                 spill_host_max_bytes: int = 0,
                 key_group_range: Optional[Tuple[int, int]] = None,
                 backend: str = "device",
                 shuffle_mode: str = "device",
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
        self.pattern = pattern.validate()
        self.key_field = key_field
        self.select = select or default_select
        self.mesh: Optional[LogicalMesh] = None
        self.device = torch.device("cpu")
        if backend == "device":
            # raises UnsupportedCepPattern for the ineligible class —
            # the caller's cue to fall back (loudly) to the host path
            self._layout = kernels.compile_device_pattern(self.pattern)
            if mesh is None:
                mesh = make_mesh(num_shards, device)
            self.mesh = mesh
            self.P = int(mesh.size)
            self.device = mesh.device
        else:
            self._layout = None
            self.P = int(num_shards)
            self._op = CepOperator(self.pattern, key_field,
                                   select=select)
        self.capacity = max(int(capacity_per_shard), 256)
        self.match_capacity = max(int(match_capacity), 2)
        self.max_parallelism = int(max_parallelism)
        if self.max_parallelism < self.P:
            raise ValueError(
                f"max_parallelism {max_parallelism} < shard count "
                f"{self.P}")
        self.key_group_range = key_group_range
        self.spill_dir = spill_dir
        self.spill_host_max_bytes = int(spill_host_max_bytes or 0)
        self._last_wm: Optional[int] = None
        # counters (the reference's cep metric group reads these)
        self.matches_emitted = 0
        self.partials_pruned_within = 0
        self.late_dropped = 0
        if backend == "device":
            self._init_device_state()

    # ----------------------------------------------------- device plumbing

    def _new_shards(self) -> List[_CepShard]:
        return [
            _CepShard(self.capacity, self._layout.ring, self.match_capacity,
                      (f"{self.spill_dir.rstrip('/')}/shard-{p}"
                       if self.spill_dir else None),
                      self.spill_host_max_bytes // max(self.P, 1))
            for p in range(self.P)]

    def _zeros(self, width: int, n: int) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.zeros((self.P, width), dtype=torch.int32,
                                 device=self.device) for _ in range(n))

    def _init_device_state(self) -> None:
        self._pool = ShuffleBufferPool(generations=2)
        self._fences: List[Fence] = []
        R = self._layout.ring
        self._tables = kernels.AdvanceTables.build(self._layout,
                                                   self.device)
        self._st = self._new_shards()
        self._planes = self._zeros(self.capacity, 1 + R)
        self._pend_width = pad_bucket_size(1, minimum=1024)
        self._pend = self._zeros(self._pend_width, 2)
        self._match_planes = self._zeros(self.match_capacity, 3)
        # the matched-pattern read replica (arm_match_replica): the slots
        # stored and the rows overwritten since the last publish
        self._match_replica = None
        self._rep_full = False
        self._rep_up: List[set] = [set() for _ in range(self.P)]
        self._rep_freed: List[list] = [[] for _ in range(self.P)]
        self._schema: Optional[List[Tuple[str, np.dtype]]] = None
        self._next_seq = 1
        self._next_rid = 1
        self._clock = 1
        self._key_order: Dict[int, int] = {}
        self._order_seq = 0
        self._key_values: Dict[int, Any] = {}
        # sticky power-of-two staging shapes
        self._lane_bucket = 0
        self._ev_bucket = 0
        self._gather_bucket = 0
        self._prune_bucket = 0
        self._put_bucket = 0
        self._match_put_bucket = 0
        # per-depth keep bits for the within prune, static per layout
        lay = self._layout
        self._depth_mask = [0] * (R + 2)
        for q, d in enumerate(lay.depth):
            self._depth_mask[d] |= (1 << q)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        # an async copy from PAGEABLE host memory has staged `host` when
        # it returns, so a pooled buffer may be rewritten afterwards
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

    def register_metrics(self, group) -> None:
        """The engine's counters as gauges under ``<scope>.cep``."""
        g = group.add_group("cep")
        g.gauge("matches_emitted",
                lambda: int(self.matches_emitted))
        g.gauge("live_partials", self._live_partials)
        g.gauge("partials_pruned_within",
                lambda: int(self.partials_pruned_within))
        g.gauge("late_dropped", lambda: int(self.late_dropped))
        g.gauge("host_fallbacks", lambda: int(HOST_FALLBACKS))

    def _live_partials(self) -> int:
        if self.backend == "host":
            return sum(len(n.partials) for n in self._op._nfas.values())
        Q = self._layout.n_states
        total = 0
        for sh in self._st:
            if not sh.slot_of:
                continue
            slots = np.fromiter(sh.slot_of.values(), dtype=np.int64,
                                count=len(sh.slot_of))
            total += int(self._popcount(sh.alive[slots], Q).sum())
        return total

    # ------------------------------------------------------------- reshard

    def reshard(self, new_shards: int, devices=None) -> Dict[str, object]:
        """LIVE key-group migration to ``new_shards`` logical shards: every
        logical row (resident, paged, pending and retained matches) lifts
        through the snapshot, the mesh rebuilds, and the rows land on
        their new owners through the restore path; the counters survive
        and the watchdog rebinds. ``devices``: only None (the logical
        shards of one card have no device list)."""
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
        if self.backend == "host":
            self.P = new_shards
            chaos.fault_point("rescale.handoff", stage="commit",
                              shards=new_shards)
            return {"shards": self.P, "rows_moved": 0,
                    "seconds": time.perf_counter() - t0}
        snap = self.snapshot()
        rows_moved = sum(len(np.asarray(snap[t]["key_id"]))
                         for t in ("state", "pending", "matches"))
        self.mesh = LogicalMesh(new_shards, self.device)
        self.P = new_shards
        if self.max_parallelism < self.P:
            raise ValueError(
                f"cannot reshard to {new_shards}: max_parallelism "
                f"{self.max_parallelism}")
        chaos.fault_point("rescale.handoff", stage="commit",
                          shards=new_shards)
        self._pool = ShuffleBufferPool(generations=2)
        self.restore(snap)
        if self._watchdog is not None:
            self._watchdog.rebind(self.P, self._shard_ids())
        return {"shards": self.P, "rows_moved": rows_moved,
                "seconds": time.perf_counter() - t0}

    # --------------------------------------------------------------- ingest

    def _bind_schema(self, batch: RecordBatch) -> None:
        names = list(batch.names())
        if self._schema is None:
            self._schema = [(n, np.asarray(batch[n]).dtype)
                            for n in names]
            for sh in self._st:
                sh.bind_schema(self._schema, self.capacity,
                               self._layout.ring)
            return
        declared = [n for n, _ in self._schema]
        if names != declared:
            raise RuntimeError(
                f"cep input changed columns mid-stream: "
                f"{declared} -> {names}")

    @staticmethod
    def _popcount(x: np.ndarray, bits: int) -> np.ndarray:
        x = np.asarray(x)
        c = np.zeros(x.shape, dtype=np.int64)
        for q in range(bits):
            c += (x >> q) & 1
        return c

    #: the flight recorder's per-engine batch sequence
    _flight_batch = 0

    def process_batch(self, batch: RecordBatch, input_index: int = 0
                      ) -> List[RecordBatch]:
        if len(batch) == 0:
            return []
        self._flight_batch += 1
        with flight.ingest_span(self._flight_batch):
            return self._process_batch_inner(batch)

    def _process_batch_inner(self, batch: RecordBatch) -> List[RecordBatch]:
        # late-drop policy (both backends, BEFORE stage evaluation):
        # events at-or-before the last fired watermark are dropped — the
        # oracle has already advanced past them
        if self._last_wm is not None:
            late = batch.timestamps <= self._last_wm
            if late.any():
                self.late_dropped += int(late.sum())
                batch = batch.filter(~late)
                if len(batch) == 0:
                    return []
        if self.backend == "host":
            return self._op.process_batch(batch)
        self._ingest_device(batch)
        return []

    def _ingest_device(self, batch: RecordBatch) -> None:
        self._bind_schema(batch)
        n = len(batch)
        kids = np.asarray(batch.key_ids, dtype=np.int64)
        tss = np.asarray(batch.timestamps, dtype=np.int64)
        # stage predicates columnar over the whole batch, packed to one
        # int32 hit bitmask per event (eligibility caps stages at 31)
        hits = np.zeros(n, dtype=np.int32)
        for s, st in enumerate(self.pattern.stages):
            m = np.asarray(st.evaluate(batch), dtype=bool)
            hits |= np.where(m, np.int32(1 << s), np.int32(0))
        if self._next_seq + n >= (1 << 31):
            raise RuntimeError(
                "cep event sequence space exhausted (int32 ring)")
        seqs = np.arange(self._next_seq, self._next_seq + n,
                         dtype=np.int32)
        self._next_seq += n
        # the oracle's bookkeeping, mirrored exactly: first-seen key
        # value, pending-dict insertion order
        if self.key_field in batch.columns:
            col = batch[self.key_field]
            kv = self._key_values
            for i, k in enumerate(kids.tolist()):
                if k not in kv:
                    kv[k] = _item(col[i])
        ko = self._key_order
        for k in kids.tolist():
            if k not in ko:
                ko[k] = self._order_seq
                self._order_seq += 1
        shards = shard_records(kids, self.P, self.max_parallelism,
                               self.key_group_range)
        counts = np.bincount(shards, minlength=self.P)
        # pending-plane headroom: compact consumed rows (and grow) when
        # any shard's cursor would run off the plane
        if any(self._st[p].cursor + int(counts[p]) > self._pend_width
               for p in range(self.P)):
            self._compact_pending(counts)
        # per-record device pending position: destination cursor + rank
        # within the batch's records for that destination
        order = np.argsort(shards, kind="stable")
        offsets = np.zeros(self.P + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n, dtype=np.int64) \
            - offsets[shards[order]]
        cursors = np.fromiter((sh.cursor for sh in self._st),
                              dtype=np.int64, count=self.P)
        pos = (cursors[shards] + rank).astype(np.int32)
        for p in np.nonzero(counts)[0].tolist():
            sh = self._st[p]
            sel = shards == p
            sh.cursor += int(counts[p])
            sh.p_pos = np.concatenate([sh.p_pos, pos[sel]])
            sh.p_key = np.concatenate([sh.p_key, kids[sel]])
            sh.p_ts = np.concatenate([sh.p_ts, tss[sel]])
            sh.p_seq = np.concatenate([sh.p_seq, seqs[sel]])
            sh.p_hits = np.concatenate([sh.p_hits, hits[sel]])
            for name, _dt in self._schema:
                col = np.asarray(batch[name])
                sh.p_vals[name] = np.concatenate(
                    [sh.p_vals[name], col[sel]])
        # dispatch: the fused keyBy exchange — hits/seq are the only
        # device columns. Payload chaos (drop/duplicate) fires inside the
        # staging helper; a dropped lane's pending row keeps hits=0, so
        # its partials die on the device while the host oracle matches —
        # the designed DIVERGENT negative control.
        self._pool.flip()
        if self.shuffle_mode == "device":
            dst, staged, width = stage_device_exchange(
                shards, self.P, columns=[pos, hits, seqs],
                fills=[0, 0, 0], pool=self._pool)
            put = [self._to_device(c) for c in (dst, *staged)]
            kernels.cep_exchange_put(self._pend, put[0], put[1], put[2:],
                                     width)
        else:
            _, blocked = bucket_by_shard(
                shards, self.P, columns=[pos, hits, seqs],
                fills=[0, 0, 0], pool=self._pool)
            put = [self._to_device(b) for b in blocked]
            kernels.cep_put(self._pend, put[0], put[1:])
        # raise/delay at the post-dispatch site: a crash lands with the
        # pending scatter already on the device queue
        chaos.fault_point("cep.advance", records=int(n))
        self._push_fence()
        for sh in self._st:
            run_deferred_sweeps(sh.spill, sh.pmap)

    def _compact_pending(self, incoming_counts: np.ndarray) -> None:
        """Dense rebuild of the device pending planes: consumed rows
        (already fired) drop, survivors repack from position 1, the
        plane grows a pow2 tier if survivors + the incoming batch still
        do not fit. One host-to-device copy each — compaction is rare
        (amortized by the pow2 growth)."""
        need = max(
            1 + len(self._st[p].p_pos) + int(incoming_counts[p])
            for p in range(self.P))
        width = max(pad_bucket_size(need, minimum=1024), 1024)
        h_hits = np.zeros((self.P, width), dtype=np.int32)
        h_seq = np.zeros((self.P, width), dtype=np.int32)
        for p, sh in enumerate(self._st):
            m = len(sh.p_pos)
            if m:
                h_hits[p, 1:m + 1] = sh.p_hits
                h_seq[p, 1:m + 1] = sh.p_seq
                sh.p_pos = np.arange(1, m + 1, dtype=np.int32)
            sh.cursor = 1 + m
        self._drain_fences()
        self._pend_width = width
        self._pend = tuple(self._to_device(a) for a in (h_hits, h_seq))

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int, input_index: int = 0
                     ) -> List[RecordBatch]:
        with flight.fire_span(watermark):
            return self._on_watermark_inner(int(watermark))

    def _on_watermark_inner(self, watermark: int) -> List[RecordBatch]:
        self._wd_boundary()
        if self.backend == "host":
            out = self._op.process_watermark(watermark)
            self.matches_emitted += sum(len(b) for b in out)
            self._note_wm(watermark)
            return out
        out = self._fire_device(watermark)
        self._note_wm(watermark)
        return out

    def _note_wm(self, watermark: int) -> None:
        self._last_wm = (watermark if self._last_wm is None
                         else max(self._last_wm, watermark))

    def _fire_device(self, wm: int) -> List[RecordBatch]:
        lay = self._layout
        R, Q = lay.ring, lay.n_states
        lanes: Dict[int, dict] = {}
        e_max = k_max = 0
        for p, sh in enumerate(self._st):
            if not len(sh.p_ts):
                continue
            due = sh.p_ts <= wm
            if not due.any():
                continue
            mrow = np.nonzero(due)[0]
            d_key = sh.p_key[mrow]
            d_ts = sh.p_ts[mrow]
            ukeys, inv = np.unique(d_key, return_inverse=True)
            # the oracle's per-key order: due events sorted stably by
            # timestamp, ties in arrival (mirror append) order
            ev = np.lexsort((d_ts, inv))
            cnts = np.bincount(inv, minlength=len(ukeys))
            lanes[p] = {"keys": ukeys, "inv": inv, "ev": ev,
                        "cnts": cnts, "mrow": mrow, "due": due}
            e_max = max(e_max, int(cnts.max()))
            k_max = max(k_max, len(ukeys))
        out_rows: List[dict] = []
        out_ts: List[int] = []
        freed_keys: List[Tuple[int, int]] = []
        if lanes:
            self._resolve_slots(lanes)
            K = sticky_bucket(k_max, self._lane_bucket, minimum=64)
            self._lane_bucket = K
            E = sticky_bucket(e_max, self._ev_bucket, minimum=16)
            self._ev_bucket = E
            slots_b = np.zeros((self.P, K), dtype=np.int32)
            nev_b = np.zeros((self.P, K), dtype=np.int32)
            idx_b = np.zeros((self.P, K, E), dtype=np.int32)
            wok_b = np.zeros((self.P, K, E), dtype=np.int32)
            for p, d in lanes.items():
                sh = self._st[p]
                L = len(d["keys"])
                ev, inv, cnts, mrow = (d["ev"], d["inv"], d["cnts"],
                                       d["mrow"])
                starts = np.concatenate(
                    ([0], np.cumsum(cnts)[:-1])).astype(np.int64)
                flat_lane = inv[ev]
                col = np.arange(len(ev), dtype=np.int64) \
                    - starts[flat_lane]
                mrow_m = np.zeros((L, E), dtype=np.int64)
                mrow_m[flat_lane, col] = mrow[ev]
                due_ts_m = np.zeros((L, E), dtype=np.int64)
                due_ts_m[flat_lane, col] = sh.p_ts[mrow][ev]
                due_seq_m = np.zeros((L, E), dtype=np.int32)
                due_seq_m[flat_lane, col] = sh.p_seq[mrow][ev]
                due_pos_m = np.zeros((L, E), dtype=np.int32)
                due_pos_m[flat_lane, col] = sh.p_pos[mrow][ev]
                lane_slots = d["slots"]
                c_ts = np.concatenate(
                    [sh.ts_hist[lane_slots], due_ts_m], axis=1)
                c_seq = np.concatenate(
                    [sh.ring_seq[lane_slots], due_seq_m], axis=1)
                d.update(mrow_m=mrow_m, due_ts_m=due_ts_m,
                         due_seq_m=due_seq_m, c_ts=c_ts, c_seq=c_seq)
                slots_b[p, :L] = lane_slots
                nev_b[p, :L] = cnts
                idx_b[p, :L] = due_pos_m
                if lay.has_within:
                    within = int(self.pattern.within_ms)
                    wok = np.zeros((L, E), dtype=np.int32)
                    for dd in range(1, R + 1):
                        # rearranged (first_ts >= ts - within) so the
                        # _NEG history fill can't overflow int64
                        ok = c_ts[:, R - dd:R - dd + E] \
                            >= (due_ts_m - within)
                        wok |= np.where(ok, np.int32(1 << (dd - 1)),
                                        np.int32(0))
                    wok_b[p, :L] = wok
            dev = [self._to_device(a)
                   for a in (slots_b, idx_b, wok_b, nev_b)]
            matches_d, alive_d = kernels.cep_advance(
                self._planes, self._pend, dev[0], dev[1], dev[2], dev[3],
                self._tables, steps=e_max)
            host_m, host_alive = self._harvest_get([matches_d, alive_d],
                                                   "cep_fire_harvest")
            # decode in the oracle's GLOBAL emission order: keys in
            # pending-dict insertion order, each key's due matches
            # grouped, event order within key
            korder = sorted(
                (self._key_order[int(k)], p, l, int(k))
                for p, d in lanes.items()
                for l, k in enumerate(d["keys"].tolist()))
            store_rows: Dict[int, Dict[int, Tuple[int, int, int]]] = {}
            for _, p, l, k in korder:
                self._decode_lane(p, l, k, lanes[p], host_m[p], out_rows,
                                  out_ts, store_rows)
            if store_rows:
                self._put_matches(store_rows)
            # mirror roll-forward: the new ring is the last R of
            # (old ring ++ due events) — positions nev..nev+R-1 of the
            # concat, all real by construction
            for p, d in lanes.items():
                sh = self._st[p]
                lane_slots = d["slots"]
                L = len(lane_slots)
                a_new = host_alive[p][:L].astype(np.int32)
                sh.alive[lane_slots] = a_new
                if R:
                    take = (d["cnts"][:, None]
                            + np.arange(R, dtype=np.int64)[None, :])
                    sh.ring_seq[lane_slots] = np.take_along_axis(
                        d["c_seq"], take, axis=1)
                    sh.ts_hist[lane_slots] = np.take_along_axis(
                        d["c_ts"], take, axis=1)
                    for name, _dt in self._schema:
                        due_val = sh.p_vals[name][d["mrow_m"]]
                        c_val = np.concatenate(
                            [sh.ring_vals[name][lane_slots], due_val],
                            axis=1)
                        sh.ring_vals[name][lane_slots] = \
                            np.take_along_axis(c_val, take, axis=1)
                dead = lane_slots[a_new == 0]
                for s in dead.tolist():
                    k = int(sh.key_of[s])
                    del sh.slot_of[k]
                    sh.free.append(s)
                    freed_keys.append((k, p))
        chaos.fault_point("cep.match_fire", matches=len(out_rows))
        if lay.has_within:
            freed_keys.extend(self._prune_resident(wm, Q))
        # consume the fired pending rows; keys whose buffer emptied
        # leave the insertion-order dict (re-appearing keys re-enter
        # at the END, as the oracle's dict does)
        emptied: List[Tuple[int, int]] = []
        for p, d in lanes.items():
            sh = self._st[p]
            keep = ~d["due"]
            sh.p_pos = sh.p_pos[keep]
            sh.p_key = sh.p_key[keep]
            sh.p_ts = sh.p_ts[keep]
            sh.p_seq = sh.p_seq[keep]
            sh.p_hits = sh.p_hits[keep]
            for name, _dt in self._schema:
                sh.p_vals[name] = sh.p_vals[name][keep]
            still = np.isin(d["keys"], sh.p_key)
            for k in d["keys"][~still].tolist():
                self._key_order.pop(int(k), None)
                emptied.append((int(k), p))
        for k, p in freed_keys + emptied:
            if k in self._key_order or k in self._st[p].slot_of:
                continue
            self._key_values.pop(k, None)
        self.matches_emitted += len(out_rows)
        if self._match_replica is not None:
            self._publish_matches(wm)
        if not out_rows:
            return []
        return [RecordBatch.from_rows(out_rows).with_timestamps(out_ts)]

    # ------------------------------------------------- fire: slot residency

    def _resolve_slots(self, lanes: Dict[int, dict]) -> None:
        """Give every due key a device slot: reuse resident ones, evict
        the coldest non-due residents when headroom runs out (one cohort
        gather + one page per shard), reload spilled keys (lazy
        within-prune applied), zero-init brand-new ones — reloads and
        news share ONE put."""
        R = self._layout.ring
        evict: Dict[int, np.ndarray] = {}
        for p, d in lanes.items():
            sh = self._st[p]
            have = np.fromiter(
                (sh.slot_of.get(int(k), -1) for k in d["keys"]),
                dtype=np.int64, count=len(d["keys"]))
            missing = d["keys"][have < 0]
            need = len(missing) - len(sh.free)
            if need > 0:
                res_keys = np.fromiter(sh.slot_of.keys(),
                                       dtype=np.int64,
                                       count=len(sh.slot_of))
                res_slots = np.fromiter(sh.slot_of.values(),
                                        dtype=np.int64,
                                        count=len(sh.slot_of))
                cand = ~np.isin(res_keys, d["keys"])
                if int(cand.sum()) < need:
                    raise RuntimeError(
                        f"cep shard {p}: {len(d['keys'])} due keys "
                        f"exceed capacity {self.capacity}")
                cs = res_slots[cand]
                cold = np.lexsort((cs, sh.touch[cs]))[:need]
                evict[p] = cs[cold]
            d["have"] = have
            d["missing"] = missing
        if evict:
            self._evict_cohorts(evict)
        put_rows: Dict[int, list] = {}
        for p, d in lanes.items():
            sh = self._st[p]
            missing = d["missing"]
            reloaded: Dict[int, Tuple] = {}
            if len(missing):
                leaf_dtypes = ([np.int32, np.int32, np.int64]
                               + [dt for _n, dt in (self._schema or [])])
                r = reload_rows_for(sh.spill, sh.pmap,
                                    missing, leaf_dtypes)
                if r is not None:
                    r_keys, _rns, _dirty, vals = r
                    alive_r = np.asarray(vals[0], dtype=np.int32)
                    # lazy within-expiry: exact, because the spilled key
                    # saw no events since it spilled and the keep-test is
                    # monotone in the watermark
                    if (self._layout.has_within
                            and self._last_wm is not None
                            and len(alive_r)):
                        keep = self._keep_bits(
                            np.asarray(vals[2]), self._last_wm)
                        na = alive_r & keep
                        self.partials_pruned_within += int(
                            (self._popcount(alive_r,
                                            self._layout.n_states)
                             - self._popcount(
                                 na, self._layout.n_states)).sum())
                        alive_r = na
                    for j, rk in enumerate(r_keys.tolist()):
                        reloaded[int(rk)] = (
                            alive_r[j],
                            np.asarray(vals[1])[j],
                            np.asarray(vals[2])[j],
                            [np.asarray(v)[j] for v in vals[3:]])
            rows = put_rows.setdefault(p, [])
            for j, k in enumerate(d["keys"].tolist()):
                k = int(k)
                if d["have"][j] >= 0:
                    continue
                s = sh.free.pop()
                sh.slot_of[k] = s
                sh.key_of[s] = k
                got = reloaded.get(k)
                if got is not None:
                    alive_v, ring_v, ts_v, col_v = got
                    sh.alive[s] = alive_v
                    if R:
                        sh.ring_seq[s] = ring_v
                        sh.ts_hist[s] = ts_v
                        for (name, _dt), cv in zip(self._schema,
                                                   col_v):
                            sh.ring_vals[name][s] = cv
                else:
                    sh.alive[s] = 0
                    if R:
                        sh.ring_seq[s] = 0
                        sh.ts_hist[s] = _NEG
                        for name, dt in self._schema:
                            sh.ring_vals[name][s] = np.zeros(R, dtype=dt)
                d["have"][j] = s
                rows.append((s, int(sh.alive[s]),
                             sh.ring_seq[s].copy() if R else None))
            d["slots"] = d["have"].astype(np.int64)
            sh.touch[d["slots"]] = self._clock
            self._clock += 1
        self._put_state_rows(put_rows)

    def _put_state_rows(self, put_rows: Dict[int, list]) -> None:
        """Write ``(slot, alive, ring)`` rows per shard into the state
        planes: one ``[P, B]`` put."""
        rows_max = max((len(r) for r in put_rows.values()), default=0)
        if not rows_max:
            return
        R = self._layout.ring
        B = sticky_bucket(rows_max, self._put_bucket)
        self._put_bucket = B
        slot_b = np.zeros((self.P, B), dtype=np.int32)
        alive_b = np.zeros((self.P, B), dtype=np.int32)
        ring_bs = [np.zeros((self.P, B), dtype=np.int32)
                   for _ in range(R)]
        for p, rows in put_rows.items():
            for j, (s, av, rv) in enumerate(rows):
                slot_b[p, j] = s
                alive_b[p, j] = av
                for r in range(R):
                    ring_bs[r][p, j] = rv[r]
        put = [self._to_device(a) for a in (slot_b, alive_b, *ring_bs)]
        kernels.cep_put(self._planes, put[0], put[1:])

    def _evict_cohorts(self, evict: Dict[int, np.ndarray]) -> None:
        """Spill the chosen cold residents: ONE gather + ONE device-to-host
        copy for every shard's cohort, then one page per shard."""
        R = self._layout.ring
        g_max = max(len(s) for s in evict.values())
        G = sticky_bucket(g_max, self._gather_bucket)
        self._gather_bucket = G
        block = np.zeros((self.P, G), dtype=np.int32)
        for p, slots in evict.items():
            block[p, :len(slots)] = slots
        host = self._harvest_get(kernels.cep_gather(
            self._planes, self._to_device(block)), "evict_harvest")
        for p, slots in evict.items():
            sh = self._st[p]
            m = len(slots)
            ring_rows = (np.stack([host[1 + r][p, :m]
                                   for r in range(R)], axis=1)
                         if R else np.zeros((m, 0), dtype=np.int32))
            keys = sh.key_of[slots]
            entry = {"key_id": keys.copy(), "ns": keys.copy(),
                     "dirty": np.ones(m, dtype=bool),
                     "leaf_0": host[0][p, :m].astype(np.int32),
                     "leaf_1": ring_rows,
                     "leaf_2": sh.ts_hist[slots].copy()}
            for i, (name, _dt) in enumerate(self._schema or []):
                entry[f"leaf_{3 + i}"] = sh.ring_vals[name][slots].copy()
            spill_page(sh.spill, sh.pmap, entry)
            for s in slots.tolist():
                del sh.slot_of[int(sh.key_of[s])]
                sh.free.append(int(s))

    # ------------------------------------------------------ fire: decoding

    def _decode_lane(self, p: int, l: int, k: int, d: dict,
                     m_shard: np.ndarray, out_rows: list,
                     out_ts: list, store_rows: dict) -> None:
        lay = self._layout
        R, Q = lay.ring, lay.n_states
        sh = self._st[p]
        n_ev = int(d["cnts"][l])
        mrow = d["mrow_m"][l]
        slot = int(d["slots"][l])
        names = [n for n, _ in self._schema]
        stages = self.pattern.stages
        for j in range(n_ev):
            m = int(m_shard[l, j])
            if not m:
                continue
            if lay.skip_past:
                bits = [(m & -m).bit_length() - 1]
            else:
                bits = [b for b in range(Q + 1) if (m >> b) & 1]
            for b in bits:
                counts_vec = lay.match_counts(b)
                depth = sum(counts_vec)
                start = R + j - depth + 1
                start_ts = int(d["c_ts"][l, start])
                end_ts = int(d["due_ts_m"][l, j])
                ev_rows = []
                for pos in range(start, R + j + 1):
                    if pos >= R:
                        mi = int(mrow[pos - R])
                        ev_rows.append(
                            {n: _item(sh.p_vals[n][mi]) for n in names})
                    else:
                        ev_rows.append(
                            {n: _item(sh.ring_vals[n][slot, pos])
                             for n in names})
                events: Dict[str, list] = {}
                by_stage: Dict[str, list] = {}
                at = 0
                for si, st in enumerate(stages):
                    c = counts_vec[si] if si < len(counts_vec) else 0
                    events[st.name] = ev_rows[at:at + c]
                    by_stage[st.name] = list(range(at, at + c))
                    at += c
                match = Match(start_ts=start_ts, end_ts=end_ts,
                              events_by_stage=by_stage)
                out_rows.append(self.select(
                    self._key_values.get(k, k), match, events))
                out_ts.append(end_ts)
                self._store_match(p, k, start_ts, end_ts, depth,
                                  int(d["c_seq"][l, start]),
                                  int(d["due_seq_m"][l, j]),
                                  store_rows)

    # ------------------------------------------------- matched-pattern store

    def _store_match(self, p: int, key: int, start_ts: int,
                     end_ts: int, depth: int, fseq: int, lseq: int,
                     store_rows: dict) -> None:
        sh = self._st[p]
        M = self.match_capacity
        slot = 1 + (sh.m_count % (M - 1))
        sh.m_count += 1
        if sh.m_used[slot] and self._match_replica is not None:
            self._rep_freed[p].append(
                (int(sh.m_key[slot]), int(sh.m_rid[slot])))
        rid = self._next_rid
        self._next_rid += 1
        sh.m_used[slot] = True
        sh.m_key[slot] = key
        sh.m_rid[slot] = rid
        sh.m_start[slot] = start_ts
        sh.m_end[slot] = end_ts
        sh.m_depth[slot] = depth
        sh.m_fseq[slot] = fseq
        sh.m_lseq[slot] = lseq
        # last write per slot wins in the device block too (a FIFO can
        # wrap within one fire; a duplicate scatter index would be
        # order-undefined on the device)
        store_rows.setdefault(p, {})[slot] = (depth, fseq, lseq)
        if self._match_replica is not None:
            self._rep_up[p].add(slot)

    def _put_matches(self, store_rows: Dict[int, dict]) -> None:
        B = sticky_bucket(max(len(r) for r in store_rows.values()),
                          self._match_put_bucket)
        self._match_put_bucket = B
        slot_b = np.zeros((self.P, B), dtype=np.int32)
        val_bs = [np.zeros((self.P, B), dtype=np.int32)
                  for _ in range(3)]
        for p, rows in store_rows.items():
            for j, (s, vals) in enumerate(sorted(rows.items())):
                slot_b[p, j] = s
                for i in range(3):
                    val_bs[i][p, j] = vals[i]
        put = [self._to_device(a) for a in (slot_b, *val_bs)]
        kernels.cep_put(self._match_planes, put[0], put[1:])

    def arm_match_replica(self, serving: bool = False):
        """Arm the matched-pattern read replica: completed matches
        become queryable state on the serving path — the replica plane
        double-buffers the match planes and seals a generation per
        boundary publish. Returns a :class:`CepMatchReplicaAdapter`
        (bindable to a ServingPlane like any other adapter), or — with
        ``serving=True`` — a :class:`CepMatchServingAdapter`, whose
        composed results pack into the native shm hot cache so frontend
        processes serve match lookups without crossing to the owner."""
        if self.backend != "device":
            raise RuntimeError(
                "the matched-pattern replica rides the device match "
                "planes; the host oracle serves reads directly")
        from flink_tpu_torch.tenancy.replica import ReplicaPlane

        class _Leaf:
            def __init__(self, dtype):
                self.dtype = dtype
                self.identity = np.dtype(dtype).type(0)

        plane = ReplicaPlane(self.mesh, [_Leaf(np.int32)] * 3,
                             self.match_capacity)
        self._match_replica = plane
        self._rep_full = True
        self._rep_up = [set() for _ in range(self.P)]
        self._rep_freed = [[] for _ in range(self.P)]
        cls = CepMatchServingAdapter if serving else \
            CepMatchReplicaAdapter
        return cls(plane)

    def _publish_matches(self, watermark: int) -> None:
        rep = self._match_replica
        with flight.span("serving.replica_publish",
                         watermark=int(watermark)):
            if rep.needs_rebuild(self.P, self.match_capacity):
                rep.rebuild(self.mesh, self.match_capacity)
                self._rep_full = True
            per_shard = {}
            for p, sh in enumerate(self._st):
                if self._rep_full:
                    up = np.nonzero(sh.m_used)[0].astype(np.int32)
                else:
                    up = np.asarray(sorted(self._rep_up[p]),
                                    dtype=np.int32)
                extra = ([(int(sh.m_start[s]), int(sh.m_end[s]))
                          for s in up.tolist()]
                         if len(up) else None)
                freed = list(self._rep_freed[p])
                per_shard[p] = {
                    "resident": (sh.m_used, sh.m_key, sh.m_rid),
                    "up_slots": up,
                    "up_keys": sh.m_key[up].copy(),
                    "up_ns": sh.m_rid[up].copy(),
                    "up_extra": extra,
                    "cold": [],
                    "freed": freed,
                    "fresh": bool(len(up) or freed),
                }
            rep.publish(self._match_planes, per_shard, int(watermark))
            self._rep_full = False
            self._rep_up = [set() for _ in range(self.P)]
            self._rep_freed = [[] for _ in range(self.P)]

    def query_match_batch(self, key_ids) -> List[List[dict]]:
        """LIVE point lookup against the match store: per requested key,
        its retained matches as ``[{"rid", "start_ts", "end_ts", "depth",
        "first_seq", "last_seq"}, ...]`` sorted by (end_ts, rid) — the
        device columns through ONE gather + ONE device-to-host copy."""
        if self.backend != "device":
            raise RuntimeError(
                "the match store rides the device match planes; the host "
                "backend keeps none")
        key_ids = np.asarray(key_ids, dtype=np.int64)
        n = len(key_ids)
        results: List[List[dict]] = [[] for _ in range(n)]
        want: Dict[int, List[Tuple[int, int]]] = {}
        rows: List[Tuple[int, int]] = []
        per_shard: Dict[int, List[int]] = {}
        for p, sh in enumerate(self._st):
            if not sh.m_used.any():
                continue
            hit = sh.m_used & np.isin(sh.m_key, key_ids)
            for s in np.nonzero(hit)[0].tolist():
                per_shard.setdefault(p, []).append(s)
                want.setdefault(int(sh.m_key[s]), []).append(
                    (len(rows), s))
                rows.append((p, s))
        if not rows:
            return results
        G = sticky_bucket(max(len(v) for v in per_shard.values()),
                          self._match_put_bucket)
        self._match_put_bucket = G
        block = np.zeros((self.P, G), dtype=np.int32)
        at: Dict[Tuple[int, int], int] = {}
        for p, slots in per_shard.items():
            for j, s in enumerate(slots):
                block[p, j] = s
                at[(p, s)] = j
        vals = self._harvest_get(
            kernels.cep_gather(self._match_planes, self._to_device(block)),
            "match_query_harvest")
        for qi, kid in enumerate(key_ids.tolist()):
            got = []
            for ri, s in want.get(int(kid), ()):
                p, _s = rows[ri]
                sh = self._st[p]
                j = at[(p, s)]
                got.append({
                    "rid": int(sh.m_rid[s]),
                    "start_ts": int(sh.m_start[s]),
                    "end_ts": int(sh.m_end[s]),
                    "depth": int(vals[0][p, j]),
                    "first_seq": int(vals[1][p, j]),
                    "last_seq": int(vals[2][p, j]),
                })
            got.sort(key=lambda r: (r["end_ts"], r["rid"]))
            results[qi] = got
        return results

    # ------------------------------------------------------ fire: pruning

    def _keep_bits(self, ts_hist: np.ndarray, wm: int) -> np.ndarray:
        """Per-row keep bitmask for the within expiry: a partial of depth
        ``d`` (first event = ring position R-d) survives iff the
        watermark is still inside its window."""
        R = self._layout.ring
        within = int(self.pattern.within_ms)
        keep = np.zeros(len(ts_hist), dtype=np.int32)
        for d in range(1, R + 1):
            # rearranged (first_ts >= wm - within): MAX_WATERMARK minus
            # the _NEG history fill would overflow int64
            ok = ts_hist[:, R - d] >= (wm - within)
            keep |= np.where(ok, np.int32(self._depth_mask[d]),
                             np.int32(0))
        return keep

    def _prune_resident(self, wm: int, Q: int
                        ) -> List[Tuple[int, int]]:
        """The oracle prunes EVERY key at every watermark: expire
        within-window partials across all resident slots — host keep
        bits, one device scatter — and free slots that emptied. Spilled
        keys prune lazily at reload (exact — see module docstring)."""
        prune: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        freed: List[Tuple[int, int]] = []
        for p, sh in enumerate(self._st):
            if not sh.slot_of:
                continue
            slots = np.fromiter(sh.slot_of.values(), dtype=np.int64,
                                count=len(sh.slot_of))
            slots.sort()
            keep = self._keep_bits(sh.ts_hist[slots], wm)
            na = sh.alive[slots] & keep
            self.partials_pruned_within += int(
                (self._popcount(sh.alive[slots], Q)
                 - self._popcount(na, Q)).sum())
            sh.alive[slots] = na
            prune[p] = (slots, keep)
            for s in slots[na == 0].tolist():
                k = int(sh.key_of[s])
                del sh.slot_of[k]
                sh.free.append(int(s))
                freed.append((k, p))
        if prune:
            G = sticky_bucket(max(len(s) for s, _ in prune.values()),
                              self._prune_bucket)
            self._prune_bucket = G
            slot_b = np.zeros((self.P, G), dtype=np.int32)
            keep_b = np.full((self.P, G), -1, dtype=np.int32)
            for p, (slots, keep) in prune.items():
                slot_b[p, :len(slots)] = slots
                keep_b[p, :len(keep)] = keep
            kernels.cep_prune(self._planes[0], self._to_device(slot_b),
                              self._to_device(keep_b))
        return freed

    # ------------------------------------------------------------ snapshots

    def snapshot(self, mode: str = "full") -> Dict[str, object]:
        if self.backend == "host":
            return {
                "kind": "cep", "mode": "host",
                "op": self._op.snapshot_state(),
                "last_wm": self._last_wm,
                "counters": self._counters(),
            }
        self._drain_fences()
        R = self._layout.ring
        host = self._harvest_get(self._planes, "snapshot_harvest")
        schema = self._schema or []
        st_cols: Dict[str, list] = {
            "key_id": [], "alive": [], "ring_seq": [], "ts_hist": []}
        for i in range(len(schema)):
            st_cols[f"leaf_{i}"] = []
        for p, sh in enumerate(self._st):
            slots = np.fromiter(sh.slot_of.values(), dtype=np.int64,
                                count=len(sh.slot_of))
            slots.sort()
            if len(slots):
                st_cols["key_id"].append(sh.key_of[slots].copy())
                st_cols["alive"].append(
                    host[0][p][slots].astype(np.int32))
                st_cols["ring_seq"].append(
                    np.stack([host[1 + r][p][slots]
                              for r in range(R)], axis=1)
                    if R else np.zeros((len(slots), 0),
                                       dtype=np.int32))
                st_cols["ts_hist"].append(sh.ts_hist[slots].copy())
                for i, (name, _dt) in enumerate(schema):
                    st_cols[f"leaf_{i}"].append(
                        sh.ring_vals[name][slots].copy())
            # spilled cohorts, by live page rows
            for page in sorted(set(sh.pmap.sp_page[
                    ~sh.pmap.sp_dead].tolist())):
                entry = sh.spill.peek(int(page))
                if entry is None:
                    continue
                rns = np.asarray(entry["ns"], dtype=np.int64)
                live = sh.pmap.live_row_mask(int(page), rns)
                if not live.any():
                    continue
                st_cols["key_id"].append(
                    np.asarray(entry["key_id"], dtype=np.int64)[live])
                st_cols["alive"].append(
                    np.asarray(entry["leaf_0"], dtype=np.int32)[live])
                st_cols["ring_seq"].append(
                    np.asarray(entry["leaf_1"], dtype=np.int32)[live])
                st_cols["ts_hist"].append(
                    np.asarray(entry["leaf_2"], dtype=np.int64)[live])
                for i, (name, dt) in enumerate(schema):
                    st_cols[f"leaf_{i}"].append(
                        np.asarray(entry[f"leaf_{3 + i}"],
                                   dtype=dt)[live])
        state = {k: (np.concatenate(v) if v else np.zeros(
            (0, R) if k in ("ring_seq", "ts_hist") else 0,
            dtype=np.int64))
            for k, v in st_cols.items()}
        state["key_group"] = assign_key_groups(
            np.asarray(state["key_id"], dtype=np.int64),
            self.max_parallelism)
        # pending, ordered by global sequence (= arrival order)
        pend = {"key_id": [], "ts": [], "seq": [], "hits": []}
        for i in range(len(schema)):
            pend[f"leaf_{i}"] = []
        for sh in self._st:
            pend["key_id"].append(sh.p_key)
            pend["ts"].append(sh.p_ts)
            pend["seq"].append(sh.p_seq)
            pend["hits"].append(sh.p_hits)
            for i, (name, _dt) in enumerate(schema):
                pend[f"leaf_{i}"].append(
                    sh.p_vals[name] if sh.p_vals is not None
                    else np.zeros(0))
        pending = {k: (np.concatenate(v) if v else np.zeros(0))
                   for k, v in pend.items()}
        if len(pending["seq"]):
            o = np.argsort(pending["seq"], kind="stable")
            pending = {k: v[o] for k, v in pending.items()}
        pending["key_group"] = assign_key_groups(
            np.asarray(pending["key_id"], dtype=np.int64),
            self.max_parallelism)
        # matches, ordered by rid (= creation order; FIFO age)
        mt = {k: [] for k in ("key_id", "rid", "start_ts", "end_ts",
                              "depth", "first_seq", "last_seq")}
        for sh in self._st:
            used = np.nonzero(sh.m_used)[0]
            mt["key_id"].append(sh.m_key[used])
            mt["rid"].append(sh.m_rid[used])
            mt["start_ts"].append(sh.m_start[used])
            mt["end_ts"].append(sh.m_end[used])
            mt["depth"].append(sh.m_depth[used])
            mt["first_seq"].append(sh.m_fseq[used])
            mt["last_seq"].append(sh.m_lseq[used])
        matches = {k: np.concatenate(v) for k, v in mt.items()}
        if len(matches["rid"]):
            o = np.argsort(matches["rid"], kind="stable")
            matches = {k: v[o] for k, v in matches.items()}
        matches["key_group"] = assign_key_groups(
            np.asarray(matches["key_id"], dtype=np.int64),
            self.max_parallelism)
        ko_keys = np.fromiter(self._key_order.keys(), dtype=np.int64,
                              count=len(self._key_order))
        ko_vals = np.fromiter(self._key_order.values(),
                              dtype=np.int64,
                              count=len(self._key_order))
        return {
            "kind": "cep", "mode": "device",
            "layout_key": self._layout.key,
            "schema": [(n, dt.str) for n, dt in schema],
            "last_wm": self._last_wm,
            "next_seq": int(self._next_seq),
            "next_rid": int(self._next_rid),
            "order_seq": int(self._order_seq),
            "clock": int(self._clock),
            "key_order": {"key": ko_keys, "order": ko_vals},
            "key_values": dict(self._key_values),
            "counters": self._counters(),
            "spill": self.spill_counters(),
            "state": state,
            "pending": pending,
            "matches": matches,
        }

    def _counters(self) -> Dict[str, int]:
        return {"matches_emitted": int(self.matches_emitted),
                "partials_pruned_within":
                    int(self.partials_pruned_within),
                "late_dropped": int(self.late_dropped)}

    def restore(self, snap: Dict[str, object],
                key_group_filter=None) -> None:
        """Restore the state rows, pending events, match store and key
        bookkeeping, re-sharded by key group; ``key_group_filter`` keeps
        only the keys of those groups (a shard unit's range)."""
        if snap.get("mode", "device") != self.backend:
            raise RuntimeError(
                f"cep snapshot mode {snap.get('mode')!r} != engine "
                f"backend {self.backend!r}")
        self._last_wm = snap.get("last_wm")
        c = snap.get("counters") or {}
        self.matches_emitted = int(c.get("matches_emitted", 0))
        self.partials_pruned_within = int(
            c.get("partials_pruned_within", 0))
        self.late_dropped = int(c.get("late_dropped", 0))
        if self.backend == "host":
            self._op.restore_state(snap.get("op") or {})
            return
        if _norm(snap.get("layout_key")) != _norm(self._layout.key):
            raise RuntimeError(
                "cep snapshot was taken under a different compiled "
                "pattern layout — restore into a matching engine")
        R = self._layout.ring
        self._fences = []
        schema = [(n, np.dtype(d)) for n, d in snap.get("schema", [])]
        self._schema = schema or None
        self._st = self._new_shards()
        if self._schema:
            for sh in self._st:
                sh.bind_schema(self._schema, self.capacity, R)
        self._next_seq = max(int(snap.get("next_seq", 1)), 1)
        self._next_rid = max(int(snap.get("next_rid", 1)), 1)
        self._order_seq = int(snap.get("order_seq", 0))
        self._clock = max(int(snap.get("clock", 1)), 1)

        def _table(name: str) -> Dict[str, np.ndarray]:
            table = {k: np.asarray(v) for k, v in
                     (snap.get(name) or {"key_id": np.zeros(0)}).items()}
            if key_group_filter is None or not len(table["key_id"]):
                return table
            kg = np.asarray(table["key_group"], dtype=np.int64)
            keep = np.isin(kg, np.asarray(sorted(
                int(g) for g in key_group_filter)))
            return {k: v[keep] for k, v in table.items()}

        def _key_in_filter(keys: np.ndarray) -> np.ndarray:
            if key_group_filter is None:
                return np.ones(len(keys), dtype=bool)
            kg = assign_key_groups(keys, self.max_parallelism)
            return np.isin(kg, np.asarray(sorted(
                int(g) for g in key_group_filter)))

        # ---- NFA state rows in snapshot order: the first capacity-1 rows
        # per shard stay resident, the rest re-home as page cohorts
        state = _table("state")
        keys = np.asarray(state.get("key_id", ()), dtype=np.int64)
        put_rows: Dict[int, list] = {}
        if len(keys):
            shards = shard_records(keys, self.P, self.max_parallelism,
                                   self.key_group_range)
            alive = np.asarray(state["alive"], dtype=np.int32)
            ring_seq = np.asarray(state["ring_seq"], dtype=np.int32)
            ts_hist = np.asarray(state["ts_hist"], dtype=np.int64)
            leaves = [np.asarray(state[f"leaf_{i}"], dtype=dt)
                      for i, (_n, dt) in enumerate(schema)]
            for p in range(self.P):
                sel = np.nonzero(shards == p)[0]
                if not len(sel):
                    continue
                sh = self._st[p]
                n_res = min(len(sel), self.capacity - 1)
                res, cold = sel[:n_res], sel[n_res:]
                rows = put_rows.setdefault(p, [])
                for i in res.tolist():
                    s = sh.free.pop()
                    k = int(keys[i])
                    sh.slot_of[k] = s
                    sh.key_of[s] = k
                    sh.alive[s] = alive[i]
                    if R:
                        sh.ring_seq[s] = ring_seq[i]
                        sh.ts_hist[s] = ts_hist[i]
                        for (name, _dt), lv in zip(schema, leaves):
                            sh.ring_vals[name][s] = lv[i]
                    rows.append((s, int(alive[i]),
                                 ring_seq[i] if R else None))
                if len(cold):
                    restore_into_pages(
                        sh.spill, sh.pmap, keys[cold], keys[cold],
                        [alive[cold], ring_seq[cold], ts_hist[cold]]
                        + [lv[cold] for lv in leaves],
                        page_rows=max(self.capacity // 8, 256))
        self._planes = self._zeros(self.capacity, 1 + R)
        self._put_state_rows(put_rows)
        # ---- pending rows, re-appended in sequence (arrival) order
        pending = _table("pending")
        pkeys = np.asarray(pending.get("key_id", ()), dtype=np.int64)
        width = pad_bucket_size(1, minimum=1024)
        if len(pkeys):
            shards = shard_records(pkeys, self.P,
                                   self.max_parallelism,
                                   self.key_group_range)
            counts = np.bincount(shards, minlength=self.P)
            width = pad_bucket_size(int(counts.max()) + 1,
                                    minimum=1024)
        h_hits = np.zeros((self.P, width), dtype=np.int32)
        h_seq = np.zeros((self.P, width), dtype=np.int32)
        if len(pkeys):
            for p in range(self.P):
                sel = np.nonzero(shards == p)[0]
                sh = self._st[p]
                m = len(sel)
                if not m:
                    continue
                sh.p_pos = np.arange(1, m + 1, dtype=np.int32)
                sh.p_key = pkeys[sel]
                sh.p_ts = np.asarray(pending["ts"],
                                     dtype=np.int64)[sel]
                sh.p_seq = np.asarray(pending["seq"],
                                      dtype=np.int32)[sel]
                sh.p_hits = np.asarray(pending["hits"],
                                       dtype=np.int32)[sel]
                for i, (name, dt) in enumerate(schema):
                    sh.p_vals[name] = np.asarray(
                        pending[f"leaf_{i}"], dtype=dt)[sel]
                sh.cursor = 1 + m
                h_hits[p, 1:m + 1] = sh.p_hits
                h_seq[p, 1:m + 1] = sh.p_seq
        self._pend_width = width
        self._pend = tuple(self._to_device(a) for a in (h_hits, h_seq))
        # ---- match store, re-inserted in rid (FIFO age) order
        matches = _table("matches")
        mkeys = np.asarray(matches.get("key_id", ()), dtype=np.int64)
        M = self.match_capacity
        m_planes = [np.zeros((self.P, M), dtype=np.int32)
                    for _ in range(3)]
        if len(mkeys):
            shards = shard_records(mkeys, self.P,
                                   self.max_parallelism,
                                   self.key_group_range)
            for p in range(self.P):
                sel = np.nonzero(shards == p)[0]
                if not len(sel):
                    continue
                sh = self._st[p]
                sel = sel[-(M - 1):]
                m = len(sel)
                slots = np.arange(1, m + 1)
                sh.m_used[slots] = True
                sh.m_key[slots] = mkeys[sel]
                sh.m_rid[slots] = np.asarray(matches["rid"],
                                             dtype=np.int64)[sel]
                sh.m_start[slots] = np.asarray(matches["start_ts"],
                                               dtype=np.int64)[sel]
                sh.m_end[slots] = np.asarray(matches["end_ts"],
                                             dtype=np.int64)[sel]
                sh.m_depth[slots] = np.asarray(matches["depth"],
                                               dtype=np.int32)[sel]
                sh.m_fseq[slots] = np.asarray(matches["first_seq"],
                                              dtype=np.int32)[sel]
                sh.m_lseq[slots] = np.asarray(matches["last_seq"],
                                              dtype=np.int32)[sel]
                sh.m_count = m
                m_planes[0][p, slots] = sh.m_depth[slots]
                m_planes[1][p, slots] = sh.m_fseq[slots]
                m_planes[2][p, slots] = sh.m_lseq[slots]
        self._match_planes = tuple(self._to_device(a) for a in m_planes)
        # ---- oracle-order bookkeeping + scalar counters
        ko = snap.get("key_order") or {}
        ko_keys = np.asarray(ko.get("key", ()), dtype=np.int64)
        ko_vals = np.asarray(ko.get("order", ()), dtype=np.int64)
        if len(ko_keys):
            keep = _key_in_filter(ko_keys)
            pairs = sorted(zip(ko_vals[keep].tolist(),
                               ko_keys[keep].tolist()))
            self._key_order = {int(k): int(o) for o, k in pairs}
        else:
            self._key_order = {}
        kv = dict(snap.get("key_values") or {})
        if kv and key_group_filter is not None:
            kvk = np.asarray(list(kv.keys()), dtype=np.int64)
            keep = _key_in_filter(kvk)
            kv = {int(k): kv[int(k)]
                  for k, ok in zip(kvk.tolist(), keep) if ok}
        self._key_values = {int(k): v for k, v in kv.items()}
        sc = snap.get("spill") or {}
        pm = self._st[0].pmap
        for name, v in sc.items():
            if hasattr(pm, name):
                setattr(pm, name, getattr(pm, name) + int(v))
        if self._match_replica is not None:
            # restored matches bypass the store hooks: republish them all
            self._rep_full = True
            self._rep_up = [set() for _ in range(self.P)]
            self._rep_freed = [[] for _ in range(self.P)]

    # ---------------------------------------------- shard-granular units

    def shard_key_groups(self) -> List[Tuple[int, int]]:
        return shard_key_group_ranges(self.P, self.max_parallelism,
                                      self.key_group_range)

    def snapshot_sharded(self, mode: str = "full"
                         ) -> Dict[Tuple[int, int], Dict[str, object]]:
        """One independently restorable unit per shard's key-group range:
        the three tables split by ``key_group``, the order and value maps
        by the key's group, the scalars replicated. The union of the units
        is ``snapshot()``."""
        snap = self.snapshot(mode)
        units: Dict[Tuple[int, int], Dict[str, object]] = {}
        scalars = {k: v for k, v in snap.items()
                   if k not in ("state", "pending", "matches",
                                "key_order", "key_values")}
        ko = snap["key_order"]
        ko_kg = assign_key_groups(np.asarray(ko["key"], dtype=np.int64),
                                  self.max_parallelism)
        kv_keys = np.asarray(list(snap["key_values"].keys()),
                             dtype=np.int64)
        kv_kg = assign_key_groups(kv_keys, self.max_parallelism)
        for g0, g1 in self.shard_key_groups():
            unit = dict(scalars)
            for name in ("state", "pending", "matches"):
                table = snap[name]
                kg = np.asarray(table["key_group"], dtype=np.int64)
                mask = (kg >= g0) & (kg <= g1)
                unit[name] = {k: np.asarray(v)[mask]
                              for k, v in table.items()}
            m = (ko_kg >= g0) & (ko_kg <= g1)
            unit["key_order"] = {"key": np.asarray(ko["key"])[m],
                                 "order": np.asarray(ko["order"])[m]}
            mv = (kv_kg >= g0) & (kv_kg <= g1)
            unit["key_values"] = {
                int(k): snap["key_values"][int(k)]
                for k, ok in zip(kv_keys.tolist(), mv) if ok}
            units[(int(g0), int(g1))] = unit
        return units

    def merge_unit_snapshots(self, units: List[Dict[str, object]]
                             ) -> Dict[str, object]:
        """Reassemble one snapshot from shard units: tables in their
        snapshot order (state by key, pending by sequence, matches by
        rid), the key order by its order value, scalars by max."""
        if not units:
            return {"kind": "cep", "mode": "device"}
        merged: Dict[str, object] = {
            "kind": "cep", "mode": "device",
            "layout_key": units[0].get("layout_key"),
            "schema": next((u["schema"] for u in units
                            if u.get("schema")), []),
            "last_wm": max((u.get("last_wm") for u in units
                            if u.get("last_wm") is not None),
                           default=None),
            "next_seq": max(int(u.get("next_seq", 1)) for u in units),
            "next_rid": max(int(u.get("next_rid", 1)) for u in units),
            "order_seq": max(int(u.get("order_seq", 0)) for u in units),
            "clock": max(int(u.get("clock", 1)) for u in units),
        }
        # counters and spill totals are one engine's, replicated per unit:
        # the element-wise max reassembles them, never doubles
        for field in ("counters", "spill"):
            acc: Dict[str, int] = {}
            for u in units:
                for k, v in (u.get(field) or {}).items():
                    acc[k] = max(acc.get(k, 0), int(v))
            merged[field] = acc
        sort_by = {"state": "key_id", "pending": "seq", "matches": "rid"}
        for name, by in sort_by.items():
            tables = [u.get(name) for u in units]
            tables = [t for t in tables if t is not None
                      and len(np.asarray(t.get("key_id", ())))]
            if not tables:
                merged[name] = {"key_id": np.zeros(0, dtype=np.int64)}
                continue
            cols = sorted(set().union(*(set(t) for t in tables)))
            table = {k: np.concatenate([np.asarray(t[k]) for t in tables])
                     for k in cols}
            order = np.argsort(table[by], kind="stable")
            merged[name] = {k: v[order] for k, v in table.items()}
        ko_pairs = []
        kv: Dict[int, Any] = {}
        for u in units:
            ko = u.get("key_order") or {}
            ko_pairs.extend(zip(
                np.asarray(ko.get("order", ()), dtype=np.int64).tolist(),
                np.asarray(ko.get("key", ()), dtype=np.int64).tolist()))
            kv.update(u.get("key_values") or {})
        ko_pairs.sort()
        merged["key_order"] = {
            "key": np.asarray([k for _o, k in ko_pairs], dtype=np.int64),
            "order": np.asarray([o for o, _k in ko_pairs],
                                dtype=np.int64)}
        merged["key_values"] = kv
        return merged

    # ------------------------------------------------------------ counters

    def spill_counters(self) -> Dict[str, int]:
        if self.backend == "host":
            return {}
        out: Dict[str, int] = {}
        for sh in self._st:
            for k, v in sh.pmap.counters().items():
                out[k] = out.get(k, 0) + v
        return out

    def shard_resident_rows(self) -> List[int]:
        if self.backend == "host":
            return [0] * self.P
        return [len(sh.slot_of) for sh in self._st]


def _norm(x):
    if isinstance(x, (list, tuple)):
        return tuple(_norm(i) for i in x)
    return x


from flink_tpu_torch.tenancy.replica import ReplicaAdapter  # noqa: E402


class CepMatchReplicaAdapter(ReplicaAdapter):
    """Replica-plane view of the matched-pattern store: an index entry
    is ``key -> {rid -> (shard, slot, (start_ts, end_ts))}``, a key's
    result is the live ``query_match_batch`` shape — matches sorted by
    (end_ts, rid). Retained matches are immutable (the FIFO only
    inserts and overwrites-oldest), so the boundary delta is pure
    identity churn, like the join side tables."""

    def __init__(self, plane):
        super().__init__(plane, None)

    def compose(self, entries, vals, cold_entries, cold_result
                ) -> list:
        rows: List[dict] = []
        for rid, j, extra in entries:
            start, end = extra
            rows.append({
                "rid": int(rid),
                "start_ts": int(start),
                "end_ts": int(end),
                "depth": int(np.asarray(vals[j][0]).item()),
                "first_seq": int(np.asarray(vals[j][1]).item()),
                "last_seq": int(np.asarray(vals[j][2]).item()),
            })
        rows.sort(key=lambda d: (d["end_ts"], d["rid"]))
        return rows


class CepMatchServingAdapter(CepMatchReplicaAdapter):
    """The ServingPlane/frontend-tier variant: composes each key's
    matches as ``{rid -> {start_ts, end_ts, depth, first_seq,
    last_seq}}`` — the ``{int namespace -> {column -> int}}`` shape the
    native hot cache packs into its shm arenas, so FRONTEND processes
    serve match lookups straight off the shared table (the list shape
    the base adapter returns rides the owner-side overflow store, which
    frontends cannot map). :meth:`match_rows` decodes a composed result
    back to the live ``query_match_batch`` row list, bit-identically.

    The publish feed is KILL-ONLY: retained matches are immutable (the
    FIFO inserts and overwrites-oldest, never edits), so a boundary's
    delta for a key is pure identity churn — dropping the key's cached
    entry (PrimeDelta flags bit1) is both correct and complete, and the
    base class's value-column finish (which needs an aggregate the
    match store does not have) never runs."""

    def compose(self, entries, vals, cold_entries, cold_result
                ) -> dict:
        out: Dict[int, dict] = {}
        for rid, j, extra in entries:
            start, end = extra
            out[int(rid)] = {
                "start_ts": int(start),
                "end_ts": int(end),
                "depth": int(np.asarray(vals[j][0]).item()),
                "first_seq": int(np.asarray(vals[j][1]).item()),
                "last_seq": int(np.asarray(vals[j][2]).item()),
            }
        return out

    @staticmethod
    def match_rows(result) -> List[dict]:
        """Decode one composed/served result back to the live
        ``query_match_batch`` shape: rows sorted by (end_ts, rid)."""
        rows = [{"rid": int(rid),
                 "start_ts": int(cols["start_ts"]),
                 "end_ts": int(cols["end_ts"]),
                 "depth": int(cols["depth"]),
                 "first_seq": int(cols["first_seq"]),
                 "last_seq": int(cols["last_seq"])}
                for rid, cols in (result or {}).items()]
        rows.sort(key=lambda d: (d["end_ts"], d["rid"]))
        return rows

    def _on_publish(self, gen: int, per_shard: Dict[int, dict],
                    harvest, prev_index) -> None:
        cache = self._cache
        if cache is None:
            return
        from flink_tpu_torch.tenancy.hot_cache import PrimeDelta

        touched: set = set()
        for d in per_shard.values():
            touched.update(
                int(k) for k in np.asarray(d["up_keys"]).tolist())
            touched.update(int(k) for k, _ns in d["freed"])
        if not touched:
            return
        kids = np.asarray(sorted(touched), dtype=np.int64)
        zeros = np.zeros(len(kids) + 1, dtype=np.int64)
        empty = np.zeros(0, dtype=np.int64)
        cache.prime_batch(
            self._cache_job, self._cache_op, gen,
            PrimeDelta(keys=kids, uoff=zeros, u_ns=empty, u_cols=[],
                       roff=zeros, r_ns=empty,
                       flags=np.full(len(kids), 2, dtype=np.uint8)))
