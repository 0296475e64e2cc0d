"""Mesh-sharded session windows (port of
``flink_tpu/parallel/sharded_sessions.py``).

The multi-shard form of ``windowing/sessions.py``'s ``SessionWindower``:
session interval METADATA stays global on the host (the native plane of
``windowing/session_native.py``, or the Python plane of
``windowing/session_meta.py``), while accumulator STATE lives in
``[P, capacity]`` planes on the mesh's device, one row per live session.

Sessions are per key and a key is owned by one shard (the key-group
formula), so a session merge never crosses shards. Every device step works
on the whole mesh at once:

- ingest: the fused exchange+scatter of ``parallel/shuffle.py`` (the rank
  kernel, then the ordered fold for float leaves);
- merge: :func:`build_session_merge_step`, ``acc[p, dst] op= acc[p, src]``
  then ``acc[p, src] = identity`` over ``[P, M]`` blocks;
- fire: ``build_delta_fire_step`` (merge, finish and reset in one call),
  dispatched asynchronously when the caller asks;
- spill: with a per-shard budget the paged tier of
  ``MeshPagedSpillSupport`` evicts cohorts and reloads rows; fires of
  paged-out sessions read their values straight from the pages. The
  explicit ``spill_layout="namespaces"`` keeps the namespace registry and
  evicts, reloads and drops whole sessions (``MeshSpillSupport``'s
  namespace layout), reloading them before a merge or a fire;
- snapshot and restore: ``SessionWindower``'s logical format (the rows of
  every shard and page plus the interval lists), re-sharded by key group
  on restore, so mesh and single-device snapshots restore into each
  other. Merged and fired sessions leave delta tombstones.

- failure domains: ``MeshSpillSupport``'s reshard, shard loss, unit
  snapshots and watchdog hooks, with the session metadata dropped and
  merged per key group (``SessionIntervalSet.drop_key_groups`` and
  ``merge_restore``).

``memory=(manager, owner)`` reserves the planes from the job's managed
pool (``core/memory.py``, shared with the window engine).

Point queries (``query_sessions``, ``query_batch``) read the keys' live
sessions from the metadata, every resident accumulator of the batch in one
``[P, G]`` gather and one copy back, and paged-out sessions from their
shards' page tiers without a reload.

The read replica (``arm_replica``, shared with the window engine): the
scatter and merge sites mark their rows, each published row carries its
session END (``_rep_extra``), and the end of every ``on_watermark``
publishes the boundary delta.

Live rebalance (``reassign_key_groups``, shared with the window engine)
routes every site through the assignment's table; the native sweeps
that hard-code the contiguous formula (``shard_group``,
``rec_shard_max``) step aside while a table is live.

Hot-key splitting (``register_hot_key``, paged layout only): a dominant
key's records are salted (splitmix64 of the record timestamp) into
sub-keys whose partials live as ordinary (salted key, negative
namespace) rows of the same planes — the exchange, the ordered fold,
spill, checkpoints and reshard see nothing special. Merges carry the
salted sub-rows along; fires and queries fold them back on the host in
the fixed order "main row, then salts ascending".

The data plane is the window engine's (``MeshSpillSupport.
_dispatch_exchange``): the flat device exchange, its two-level form under
a multi-host ``host_topology``, or host bucketing (``shuffle_mode="host"``),
all three folding each slot's records in stream order.
"""

from __future__ import annotations

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
    fold_slots,
    pad_bucket_size,
    scatter_fold,
    sticky_bucket,
    torch_dtype,
)
from flink_tpu_torch.parallel.exchange2 import build_exchange2_steps
from flink_tpu_torch.parallel.mesh import LogicalMesh
from flink_tpu_torch.parallel.sharded_windower import (
    MeshPagedSpillSupport,
    build_delta_fire_step,
    build_mesh_steps,
)
from flink_tpu_torch.parallel.shuffle import build_exchange_scatter
from flink_tpu_torch.runtime.pending import PendingFire
from flink_tpu_torch.state.keygroups import _splitmix64
from flink_tpu_torch.state.paged_spill import (
    read_spilled_rows,
    reload_rows_for,
    sorted_match,
)
from flink_tpu_torch.state.slot_table import resolve_slot_hints
from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.session_meta import (
    MergeGroup,
    NativePlaneError,
    SessionIntervalSet,
    make_session_meta,
)
from flink_tpu_torch.windowing.windower import (
    WINDOW_END_FIELD,
    WINDOW_START_FIELD,
)

#: hot-key splitting: the most sub-keys a split key gets. Salted sub-rows
#: live in the same planes as real sessions, addressed by (salted key,
#: salted namespace) with ``ssid = -(sid * MAX_SALTS + salt + 1)``:
#: negative, so never a real session id, and unique per (sid, salt).
MAX_SALTS = 64

_SALT_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _salted_keys(key_ids: np.ndarray, salts: np.ndarray) -> np.ndarray:
    """The synthetic key id of (key, salt): splitmix64 over the XOR-folded
    pair, so every sub-key lands in its own key group."""
    x = (np.asarray(key_ids, dtype=np.int64).astype(np.uint64)
         ^ ((np.asarray(salts, dtype=np.uint64) + np.uint64(1))
            * _SALT_GOLDEN))
    return _splitmix64(x).astype(np.int64)


def _salted_ns(sids: np.ndarray, salts: np.ndarray) -> np.ndarray:
    """(sid, salt) -> its unique negative namespace (see MAX_SALTS)."""
    return -(np.asarray(sids, dtype=np.int64) * MAX_SALTS
             + np.asarray(salts, dtype=np.int64) + 1)


def build_session_merge_step(mesh: LogicalMesh, agg: AggregateFunction):
    """Shared through ``PROGRAM_CACHE`` (kind ``session-merge``) per
    (device, shards, aggregate layout): jobs and rebuilt
    engines reuse one family of steps (see ``_build_session_merge_step``)."""
    key = (str(mesh.device), int(mesh.size), agg.cache_key())
    return PROGRAM_CACHE.get_or_build(
        "session-merge", key, lambda: _build_session_merge_step(mesh, agg))


def _build_session_merge_step(mesh: LogicalMesh, agg: AggregateFunction):
    """``(accs, dst [P, M], src [P, M]) -> accs``: per shard p,
    ``acc[p, dst] op= acc[p, src]`` then ``acc[p, src] = identity``, in
    place. Destinations repeat within a shard: every moved value is
    gathered first, then folded in lane order — through the ordered fold
    on the ``[P, cap]`` planes for float leaves (the CUDA kernel on the
    card; never ``index_add_``, whose atomics pick another order), through
    ``scatter_add_``/``scatter_reduce_`` for integer ones — and only then
    are the sources reset. Padded lanes have ``dst == src == 0``: the
    reserved slot ends as the identity."""
    leaves = agg.leaves
    tds = tuple(torch_dtype(l.dtype) for l in leaves)
    folds = tuple(scatter_fold(l.reduce, td) for l, td in zip(leaves, tds))
    idents = tuple(np.asarray(l.identity).item() for l in leaves)

    def merge_step(accs, dst, src):
        idx = src.to(torch.int64)
        moved = [torch.gather(a, 1, idx) for a in accs]
        for a, fold, d, v in zip(accs, folds, fold_slots(dst, tds), moved):
            fold(a, d, v)
        for a, ident in zip(accs, idents):
            a.scatter_(1, idx, ident)
        return accs

    return merge_step


class MeshSessionEngine(MeshPagedSpillSupport):
    """Keyed session windows over a P-shard logical mesh.

    ``max_device_slots`` is a per-SHARD row budget (the reference's is
    per device; on the logical mesh each shard has its own budget, as
    ``tools/bench_mesh_sessions.py`` passes it). With a budget, state
    takes the paged spill layout: per shard, eviction moves cohorts of the
    coldest rows and the host indexes run registry-free."""

    #: on_watermark(async_ok=True) returns PendingFire handles, harvested
    #: in dispatch order
    supports_async_fires = True

    def __init__(
        self,
        gap: int,
        agg: AggregateFunction,
        mesh: LogicalMesh,
        capacity_per_shard: int = 1 << 16,
        max_parallelism: int = 128,
        allowed_lateness: int = 0,
        max_device_slots: int = 0,
        spill_dir: Optional[str] = None,
        spill_host_max_bytes: int = 0,
        key_group_range: Optional[Tuple[int, int]] = None,
        memory=None,
        spill_layout: str = "pages",
        max_dispatch_ahead: int = 2,
        shuffle_mode: str = "device",
        host_topology=None,
    ) -> None:
        if spill_layout not in ("namespaces", "pages"):
            raise ValueError(
                f"spill_layout must be 'namespaces' or 'pages', got "
                f"{spill_layout!r}")
        self.shuffle_mode = self._check_shuffle_mode(shuffle_mode)
        self._memory = memory
        self.gap = int(gap)
        self.agg = agg
        self.mesh = mesh
        self.P = int(mesh.size)
        self.device = mesh.device
        self._set_host_topology(host_topology)
        #: batches of device work in flight while the host preps the next
        self.max_dispatch_ahead = max(int(max_dispatch_ahead or 1), 1)
        self.spill_layout = spill_layout
        #: the namespace registry is kept only for the explicit
        #: "namespaces" layout (per-namespace eviction and frees); the
        #: paged layout frees by slot and runs registry-free
        self._track_ns = spill_layout == "namespaces"
        self.key_group_range = key_group_range
        self.max_device_slots = int(max_device_slots or 0)
        self.capacity = max(int(capacity_per_shard), 1024)
        if self.max_device_slots:
            self.max_device_slots = max(self.max_device_slots, 1024)
            self.capacity = min(self.capacity, self.max_device_slots)
        self.max_parallelism = max_parallelism
        self.allowed_lateness = int(allowed_lateness)
        if max_parallelism < self.P:
            raise ValueError(
                f"max_parallelism {max_parallelism} < mesh size {self.P}")
        # growable per-shard indexes, registry-free (the engine frees by
        # slot); the planes stay uniform [P, cap] sized to the largest
        self.indexes = self._make_shard_indexes()
        self._init_spill(spill_dir, spill_host_max_bytes)
        self._paged = (spill_layout == "pages"
                       and self.max_device_slots > 0)
        if self._paged:
            self._init_paged()
        self.accs: Tuple[torch.Tensor, ...] = self._fresh_planes()
        self._build_steps()
        #: session-interval metadata: the native C sweep when it builds,
        #: else the Python plane (bit-identical fires)
        self.meta = make_session_meta(self.gap, self.allowed_lateness)
        self._init_tracking()
        #: hot-key splitting: key id -> salts (see register_hot_key)
        self._hot_keys: Dict[int, int] = {}
        #: records diverted through the salting path, and fires that
        #: folded salted sub-rows (the skew gauges)
        self._hot_salted_records = 0
        self._hot_salted_fires = 0
        self._merge_bucket = 0
        self._fire_bucket = 0
        self._reset_bucket = 0
        #: merge groups run, and the pairs of the largest (one shard)
        self.merge_groups = 0
        self.merge_pairs_max = 0

    @property
    def late_records_dropped(self) -> int:
        return self.meta.late_records_dropped

    def _build_steps(self) -> None:
        # the [P, B] scatter step serves host shuffle mode
        (self._scatter_step, _, self._reset_step, self._gather_step,
         self._put_step, _, _) = build_mesh_steps(self.mesh, self.agg)
        self._merge_step = build_session_merge_step(self.mesh, self.agg)
        self._delta_fire_step = build_delta_fire_step(self.mesh, self.agg)
        self._exchange_scatter_step = build_exchange_scatter(
            self.mesh, self.agg)
        self._exchange2_steps = (
            build_exchange2_steps(self.mesh, self.host_topology, self.agg)
            if self._two_level_active() else None)

    def _shard_index_grew(self, new_capacity: int) -> None:
        """Widen the planes and dirty bits (``MeshSpillSupport``) and, when
        paged, the page state."""
        super()._shard_index_grew(new_capacity)
        if self._paged:
            self._paged_grow(new_capacity)

    # --------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        with self._flight_ingest():
            self._process_batch_inner(batch)

    def _process_batch_inner(self, batch: RecordBatch) -> None:
        n = len(batch)
        # batch boundary: the engine is consistent at a known source
        # position — the one point the watchdog may declare a shard dead
        self._wd_boundary()
        if self._paged:
            # page sweeps queued by fire-path extractions run here
            self._drain_deferred_sweeps()
        ts = np.asarray(batch.timestamps, dtype=np.int64)
        keys = np.asarray(batch.key_ids, dtype=np.int64)
        if self._spill_active and n > 1:
            # bound one batch's PER-SHARD session working set by half the
            # budget: per-shard record counts bound the touched sessions
            # (one hash pass); only a shard over that bound pays the
            # np.unique refinement. Halving is safe: the absorb is
            # incremental and no fire runs between the halves.
            budget = max(self.max_device_slots // 2, 1024)
            if n > budget:
                rsm = getattr(self.meta, "rec_shard_max", None)
                if self._assignment is not None:
                    # the native sweep hard-codes the contiguous formula
                    rsm = None
                if rsm is not None:
                    rec_max = rsm(keys, self.P, self.max_parallelism,
                                  self.key_group_range)
                else:
                    rec_max = int(np.bincount(self._route(keys),
                                              minlength=self.P).max())
                if rec_max > budget:
                    per_shard = np.bincount(self._route(np.unique(keys)),
                                            minlength=self.P)
                    if int(per_shard.max()) > budget:
                        half = np.zeros(n, dtype=bool)
                        half[: n // 2] = True
                        self._ingest_subbatch(batch.filter(half))
                        self._ingest_subbatch(batch.filter(~half))
                        return

        with flight.span("prep.meta_sweep"):
            try:
                res = self.meta.absorb_batch_ex(keys, ts,
                                                want_fresh=self._paged)
            except NativePlaneError as e:
                # the absorb is the batch's first mutation (no device
                # state touched yet), so the batch re-runs on the Python
                # plane
                self._meta_fallback(e)
                res = self.meta.absorb_batch_ex(keys, ts,
                                                want_fresh=self._paged)
        sess_key, sess_sid = res.sess_key, res.sess_sid
        rec_to_sess, order = res.rec_to_sess, res.order
        for g in res.groups:
            self._run_merge_group(g)

        live_sess = sess_sid >= 0
        if not live_sess.all():
            starts_pos = np.nonzero(np.diff(rec_to_sess, prepend=-1) > 0)[0]
            sess_counts = np.diff(np.append(starts_pos, n))
            self.meta.late_records_dropped += int(
                sess_counts[~live_sess].sum())

        # the live sessions grouped by shard (stable: within-shard session
        # order kept), every resolve column gathered once: one C sweep on
        # the native plane, NumPy on the Python plane
        m = len(sess_key)
        shard_slices: Dict[int, Tuple[int, int]] = {}
        sg = getattr(self.meta, "shard_group", None)
        if self._assignment is not None:
            # sx_shard_group applies the contiguous formula in C; a live
            # table takes the NumPy path (route_records stays valid: it
            # consumes the sess_shard handed to it)
            sg = None
        if sg is not None:
            (sess_shard, counts, sorted_idx, key_sorted, sid_sorted,
             fresh_sorted, hint_sorted, row_sorted) = sg(
                res, self.P, self.max_parallelism, self.key_group_range)
        else:
            sess_shard = self._route(sess_key)
            sorted_idx = np.nonzero(live_sess)[0]
            counts = np.zeros(self.P, dtype=np.int64)
            if len(sorted_idx):
                shards_live = sess_shard[sorted_idx]
                sorted_idx = sorted_idx[np.argsort(shards_live,
                                                   kind="stable")]
                counts = np.bincount(shards_live, minlength=self.P)
            key_sorted = sess_key[sorted_idx]
            sid_sorted = sess_sid[sorted_idx]
            fresh_sorted = (None if res.fresh is None
                            else res.fresh[sorted_idx])
            hint_sorted = (None if res.slot_hint is None
                           else res.slot_hint[sorted_idx])
            row_sorted = (None if res.meta_row is None
                          else res.meta_row[sorted_idx])
        offs = np.concatenate(([0], np.cumsum(counts)))
        for p in np.nonzero(counts)[0].tolist():
            shard_slices[p] = (int(offs[p]), int(offs[p + 1]))
        slot_sorted = np.zeros(len(sorted_idx), dtype=np.int32)
        if self._paged:
            # fresh sessions skip the probe and the page query; verified
            # folded slots skip the probe
            resolved = self._resolve_slots_paged(
                {p: (key_sorted[a:b], sid_sorted[a:b])
                 for p, (a, b) in shard_slices.items()},
                fresh={p: fresh_sorted[a:b]
                       for p, (a, b) in shard_slices.items()},
                hints=(None if hint_sorted is None else
                       {p: hint_sorted[a:b]
                        for p, (a, b) in shard_slices.items()}))
            for p, (a, b) in shard_slices.items():
                slot_sorted[a:b] = resolved[p]
                self._dirty[p, resolved[p]] = True
                self._rep_mark(p, resolved[p])
            # fold the slots into the metadata rows so the next batch's
            # resolve skips the probe (native plane only)
            self.meta.note_slots(key_sorted, sid_sorted, slot_sorted,
                                 rows=row_sorted)
        else:
            if self._spill_active:
                # the namespace layout: reload this batch's spilled
                # sessions, refresh their recency, and make room
                touched = {p: np.unique(sid_sorted[a:b])
                           for p, (a, b) in shard_slices.items()}
                self._ensure_resident(touched)
                for p, sids in touched.items():
                    self._touch(p, sids.tolist())
            for p, (a, b) in shard_slices.items():
                self._reserve(p, key_sorted[a:b], sid_sorted[a:b])
                slots = self.indexes[p].lookup_or_insert(
                    key_sorted[a:b], sid_sorted[a:b])
                slot_sorted[a:b] = slots
                self._dirty[p, slots] = True
                self._rep_mark(p, slots)

        # each record scatters into its session's slot on its session's
        # shard; records of stale sessions keep slot 0 (the identity slot)
        rt = getattr(self.meta, "route_records", None)
        if rt is not None:
            rec_slots, rec_shards = rt(n, order, rec_to_sess, m,
                                       sorted_idx, slot_sorted, sess_shard)
        else:
            rec_slots, rec_shards = route_records_plain(
                n, order, rec_to_sess, m, sorted_idx, slot_sorted,
                sess_shard)
        if self._hot_keys:
            rec_slots, rec_shards = self._salt_hot_records(
                keys, ts, sess_key, sess_sid, rec_to_sess, order,
                rec_slots, rec_shards)
        values = self.agg.map_input(batch)
        in_leaves = self.agg.input_leaves
        self._dispatch_exchange(
            rec_shards,
            [np.asarray(rec_slots, dtype=np.int32),
             *[np.asarray(v, dtype=l.dtype)
               for v, l in zip(values, in_leaves)]],
            [0, *[l.identity for l in in_leaves]],
            self._exchange_scatter_step, self._exchange2_steps,
            self._scatter_step, n)

    def _run_merge_group(self, g: MergeGroup) -> None:
        """Resolve a chain-free merge group's rows per shard (dst and src
        in ONE lookup, so both are resident together) and move their
        accumulators in one merge step over ``[P, M]`` blocks; then free
        the absorbed rows."""
        gk = np.asarray(g.keys_dst, dtype=np.int64)
        ds = np.asarray(g.sids_dst, dtype=np.int64)
        ss = np.asarray(g.sids_src, dtype=np.int64)
        if self._hot_keys:
            gk, ds, ss = self._expand_hot_merges(gk, ds, ss)
        shards = self._route(gk)
        pairs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for p in range(self.P):
            sel = shards == p
            if sel.any():
                pairs[p] = (np.concatenate([gk[sel], gk[sel]]),
                            np.concatenate([ds[sel], ss[sel]]))
        if self._paged:
            resolved = self._resolve_slots_paged(pairs)
        else:
            if self._spill_active:
                # both sides of every pair resident together
                touched = {p: np.unique(sids2)
                           for p, (_, sids2) in pairs.items()}
                self._ensure_resident(touched)
                for p, sids in touched.items():
                    self._touch(p, sids.tolist())
            resolved = {}
            for p, (keys2, sids2) in pairs.items():
                self._reserve(p, keys2, sids2)
                resolved[p] = self.indexes[p].lookup_or_insert(keys2, sids2)
        m_max = 0
        per_shard: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for p in pairs:
            both = resolved[p]
            c = len(both) // 2
            d_slots = both[:c].astype(np.int32)
            s_slots = both[c:].astype(np.int32)
            self._dirty[p, d_slots] = True
            self._rep_mark(p, d_slots)
            per_shard[p] = (d_slots, s_slots)
            m_max = max(m_max, c)
        if m_max == 0:
            return
        self.merge_groups += 1
        self.merge_pairs_max = max(self.merge_pairs_max, m_max)
        M = sticky_bucket(m_max, self._merge_bucket)
        self._merge_bucket = M
        dst_block = np.zeros((self.P, M), dtype=np.int32)
        src_block = np.zeros((self.P, M), dtype=np.int32)
        for p, (d_slots, s_slots) in per_shard.items():
            dst_block[p, : len(d_slots)] = d_slots
            src_block[p, : len(s_slots)] = s_slots
        self.accs = self._merge_step(self.accs, self._to_device(dst_block),
                                     self._to_device(src_block))
        if self._paged:
            # fold the destinations' slots into their metadata rows
            # (native plane): the dst sessions live on
            fk, fs, fl = [], [], []
            for p, (d_slots, _) in per_shard.items():
                c = len(d_slots)
                pk2, ps2 = pairs[p][0][:c], pairs[p][1][:c]
                if self._hot_keys:
                    # salted sub-rows (negative sids) have no metadata
                    # row to fold a slot into
                    keep2 = ps2 >= 0
                    pk2, ps2, d_slots = pk2[keep2], ps2[keep2], d_slots[keep2]
                if len(pk2):
                    fk.append(pk2)
                    fs.append(ps2)
                    fl.append(d_slots)
            if fk:
                self.meta.note_slots(np.concatenate(fk),
                                     np.concatenate(fs),
                                     np.concatenate(fl))
        # delta snapshots drop the absorbed rows (tombstones); their slots
        # are in hand (the src half of each shard's lookup): free by slot
        self._freed_ns.append(np.asarray(g.absorbed_sids, dtype=np.int64))
        if self._track_ns:
            self._drop_spilled(g.absorbed_sids)
            for p in range(self.P):
                self.indexes[p].free_namespaces(g.absorbed_sids)
            return
        for p, (_, s_slots) in per_shard.items():
            src_sids = pairs[p][1][len(s_slots):]
            if self._paged:
                self._free_rows_paged(p, s_slots, src_sids)
            else:
                self.indexes[p].free_slots(s_slots)
                self._dirty[p, s_slots] = False

    # ---------------------------------------------------- hot-key splitting

    def register_hot_key(self, key_id: int, salts: int = 8,
                         allow_inexact: bool = False) -> int:
        """Two-stage aggregation for one dominating key: its records are
        salted into ``salts`` sub-keys, pre-aggregated on their OWN
        shards as ordinary (salted key, negative namespace) rows, and
        folded back at fire and query time in a fixed order (main row,
        then salts ascending).

        Min/max and integer sums are bit-identical to the unsplit run;
        a float sum reassociates, so it needs ``allow_inexact=True``
        (integer-valued floats below the mantissa limit stay exact).
        Paged spill layout only. Returns the salt count applied, clamped
        to ``[2, MAX_SALTS]``."""
        if not self._paged:
            raise ValueError(
                "hot-key splitting requires the paged spill layout "
                "(spill_layout='pages' with max_device_slots > 0)")
        salts = max(2, min(int(salts), MAX_SALTS))
        exact = all(
            l.reduce in ("min", "max") or np.dtype(l.dtype).kind in "iub"
            for l in self.agg.leaves)
        if not exact and not allow_inexact:
            raise ValueError(
                "splitting a float sum reassociates the fold; pass "
                "allow_inexact=True if the stream tolerates it (exact "
                "for integer-valued floats below the mantissa limit)")
        self._hot_keys[int(key_id)] = salts
        # the serving shadow re-routes the split key through the live
        # combined fold (one lookup answers main + salts)
        self._rep_rebuild = True
        return salts

    def hot_key_stats(self) -> Dict[str, object]:
        return {
            "keys": dict(self._hot_keys),
            "salted_records": int(self._hot_salted_records),
            "salted_fires": int(self._hot_salted_fires),
        }

    def _hot_key_array(self) -> np.ndarray:
        return np.fromiter(self._hot_keys, dtype=np.int64,
                           count=len(self._hot_keys))

    def _salt_hot_records(self, keys, ts, sess_key, sess_sid,
                          rec_to_sess, order, rec_slots, rec_shards):
        """Ingest diversion: re-point the hot keys' records at their
        salted sub-rows. The salt is splitmix64 of the record TIMESTAMP
        modulo the key's salts, so a replay salts identically."""
        hot = self._hot_key_array()
        hot_sess = np.isin(sess_key, hot) & (sess_sid >= 0)
        j = np.nonzero(hot_sess[rec_to_sess])[0]
        if not len(j):
            return rec_slots, rec_shards
        ridx = order[j]  # raw record positions
        rk = keys[ridx]
        rs = sess_sid[rec_to_sess[j]]
        nsalts = np.zeros(len(ridx), dtype=np.uint64)
        for hk, hv in self._hot_keys.items():
            nsalts[rk == hk] = np.uint64(hv)
        salt = (_splitmix64(ts[ridx].astype(np.uint64))
                % nsalts).astype(np.int64)
        skey = _salted_keys(rk, salt)
        sns = _salted_ns(rs, salt)
        # sids are globally unique, so the salted namespace alone names
        # the (session, salt) row: resolve each once, scatter the slot
        uns, inv = np.unique(sns, return_inverse=True)
        first_pos = np.zeros(len(uns), dtype=np.int64)
        first_pos[inv[::-1]] = np.arange(len(sns) - 1, -1, -1)
        ukey = skey[first_pos]
        shards_u = self._route(ukey)
        per = {}
        for p in np.unique(shards_u).tolist():
            selp = np.nonzero(shards_u == p)[0]
            per[p] = (ukey[selp], uns[selp])
        resolved = self._resolve_slots_paged(per)
        slots_u = np.zeros(len(uns), dtype=np.int32)
        for p in per:
            selp = np.nonzero(shards_u == p)[0]
            slots_u[selp] = resolved[p]
            self._dirty[p, resolved[p]] = True
        rec_slots = np.array(rec_slots, dtype=np.int32)
        rec_shards = np.array(rec_shards, dtype=np.int64)
        rec_slots[ridx] = slots_u[inv]
        rec_shards[ridx] = shards_u[inv]
        self._hot_salted_records += len(ridx)
        return rec_slots, rec_shards

    def _expand_hot_merges(self, gk, ds, ss):
        """A split key's session merge carries its salted sub-rows:
        (skey(k,t), ssid(src,t)) folds into (skey(k,t), ssid(dst,t)) —
        the same salted key, hence the same shard. Missing sub-rows
        resolve to identity (a no-op merge)."""
        sel = np.nonzero(np.isin(gk, self._hot_key_array()))[0]
        if not len(sel):
            return gk, ds, ss
        ek, ed, es = [gk], [ds], [ss]
        freed = []
        for i in sel.tolist():
            k = int(gk[i])
            n = self._hot_keys[k]
            salts = np.arange(n, dtype=np.int64)
            ek.append(_salted_keys(np.full(n, k, dtype=np.int64), salts))
            ed.append(_salted_ns(np.full(n, int(ds[i]), dtype=np.int64),
                                 salts))
            sns = _salted_ns(np.full(n, int(ss[i]), dtype=np.int64), salts)
            es.append(sns)
            freed.append(sns)
        # absorbed sub-rows die with their session: delta tombstones
        self._freed_ns.append(np.concatenate(freed))
        return (np.concatenate(ek), np.concatenate(ed), np.concatenate(es))

    def _hot_rows(self, hk, hs):
        """Physical rows of split logical rows ``(hk[i], hs[i])``: main
        first, then its salts ascending; ``gid`` names the logical row."""
        pks, pns, gids = [], [], []
        for i in range(len(hk)):
            k, s = int(hk[i]), int(hs[i])
            pks.append(k)
            pns.append(s)
            gids.append(i)
            n = self._hot_keys.get(k)
            if n and s >= 0:
                salts = np.arange(n, dtype=np.int64)
                pks.extend(_salted_keys(
                    np.full(n, k, dtype=np.int64), salts).tolist())
                pns.extend(_salted_ns(
                    np.full(n, s, dtype=np.int64), salts).tolist())
                gids.extend([i] * n)
        return (np.asarray(pks, dtype=np.int64),
                np.asarray(pns, dtype=np.int64),
                np.asarray(gids, dtype=np.int64))

    def _fire_hot_fold(self, hk, hs) -> List[np.ndarray]:
        """RAW folded leaves of fired split sessions: the delta fire
        finishes on the device, so a split session's sub-rows fold
        BEFORE the finish, here. Resident rows come back through one
        gather and one reset (their slots return to identity), paged rows
        extract from the page tier, absent rows are identity; each leaf
        folds with the exchange's combine op in array order — main row
        first, salts ascending."""
        leaves = self.agg.leaves
        leaf_dtypes = [l.dtype for l in leaves]
        pk, pn, gid = self._hot_rows(hk, hs)
        vals = [np.full(len(pk), l.identity, dtype=l.dtype) for l in leaves]
        shards = self._route(pk)
        lanes: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        g_max = 0
        for p in range(self.P):
            selp = np.nonzero(shards == p)[0]
            if not len(selp):
                continue
            idx = self.indexes[p]
            ks, ns = pk[selp], pn[selp]
            slots = idx.lookup(ks, ns)
            hit = slots >= 0
            if hit.any():
                rslots = slots[hit].astype(np.int32)
                lanes[p] = (selp[hit], rslots)
                g_max = max(g_max, len(rslots))
                idx.free_slots(rslots, keys=ks[hit], nss=ns[hit])
                self._dirty[p, rslots] = False
            miss = ~hit
            if miss.any() and len(self._pmaps[p]):
                rl = reload_rows_for(self.spills[p], self._pmaps[p],
                                     ns[miss], leaf_dtypes)
                if rl is not None:
                    _, rns, _, rvals = rl
                    ro = np.argsort(rns)
                    found, pos = sorted_match(rns[ro], ns[miss])
                    src = ro[pos[found]]
                    dstp = selp[miss][found]
                    for i in range(len(leaves)):
                        vals[i][dstp] = rvals[i][src]
        if g_max:
            G = pad_bucket_size(g_max, minimum=64)
            block = np.zeros((self.P, G), dtype=np.int32)
            for p, (_, rslots) in lanes.items():
                block[p, : len(rslots)] = rslots
            dev_block = self._to_device(block)
            g_host = self._harvest_get(
                self._gather_step(self.accs, dev_block), "hot_fire")
            # freed slots hold identity before reuse (padded lanes hit
            # the reserved slot 0: harmless)
            self.accs = self._reset_step(self.accs, dev_block)
            for p, (selp_hit, rslots) in lanes.items():
                for i in range(len(leaves)):
                    vals[i][selp_hit] = g_host[i][p][: len(rslots)]
        # salted namespaces die with the fire: delta tombstones
        self._freed_ns.append(pn[pn < 0])
        out = [np.full(len(hk), l.identity, dtype=l.dtype) for l in leaves]
        for i, l in enumerate(leaves):
            # ufunc.at is unbuffered: repeated gids fold in ARRAY order
            HOST_COMBINE[l.reduce].at(out[i], gid, vals[i])
        return out

    def _rep_hidden(self, keys: np.ndarray, nss: np.ndarray):
        """Serving-plane filter over resident rows: ``(salted, hot_main)``
        masks, or None without split keys. Salted sub-rows never publish
        (a partial alone means nothing); a split key's MAIN rows enter
        the index COLD, so a replica lookup goes through the live
        engine's combined fold and still answers in one lookup."""
        if not self._hot_keys:
            return None
        nss = np.asarray(nss, dtype=np.int64)
        salted = nss < 0
        hot_main = np.isin(np.asarray(keys, dtype=np.int64),
                           self._hot_key_array()) & ~salted
        return salted, hot_main

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int,
                     async_ok: bool = False) -> List[object]:
        self._wd_boundary()
        with flight.fire_span(watermark):
            out = self._on_watermark_inner(watermark, async_ok)
        # replica publish AFTER this boundary's fires and frees (outside
        # the fire span, under its own serving.replica_publish span)
        self._publish_replica(watermark)
        return out

    # -------------------------------------------------- replica hooks

    def _rep_extra(self, p: int, keys: np.ndarray, nss: np.ndarray):
        """The session END per published (key, sid) row — the result key
        of the serving composition ({session_end -> columns}). One
        interval-list scan per KEY, not per row."""
        out = np.zeros(len(keys), dtype=np.int64)
        sessions = self.meta.sessions
        by_key: Dict[int, List[int]] = {}
        for j in range(len(keys)):
            by_key.setdefault(int(keys[j]), []).append(j)
        for key, idxs in by_key.items():
            ivs = sessions.get(key, ())
            if not ivs:
                continue
            end_of = {int(iv[2]): int(iv[1]) for iv in ivs}
            for j in idxs:
                out[j] = end_of.get(int(nss[j]), 0)
        return out

    def _rep_probe_cold(self, p: int, keys: np.ndarray,
                        nss: np.ndarray) -> np.ndarray:
        """A session that left the resident set is COLD iff its sid is
        still mapped in the shard's page tier (paged layout) or its
        namespace is spilled (namespace layout); otherwise it fired or
        merged away and the index entry drops."""
        if self._paged:
            return self._pmaps[p].spilled_mask(
                np.asarray(nss, dtype=np.int64))
        return super()._rep_probe_cold(p, keys, nss)

    def _on_watermark_inner(self, watermark: int,
                            async_ok: bool) -> List[object]:
        pop = self.meta.pop_fired_ex(watermark)
        keys, starts, ends, sids = pop.keys, pop.starts, pop.ends, pop.sids
        hint = pop.slot_hint
        if not len(keys):
            return []
        if self._spill_active:
            # a catch-up fire can exceed the budget: chunk it (the paged
            # fire touches the device only for resident rows, so its
            # chunk merely bounds the host-side assembly)
            chunk = max(self.max_device_slots // 2, 1024)
            if self._paged:
                chunk = max(chunk, 1 << 20)
            if len(keys) > chunk:
                out: List[object] = []
                for a in range(0, len(keys), chunk):
                    out.extend(self._fire_sessions(
                        keys[a:a + chunk], starts[a:a + chunk],
                        ends[a:a + chunk], sids[a:a + chunk],
                        async_ok=async_ok,
                        slot_hint=(None if hint is None
                                   else hint[a:a + chunk])))
                return out
        return self._fire_sessions(keys, starts, ends, sids,
                                   async_ok=async_ok, slot_hint=hint)

    def _fire_sessions(self, keys, starts, ends, sids,
                       async_ok: bool = False,
                       slot_hint=None) -> List[object]:
        chaos.fault_point("mesh.session_fire", sessions=len(keys))
        k_arr = np.asarray(keys, dtype=np.int64)
        sid_arr = np.asarray(sids, dtype=np.int64)
        st_arr = np.asarray(starts, dtype=np.int64)
        en_arr = np.asarray(ends, dtype=np.int64)
        shards = self._route(k_arr)
        per_shard_sel: List[np.ndarray] = [
            np.nonzero(shards == p)[0] for p in range(self.P)]
        if self._paged:
            return self._fire_sessions_hybrid(
                k_arr, st_arr, en_arr, sid_arr, per_shard_sel, async_ok,
                slot_hint)
        if self._spill_active:
            # the namespace layout: the fired sessions resident first
            touched = {p: np.unique(sid_arr[sel])
                       for p, sel in enumerate(per_shard_sel) if len(sel)}
            self._ensure_resident(touched)
            for p in touched:
                sel = per_shard_sel[p]
                self._reserve(p, k_arr[sel], sid_arr[sel])
        w_max = 0
        per_shard_slots: List[np.ndarray] = []
        for p, sel in enumerate(per_shard_sel):
            if len(sel) == 0:
                per_shard_slots.append(np.empty(0, np.int32))
                continue
            per_shard_slots.append(self.indexes[p].lookup_or_insert(
                k_arr[sel], sid_arr[sel]).astype(np.int32))
            w_max = max(w_max, len(sel))
        W = sticky_bucket(w_max, self._fire_bucket, minimum=64)
        self._fire_bucket = W
        sm = np.zeros((self.P, W, 1), dtype=np.int32)
        rb = np.zeros((self.P, W), dtype=np.int32)
        for p, slots in enumerate(per_shard_slots):
            sm[p, : len(slots), 0] = slots
            rb[p, : len(slots)] = slots
        # fire + reset in one step; its outputs are fresh tensors, so a
        # deferred host read never races the reset
        self.accs, fire_out = self._delta_fire_step(
            self.accs, self._to_device(sm), self._to_device(rb))
        self._freed_ns.append(sid_arr)
        for p, slots in enumerate(per_shard_slots):
            if len(slots):
                self._dirty[p, slots] = False
            if self._track_ns:
                self.indexes[p].free_namespaces(
                    [int(sid_arr[i]) for i in per_shard_sel[p]])
            elif len(slots):
                self.indexes[p].free_slots(slots)
        # the output batch in shard order
        out_idx = np.concatenate([s for s in per_shard_sel if len(s)])
        cols = {
            KEY_ID_FIELD: k_arr[out_idx],
            WINDOW_START_FIELD: st_arr[out_idx],
            WINDOW_END_FIELD: en_arr[out_idx],
            TIMESTAMP_FIELD: en_arr[out_idx] - 1,
        }
        per_shard_counts = [len(s) for s in per_shard_sel]
        names = sorted(fire_out.keys())

        def build(host: List[np.ndarray]) -> RecordBatch:
            full = dict(cols)
            for name, arr in zip(names, host):
                full[name] = np.concatenate(
                    [arr[p][:m] for p, m in enumerate(per_shard_counts)
                     if m])
            return RecordBatch(full)

        return self._deliver([fire_out[n] for n in names], build, async_ok)

    def _fire_sessions_hybrid(self, k_arr, st_arr, en_arr, sid_arr,
                              per_shard_sel, async_ok: bool,
                              slot_hint=None) -> List[object]:
        """Paged-layout fire: RESIDENT sessions merge and finish on the
        device (one delta fire over the whole mesh), paged-out sessions
        fire straight from their pages on the host — a fired session is
        freed at once, so reloading it would buy nothing. Extraction
        tombstones the page rows; no device traffic for them."""
        leaves = self.agg.leaves
        n = len(k_arr)
        self._freed_ns.append(sid_arr)
        leaf_dtypes = [l.dtype for l in leaves]
        # split sessions cannot finish on the device: their physical rows
        # fold on the host first and finish with the paged-out rows (the
        # original per-shard selection keeps the output order)
        out_sel = per_shard_sel
        hot_pos = hot_vals = None
        if self._hot_keys:
            hmask = np.isin(k_arr, self._hot_key_array())
            if hmask.any():
                hot_pos = np.nonzero(hmask)[0]
                hot_vals = self._fire_hot_fold(k_arr[hot_pos],
                                               sid_arr[hot_pos])
                self._hot_salted_fires += len(hot_pos)
                per_shard_sel = [sel[~hmask[sel]] for sel in per_shard_sel]
        res_pos: List[np.ndarray] = []   # positions fired on the device
        res_slots: List[np.ndarray] = []
        cold_chunks: List[np.ndarray] = []  # positions fired from pages
        cold_vals: List[List[np.ndarray]] = [[] for _ in leaves]
        w_max = 0
        for p, sel in enumerate(per_shard_sel):
            if len(sel) == 0:
                res_pos.append(np.empty(0, dtype=np.int64))
                res_slots.append(np.empty(0, dtype=np.int32))
                continue
            idx = self.indexes[p]
            ks, ss = k_arr[sel], sid_arr[sel]
            if slot_hint is not None:
                # verified folds replace the probe; stale ones pay a
                # read-only lookup
                slots = resolve_slot_hints(idx, ks, ss, slot_hint[sel])
            else:
                slots = idx.lookup(ks, ss)  # read-only: no insert/evict
            hit = slots >= 0
            rslots = slots[hit].astype(np.int32)
            res_pos.append(sel[hit])
            res_slots.append(rslots)
            w_max = max(w_max, len(rslots))
            cold = ~hit
            if cold.any():
                cpos = sel[cold]
                # identity where no state exists
                vals_p = [np.full(len(cpos), l.identity, dtype=l.dtype)
                          for l in leaves]
                rl = reload_rows_for(self.spills[p], self._pmaps[p],
                                     ss[cold], leaf_dtypes) \
                    if len(self._pmaps[p]) else None
                if rl is not None:
                    _, rns, _, rvals = rl
                    # align the extracted rows (unordered) to their fired
                    # positions; sids are unique, misses keep identity
                    order = np.argsort(rns)
                    found, pos = sorted_match(rns[order], ss[cold])
                    src = order[pos[found]]
                    for i in range(len(leaves)):
                        vals_p[i][found] = rvals[i][src]
                cold_chunks.append(cpos)
                for i in range(len(leaves)):
                    cold_vals[i].append(vals_p[i])
            # slot-addressed free of the resident fired rows (the pair
            # columns are in hand, so the free skips the metadata reads)
            if len(rslots):
                idx.free_slots(rslots, keys=ks[hit], nss=ss[hit])
                self._dirty[p, rslots] = False
        # device part: fire + reset of the resident rows in one step (its
        # outputs are fresh tensors: an async read never races the reset)
        fire_out = None
        if w_max:
            W = sticky_bucket(w_max, self._fire_bucket, minimum=64)
            self._fire_bucket = W
            sm = np.zeros((self.P, W, 1), dtype=np.int32)
            rb = np.zeros((self.P, W), dtype=np.int32)
            for p, rslots in enumerate(res_slots):
                m = len(rslots)
                sm[p, :m, 0] = rslots
                rb[p, :m] = rslots
            self.accs, fire_out = self._delta_fire_step(
                self.accs, self._to_device(sm), self._to_device(rb))
        # host finish of the paged-out positions only
        names = sorted(self.agg.output_names)
        if hot_pos is not None:
            cold_chunks.append(hot_pos)
            for i in range(len(leaves)):
                cold_vals[i].append(hot_vals[i])
        if cold_chunks:
            cold_pos = np.concatenate(cold_chunks)
            finished = self.agg.finish(tuple(
                torch.from_numpy(np.concatenate(c)) for c in cold_vals))
            cold_out = {name: col.numpy() for name, col in finished.items()}
        else:
            cold_pos = None
            cold_out = {}
        out_idx = np.concatenate([s for s in out_sel if len(s)])
        cols = {
            KEY_ID_FIELD: k_arr[out_idx],
            WINDOW_START_FIELD: st_arr[out_idx],
            WINDOW_END_FIELD: en_arr[out_idx],
            TIMESTAMP_FIELD: en_arr[out_idx] - 1,
        }

        def build(host: List[np.ndarray]) -> RecordBatch:
            full = dict(cols)
            for i, name in enumerate(names):
                if cold_pos is not None:
                    vals = np.empty(n, dtype=cold_out[name].dtype)
                    vals[cold_pos] = cold_out[name]
                else:
                    vals = np.empty(n, dtype=host[i].dtype)
                if host:
                    arr = host[i]
                    for p, rpos in enumerate(res_pos):
                        m = len(rpos)
                        if m:
                            vals[rpos] = arr[p][:m]
                full[name] = vals[out_idx]
            return RecordBatch(full)

        arrays = [fire_out[nm] for nm in names] if fire_out else []
        return self._deliver(arrays, build, async_ok)

    def _deliver(self, arrays, build, async_ok: bool) -> List[object]:
        """A PendingFire (its host copies in flight) or, synchronously,
        the built batch from ONE device-to-host copy (a watchdog section
        either way)."""
        if async_ok:
            return [PendingFire(arrays, build, watchdog=self._watchdog)]
        return [build(self._harvest_get(arrays))]

    # -------------------------------------------- native-plane degradation

    def _meta_fallback(self, err) -> None:
        """Swap the native metadata plane for the bit-identical Python
        plane after a runtime sweep failure — once, loudly (a warning and
        ``flink_tpu_torch.native.native_fallbacks()``), carrying the live
        sessions across through the plane-independent snapshot. Only a
        ``NativePlaneError`` reaches here, never a device error."""
        from flink_tpu_torch.native import note_fallback

        note_fallback(
            f"native session sweep failed at runtime "
            f"({type(err).__name__}: {err}) — engine degraded to the "
            "Python metadata plane")
        py = SessionIntervalSet(self.gap, self.allowed_lateness)
        py.restore(self.meta.snapshot())
        py.late_records_dropped = self.meta.late_records_dropped
        py.native_sweep_s = self.meta.native_sweep_s
        self.meta = py

    # ------------------------------------------------------------- snapshot

    def snapshot(self, mode: str = "full") -> Dict[str, object]:
        """``SessionWindower.snapshot``'s logical format — restorable across
        engines and mesh sizes (re-sharded by key group). The split-key
        registry travels with the salted rows it folds."""
        out = {"table": self._snapshot_table(mode), **self.meta.snapshot()}
        if self._hot_keys:
            out["hot_keys"] = {int(k): int(v)
                               for k, v in self._hot_keys.items()}
        return out

    def restore(self, snap: Dict[str, object],
                key_group_filter=None) -> None:
        """Restore, re-sharding by key group: single-device
        ``SessionWindower`` snapshots and mesh snapshots of any size."""
        # the registry is live BEFORE any fire or query folds the
        # snapshot's salted rows
        for k, v in (snap.get("hot_keys") or {}).items():
            self._hot_keys[int(k)] = int(v)
        self._restore_table(snap.get("table", {}), key_group_filter)
        self.meta.restore(snap, key_group_filter=key_group_filter,
                          max_parallelism=self.max_parallelism)

    # ------------------------------------------------ partial-failover hooks

    def _drop_meta_key_groups(self, groups) -> None:
        # a lost shard's session intervals die with its state rows; the
        # checkpoint unit (restore_key_groups) brings both back
        self.meta.drop_key_groups(groups, self.max_parallelism)

    def _merge_restored_meta(self, snap, groups) -> None:
        self.meta.merge_restore(snap, groups, self.max_parallelism)

    def _filter_meta_snapshot(self, snap, groups):
        out = SessionIntervalSet.filter_snapshot(snap, groups,
                                                 self.max_parallelism)
        if snap.get("hot_keys"):
            # every unit carries the whole (tiny) split registry, so any
            # subset of units restores with its folds intact
            out["hot_keys"] = dict(snap["hot_keys"])
        return out

    def _merge_meta_snapshots(self, units):
        _NEG = -(1 << 62)
        sessions: Dict[int, list] = {}
        hot: Dict[int, int] = {}
        for u in units:
            for k, ivs in u.get("sessions", {}).items():
                sessions[int(k)] = list(ivs)  # the ranges are disjoint
            for k, v in (u.get("hot_keys") or {}).items():
                hot[int(k)] = max(hot.get(int(k), 0), int(v))
        out = {
            "sessions": sessions,
            "next_sid": max((int(u.get("next_sid", 1)) for u in units),
                            default=1),
            # the OLDEST unit's staleness horizon: its range's records
            # replay from its position and must not be judged stale
            "max_fired_watermark": min(
                (u.get("max_fired_watermark", _NEG) for u in units),
                default=_NEG),
        }
        if hot:
            out["hot_keys"] = hot
        return out

    # ---------------------------------------------------------- point query

    def query_sessions(self, key_id: int) -> Dict[int, Dict[str, float]]:
        """{session_end -> result columns} for a key's live sessions: a
        batch of one (reference
        ``flink_tpu/parallel/sharded_sessions.py:1252``)."""
        return self.query_batch(np.asarray([key_id], dtype=np.int64))[0]

    def query_batch(self, key_ids) -> List[Dict[int, Dict[str, float]]]:
        """One ``{session_end -> result columns}`` dict per requested key,
        in request order (reference ``:1258``). The keys' live sessions
        come from the host metadata; every resident accumulator of the
        batch comes back through ONE ``[P, G]`` gather and ONE
        device-to-host copy (``_harvest_get(..., "serving_lookup")``);
        paged-out sessions answer from their shards' page tiers
        (``read_spilled_rows``: a peek per page, no reload). Read-only.
        A split key's logical row reads its main row and every salted
        sub-row, folded main first, salts ascending."""
        key_ids = np.asarray(key_ids, dtype=np.int64)
        n = len(key_ids)
        results: List[Dict[int, Dict[str, float]]] = [{} for _ in range(n)]
        if n == 0:
            return results
        rows: List[Tuple[int, int, int]] = []  # (request row, sid, end)
        for r in range(n):
            for iv in self.meta.sessions.get(int(key_ids[r]), ()):
                rows.append((r, int(iv[2]), int(iv[1])))
        if not rows:
            return results
        m = len(rows)
        rr = np.asarray([t[0] for t in rows], dtype=np.int64)
        pn = np.asarray([t[1] for t in rows], dtype=np.int64)
        pk = key_ids[rr]
        gid = None
        if self._hot_keys:
            pk, pn, gid = self._hot_rows(pk, pn)
        mp = len(pk)
        shards = self._route(pk)
        leaves = self.agg.leaves
        leaf_rows = [np.full(mp, l.identity, dtype=l.dtype) for l in leaves]
        have = np.zeros(mp, dtype=bool)
        lanes: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        g_max = 0
        cold: Dict[int, np.ndarray] = {}
        for p in range(self.P):
            sel = np.nonzero(shards == p)[0]
            if not len(sel):
                continue
            slots = self.indexes[p].lookup(pk[sel], pn[sel])
            hit = slots >= 0
            if hit.any():
                lanes[p] = (sel[hit], slots[hit].astype(np.int32))
                g_max = max(g_max, int(hit.sum()))
            if (~hit).any() and self._spill_active:
                cold[p] = sel[~hit]
        if g_max:
            G = pad_bucket_size(g_max, minimum=64)
            block = np.zeros((self.P, G), dtype=np.int32)
            for p, (_, hs) in lanes.items():
                block[p, : len(hs)] = hs
            g_host = self._harvest_get(
                self._gather_step(self.accs, self._to_device(block)),
                "serving_lookup")
            for p, (sel_hit, hs) in lanes.items():
                for i in range(len(leaves)):
                    leaf_rows[i][sel_hit] = g_host[i][p][: len(hs)]
                have[sel_hit] = True

        def _take_row(j, entry, src):
            for i, l in enumerate(leaves):
                leaf_rows[i][j] = np.asarray(
                    entry[f"leaf_{i}"], dtype=l.dtype)[src]
            have[j] = True

        for p, sel_cold in cold.items():
            read_spilled_rows(
                self.spills[p], self._pmaps[p] if self._paged else None,
                self._paged,
                [(j, int(pk[j]), int(pn[j])) for j in sel_cold.tolist()],
                _take_row)
        if gid is not None:
            # physical rows fold into their logical row in array order
            # (main first, salts ascending); misses are identity
            folded = [np.full(m, l.identity, dtype=l.dtype) for l in leaves]
            for i, l in enumerate(leaves):
                HOST_COMBINE[l.reduce].at(folded[i], gid, leaf_rows[i])
            hv = np.zeros(m, dtype=bool)
            np.logical_or.at(hv, gid, have)
            leaf_rows, have = folded, hv
        # one host finish over every row at once
        finished = self.agg.finish(tuple(torch.from_numpy(l)
                                         for l in leaf_rows))
        cols = {name: col.numpy() for name, col in finished.items()}
        for j, (r, _sid, end) in enumerate(rows):
            if have[j]:
                results[r][end] = {name: col[j].item()
                                   for name, col in cols.items()}
        return results


def route_records_plain(n: int, order: np.ndarray, rec_to_sess: np.ndarray,
                        m: int, sorted_idx: np.ndarray,
                        slot_sorted: np.ndarray, sess_shard: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The NumPy form of the native ``route_records`` sweep:
    ``rec[order[i]] = per_session[rec_to_sess[i]]`` for the slot and
    shard columns; sessions without a resolved slot route to slot 0."""
    slot_of_sess = np.zeros(m, dtype=np.int32)
    slot_of_sess[sorted_idx] = slot_sorted
    rec_slots = np.empty(n, dtype=np.int32)
    rec_slots[order] = slot_of_sess[rec_to_sess]
    rec_shards = np.empty(n, dtype=np.int64)
    rec_shards[order] = sess_shard[rec_to_sess]
    return rec_slots, rec_shards
