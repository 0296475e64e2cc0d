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

Left out, each raising ``NotImplementedError`` naming its ROADMAP item:
hot-key salting (item 12g), the read replica (12f), point queries (12e),
host shuffle mode and the two-level exchange (12h).
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
    fold_slots,
    scatter_fold,
    sticky_bucket,
    torch_dtype,
)
from flink_tpu_torch.parallel.mesh import LogicalMesh
from flink_tpu_torch.parallel.sharded_windower import (
    MeshPagedSpillSupport,
    build_delta_fire_step,
    build_mesh_steps,
)
from flink_tpu_torch.parallel.shuffle import (
    build_exchange_scatter,
    stage_device_exchange,
)
from flink_tpu_torch.runtime.pending import PendingFire
from flink_tpu_torch.state.paged_spill import reload_rows_for, sorted_match
from flink_tpu_torch.state.slot_table import (
    _not_ported,
    resolve_slot_hints,
)
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


def build_session_merge_step(mesh: LogicalMesh, agg: AggregateFunction):
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
        if shuffle_mode not in ("host", "device"):
            raise ValueError(
                f"shuffle_mode must be 'host' or 'device', got "
                f"{shuffle_mode!r}")
        if shuffle_mode != "device":
            raise _not_ported(f"shuffle.mode={shuffle_mode!r}", "12h")
        if host_topology is not None:
            raise _not_ported("the two-level exchange (shuffle.hosts)", "12h")
        self._memory = memory
        self.gap = int(gap)
        self.agg = agg
        self.mesh = mesh
        self.P = int(mesh.size)
        self.device = mesh.device
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
        (_, _, self._reset_step, self._gather_step,
         self._put_step, _) = build_mesh_steps(self.mesh, self.agg)
        self._merge_step = build_session_merge_step(self.mesh, self.agg)
        self._delta_fire_step = build_delta_fire_step(self.mesh, self.agg)
        self._exchange_scatter_step = build_exchange_scatter(
            self.mesh, self.agg)

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
        values = self.agg.map_input(batch)
        in_leaves = self.agg.input_leaves
        # claim a dispatch slot BEFORE rewriting the pooled staging
        # buffers: their previous reader must have finished
        self._await_dispatch_slot()
        self._shuffle_pool.flip()
        dst, staged, width = stage_device_exchange(
            rec_shards, self.P,
            columns=[np.asarray(rec_slots, dtype=np.int32),
                     *[np.asarray(v, dtype=l.dtype)
                       for v, l in zip(values, in_leaves)]],
            fills=[0, *[l.identity for l in in_leaves]],
            pool=self._shuffle_pool)
        with self._device_span():
            cols = [self._to_device(c) for c in (dst, *staged)]
            self.accs = self._exchange_scatter_step(
                self.accs, cols[0], cols[1], tuple(cols[2:]), width)
        # chaos: "crash mid-batch after the fused dispatch" — the scatter
        # is queued on the device, the host dies before the fence
        chaos.fault_point("shuffle.device_exchange", records=n)
        self._push_dispatch_fence()

    def _run_merge_group(self, g: MergeGroup) -> None:
        """Resolve a chain-free merge group's rows per shard (dst and src
        in ONE lookup, so both are resident together) and move their
        accumulators in one merge step over ``[P, M]`` blocks; then free
        the absorbed rows."""
        gk = np.asarray(g.keys_dst, dtype=np.int64)
        ds = np.asarray(g.sids_dst, dtype=np.int64)
        ss = np.asarray(g.sids_src, dtype=np.int64)
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
                if c:
                    fk.append(pairs[p][0][:c])
                    fs.append(pairs[p][1][:c])
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

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int,
                     async_ok: bool = False) -> List[object]:
        self._wd_boundary()
        with flight.fire_span(watermark):
            return self._on_watermark_inner(watermark, async_ok)

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
        if cold_chunks:
            cold_pos = np.concatenate(cold_chunks)
            finished = self.agg.finish(tuple(
                torch.from_numpy(np.concatenate(c)) for c in cold_vals))
            cold_out = {name: col.numpy() for name, col in finished.items()}
        else:
            cold_pos = None
            cold_out = {}
        out_idx = np.concatenate([s for s in per_shard_sel if len(s)])
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
        engines and mesh sizes (re-sharded by key group)."""
        return {"table": self._snapshot_table(mode), **self.meta.snapshot()}

    def restore(self, snap: Dict[str, object],
                key_group_filter=None) -> None:
        """Restore, re-sharding by key group: single-device
        ``SessionWindower`` snapshots and mesh snapshots of any size."""
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
        return SessionIntervalSet.filter_snapshot(snap, groups,
                                                  self.max_parallelism)

    def _merge_meta_snapshots(self, units):
        _NEG = -(1 << 62)
        sessions: Dict[int, list] = {}
        for u in units:
            for k, ivs in u.get("sessions", {}).items():
                sessions[int(k)] = list(ivs)  # the ranges are disjoint
        return {
            "sessions": sessions,
            "next_sid": max((int(u.get("next_sid", 1)) for u in units),
                            default=1),
            # the OLDEST unit's staleness horizon: its range's records
            # replay from its position and must not be judged stale
            "max_fired_watermark": min(
                (u.get("max_fired_watermark", _NEG) for u in units),
                default=_NEG),
        }

    # ---------------------------------------------------- not in this slice

    def register_hot_key(self, key_id: int, salts: int = 8,
                         allow_inexact: bool = False) -> int:
        raise _not_ported("hot-key splitting", "12g")

    def query_sessions(self, key_id: int):
        raise _not_ported("MeshSessionEngine.query_sessions", "12e")

    def query_batch(self, key_ids):
        raise _not_ported("MeshSessionEngine.query_batch", "12e")


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
