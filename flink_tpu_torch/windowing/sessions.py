"""Session windows over one device (port of
``flink_tpu/windowing/sessions.py``): merging windows with device
accumulators.

The reference's split, kept as it is: merge METADATA on the host, merged
STATE on the device.

- **Host**: per-key interval lists, a lazy fire heap and a session-id
  allocator — :class:`~flink_tpu_torch.windowing.session_meta.
  SessionIntervalSet`, or its native plane (``session_native.py``).
- **Device**: one accumulator row per live session in a ``SlotTable``.
  Records fold straight into their session's row (``flat_scatter_combine``:
  the ordered fold for float leaves); merging two sessions is
  ``flat_merge_pairs``, ``acc[dst] op= acc[src]`` with duplicate ``dst``
  (the ordered fold again), then the absorbed rows reset to identity.

A session [start, end) fires when watermark >= end - 1, with end = last
event + gap. With a device budget the table takes the paged spill layout
(eviction cohorts, ``state/paged_spill.py``) and frees by slot. A snapshot
is the table's logical rows plus the metadata's interval lists (the
reference's format); merged and fired sessions leave tombstones for
incremental snapshots.

Not in this slice: the point queries (ROADMAP.md Queue A item 12e),
raising ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.ops.segment_ops import pad_bucket_size, pad_i32
from flink_tpu_torch.state.slot_table import SlotTable, _not_ported
from flink_tpu_torch.stateplane.families import flat_merge_pairs
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.session_meta import MergeGroup, make_session_meta
from flink_tpu_torch.windowing.windower import (
    WINDOW_END_FIELD,
    WINDOW_START_FIELD,
)


class SessionWindower:
    """Keyed session windows over one device. ``spill``: the SlotTable's
    device and spill arguments (``device``, ``max_device_slots``,
    ``spill_dir``, ``spill_host_max_bytes``, ``spill_layout``)."""

    #: on_watermark(async_ok=True) may return PendingFire handles
    supports_async_fires = True

    def __init__(
        self,
        gap: int,
        agg: AggregateFunction,
        capacity: int = 1 << 16,
        max_parallelism: int = 128,
        allowed_lateness: int = 0,
        spill: dict = None,
    ) -> None:
        self.gap = int(gap)
        self.agg = agg
        # late records within the allowance start a NEW session (emitted as
        # an additional partial result), since fired sessions are freed at
        # once; records beyond it are dropped
        self.allowed_lateness = int(allowed_lateness)
        spill_kwargs = dict(spill or {})
        if spill_kwargs.get("max_device_slots"):
            # one row per namespace (sid): eviction moves cohorts of rows
            spill_kwargs.setdefault("spill_layout", "pages")
        if spill_kwargs.get("spill_layout", "pages") == "pages":
            # this windower frees by SLOT (free_rows,
            # free_index_only_slots): no per-namespace registry
            spill_kwargs.setdefault("track_namespaces", False)
        self.table = SlotTable(agg, capacity=capacity,
                               max_parallelism=max_parallelism,
                               **spill_kwargs)
        #: session-interval metadata: the native C sweep when it builds,
        #: else the pure-Python plane (bit-identical fires)
        self.meta = make_session_meta(self.gap, self.allowed_lateness)
        self._merge = flat_merge_pairs(agg.leaves)
        #: merge groups run, and the pairs of the largest
        self.merge_groups = 0
        self.merge_pairs_max = 0

    @property
    def late_records_dropped(self) -> int:
        return self.meta.late_records_dropped

    @property
    def max_fired_watermark(self) -> int:
        return self.meta.max_fired_watermark

    @property
    def sessions(self):
        return self.meta.sessions

    def spill_counters(self):
        """Paged spill traffic (pages and rows evicted and reloaded, rows
        compacted); zeros when the table is unbounded."""
        return self.table.spill_counters()

    def make_fence(self):
        return self.table.make_fence()

    # --------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        ts = np.asarray(batch.timestamps, dtype=np.int64)
        keys = np.asarray(batch.key_ids, dtype=np.int64)

        res = self.meta.absorb_batch_ex(keys, ts, want_fresh=False)
        sess_key, sess_sid = res.sess_key, res.sess_sid
        rec_to_sess, order = res.rec_to_sess, res.order
        # groups run one after another, in the metadata's order
        for g in res.groups:
            self._run_merge_group(g)

        live_sess = sess_sid >= 0
        if not live_sess.all():
            # stale-on-arrival sessions: their records go to slot 0
            starts_pos = np.nonzero(np.diff(rec_to_sess, prepend=-1) > 0)[0]
            sess_counts = np.diff(np.append(starts_pos, n))
            self.meta.late_records_dropped += int(
                sess_counts[~live_sess].sum())
        # ONE lookup for all session rows, then the records' fold; the
        # native plane's folded slots skip the hash probe where still valid
        m = len(sess_key)
        slot_of_sess = np.zeros(m, dtype=np.int32)
        if live_sess.any():
            slot_of_sess[live_sess] = self.table.lookup_or_insert(
                sess_key[live_sess], sess_sid[live_sess],
                hints=(None if res.slot_hint is None
                       else res.slot_hint[live_sess]))
            self.meta.note_slots(sess_key[live_sess], sess_sid[live_sess],
                                 slot_of_sess[live_sess],
                                 rows=(None if res.meta_row is None
                                       else res.meta_row[live_sess]))
        rec_slots = np.empty(n, dtype=np.int32)
        rec_slots[order] = slot_of_sess[rec_to_sess]
        self.table.scatter(rec_slots, self.agg.map_input(batch))

    def _run_merge_group(self, g: MergeGroup) -> None:
        """Resolve a chain-free merge group's rows and move their
        accumulators in one ``flat_merge_pairs``, then free the absorbed
        rows' index entries (the program reset their device values)."""
        dk = np.asarray(g.keys_dst, dtype=np.int64)
        ds = np.asarray(g.sids_dst, dtype=np.int64)
        sk = np.asarray(g.keys_src, dtype=np.int64)
        ss = np.asarray(g.sids_src, dtype=np.int64)
        # ONE combined lookup: with a spill tier a second lookup could
        # evict rows the first resolved — dst and src must be resident
        # together for the merge
        m = len(dk)
        self.merge_groups += 1
        self.merge_pairs_max = max(self.merge_pairs_max, m)
        both = self.table.lookup_or_insert(
            np.concatenate([dk, sk]), np.concatenate([ds, ss]))
        dst_slots, src_slots = both[:m], both[m:]
        size = pad_bucket_size(m)
        self.table.mark_dirty(dst_slots)
        self.table.mark_dirty(src_slots)
        table = self.table
        table.accs = self._merge(
            table.accs, table._to_device(pad_i32(dst_slots, size, fill=0)),
            table._to_device(pad_i32(src_slots, size, fill=0)))
        self.table.free_index_only_slots(src_slots, g.absorbed_sids)

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int,
                     async_ok: bool = False) -> List[RecordBatch]:
        pop = self.meta.pop_fired_ex(watermark)
        fired_keys, fired_starts = pop.keys, pop.starts
        fired_ends, fired_sids = pop.ends, pop.sids
        if not len(fired_keys):
            return []
        total = len(fired_keys)
        # with a device budget, a mass fire (end of stream) can exceed what
        # fits resident at once: fire in budget-sized chunks, freeing each
        # chunk's sessions before resolving the next
        chunk = total
        if self.table.max_device_slots:
            chunk = max(self.table.max_device_slots // 2, 1024)
        out: List[RecordBatch] = []
        for a in range(0, total, chunk):
            b = min(a + chunk, total)
            fired_slots = self.table.lookup_or_insert(
                np.asarray(fired_keys[a:b], dtype=np.int64),
                np.asarray(fired_sids[a:b], dtype=np.int64),
                hints=(None if pop.slot_hint is None
                       else pop.slot_hint[a:b]))
            matrix = np.asarray(fired_slots, dtype=np.int32)[:, None]
            cols = {
                KEY_ID_FIELD: np.asarray(fired_keys[a:b], dtype=np.int64),
                WINDOW_START_FIELD: np.asarray(fired_starts[a:b],
                                               dtype=np.int64),
                WINDOW_END_FIELD: np.asarray(fired_ends[a:b],
                                             dtype=np.int64),
                TIMESTAMP_FIELD: np.asarray(fired_ends[a:b],
                                            dtype=np.int64) - 1,
            }
            if async_ok:
                # dispatch the fire and free the sessions at once: the
                # reset is queued BEHIND the fire's gather and its copies
                # on the same stream, so the deferred host read never
                # sees a reset row
                pending = self.table.fire_async(matrix, None)
                self.table.free_rows(fired_slots, fired_sids[a:b])
                if pending is None:
                    continue
                inner = pending.build

                def build(host, inner=inner, cols=cols):
                    _, results = inner(host)
                    full = dict(cols)
                    full.update(results)
                    return RecordBatch(full)

                pending.build = build
                out.append(pending)
                continue
            results = self.table.fire(matrix)
            self.table.free_rows(fired_slots, fired_sids[a:b])
            cols.update(results)
            out.append(RecordBatch(cols))
        return out

    # ------------------------------------------------------------- snapshot

    def snapshot(self, mode: str = "full") -> Dict[str, object]:
        """mode: "full" (a new incremental base), "delta" (dirty rows and
        tombstones), "savepoint" (full, keeping the dirty tracking)."""
        if mode == "delta":
            table = self.table.snapshot_delta()
        else:
            table = self.table.snapshot(reset_dirty=(mode != "savepoint"))
        return {"table": table, **self.meta.snapshot()}

    def restore(self, snap: Dict[str, object], key_group_filter=None) -> None:
        if "table" in snap:
            self.table.restore(snap["table"],
                               key_group_filter=key_group_filter)
        self.meta.restore(snap, key_group_filter=key_group_filter,
                          max_parallelism=self.table.max_parallelism)

    # ---------------------------------------------------- not in this slice

    def query_sessions_batch(self, key_ids):
        raise _not_ported("SessionWindower.query_sessions_batch", "12e")

    def query_sessions(self, key_id: int):
        raise _not_ported("SessionWindower.query_sessions", "12e")

