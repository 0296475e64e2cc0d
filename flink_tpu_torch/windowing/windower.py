"""Slice-shared window engine (port of ``SliceSharedWindower`` in
``flink_tpu/windowing/windower.py``): host-side control, device-side math.

A ``WindowAssigner`` maps timestamps to slices and windows to slices; a
``SlotTable`` keeps one accumulator row per (key, slice) on the device.

- ``process_batch``: vectorized slice assignment, late-record drop, slot
  lookup, one fold per accumulator leaf.
- ``on_watermark``: fire every pending window with end - 1 <= watermark —
  its ``[keys, slices]`` slot matrix built on the host, one gather, merge,
  finish (and projection) program on the device — then free the slices
  whose last window fired.

Window lifecycle metadata lives in ``SliceBookkeeper`` (shared with the
mesh engine). Not in this slice: ``PaneWindower`` and the fused ingest
of its table (the pane layout, ROADMAP.md Queue A item 6),
``compose_windows`` and the point queries (item 12), snapshots (item 8).
"""

from __future__ import annotations

from typing import List

import numpy as np

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.runtime.local_agg import (
    is_partial_batch,
    partial_leaf_values,
)
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.bookkeeping import SliceBookkeeper

WINDOW_START_FIELD = "window_start"
WINDOW_END_FIELD = "window_end"


class SliceSharedWindower:
    """Windowed keyed aggregation over one device. ``spill``: the
    SlotTable's device and spill arguments (``device``,
    ``max_device_slots``, ``spill_dir``, ``spill_host_max_bytes``)."""

    #: on_watermark(async_ok=True) may return PendingFire handles (the
    #: hosting operator owns their harvest and the watermark holdback)
    supports_async_fires = True

    def __init__(
        self,
        assigner: WindowAssigner,
        agg: AggregateFunction,
        capacity: int = 1 << 16,
        max_parallelism: int = 128,
        allowed_lateness: int = 0,
        spill: dict = None,
        fire_projector=None,
    ) -> None:
        from flink_tpu_torch.state.slot_table import SlotTable

        self.assigner = assigner
        self.agg = agg
        self.table = SlotTable(agg, capacity=capacity,
                               max_parallelism=max_parallelism,
                               **(spill or {}))
        self.book = SliceBookkeeper(assigner, allowed_lateness)
        #: optional device-side reduction of each fired window's rows
        self.fire_projector = fire_projector

    @property
    def late_records_dropped(self) -> int:
        return self.book.late_records_dropped

    def spill_counters(self):
        return self.table.spill_counters()

    def make_fence(self):
        return self.table.make_fence()

    # --------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        slice_ends = self.assigner.assign_slice_ends(batch.timestamps)
        live = self.book.live_mask(slice_ends)
        if live is not None:
            slice_ends = slice_ends[live]
            batch = batch.filter(live)
            if len(batch) == 0:
                return
        # one O(n) pass finds the distinct slice ends for the bookkeeper
        uniq, _ = self.assigner.slice_plan(slice_ends)
        self.book.register_slices(slice_ends, uniq=uniq)
        if is_partial_batch(batch):
            # locally pre-aggregated rows: fold explicit per-leaf partials
            self.table.upsert_valued(batch.key_ids, slice_ends,
                                     partial_leaf_values(batch, self.agg))
        else:
            self.table.upsert(batch.key_ids, slice_ends,
                              self.agg.map_input(batch))

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int,
                     async_ok: bool = False) -> List[object]:
        """Fire all windows with end - 1 <= watermark: result batches, or
        with ``async_ok`` PendingFire handles whose harvest yields them.
        Slice frees dispatched after the fires run behind them on the
        device's stream, so a deferred host read never races a reset."""
        out: List[object] = []
        while True:
            w_end = self.book.next_window(watermark)
            if w_end is None:
                break
            batch = self._fire_window(w_end, async_ok=async_ok)
            if batch is not None and (not hasattr(batch, "__len__")
                                      or len(batch) > 0):
                out.append(batch)
            self.book.mark_fired(w_end)
        expired = self.book.expired_slices(watermark)
        if expired:
            self.table.free_namespaces(expired)
        return out

    def _columns(self, window_end: int, keys: np.ndarray,
                 results) -> RecordBatch:
        m = len(keys)
        cols = {
            KEY_ID_FIELD: keys,
            WINDOW_START_FIELD: np.full(
                m, self.assigner.window_start(window_end), dtype=np.int64),
            WINDOW_END_FIELD: np.full(m, window_end, dtype=np.int64),
            TIMESTAMP_FIELD: np.full(m, window_end - 1, dtype=np.int64),
        }
        cols.update(results)
        return RecordBatch(cols)

    def _wrap_pending(self, pending, window_end: int):
        """The table's PendingFire (keys, result columns) with the window
        columns added at harvest."""
        if pending is None:
            return None
        inner = pending.build

        def build(host):
            keys, results = inner(host)
            if len(keys) == 0:
                return None
            return self._columns(window_end, keys, results)

        pending.build = build
        return pending

    def _fire_window(self, window_end: int, async_ok: bool = False):
        slice_ends = self.assigner.slice_ends_for_window(window_end)
        if any(int(se) in self.table.spill for se in slice_ends):
            # hybrid fire: resident slices merge on the device, spilled
            # ones on the host — the device budget does not depend on the
            # window's slice count
            keys, results = self.table.fire_hybrid(
                [int(se) for se in slice_ends])
            if len(keys) == 0:
                return None
            if self.fire_projector is not None:
                keys, results = self.fire_projector.project_host(
                    keys, results)
            return self._columns(window_end, keys, results)
        if len(slice_ends) == 1:
            # single-slice (tumbling) fast path: no cross-slice grouping
            slots = self.table.slots_for_namespace(slice_ends[0])
            if len(slots) == 0:
                return None
            keys = self.table.keys_of_slots(slots)
            matrix = slots[:, None].astype(np.int32)
        else:
            keys, matrix = self.table.build_slice_matrix(
                [int(se) for se in slice_ends])
            if keys is None:
                return None
        if self.fire_projector is not None:
            if async_ok:
                return self._wrap_pending(
                    self.table.fire_projected_async(
                        matrix, keys, self.fire_projector), window_end)
            keys, results = self.table.fire_projected(
                matrix, keys, self.fire_projector)
        else:
            if async_ok:
                return self._wrap_pending(
                    self.table.fire_async(matrix, keys), window_end)
            results = self.table.fire(matrix)
        return self._columns(window_end, keys, results)
