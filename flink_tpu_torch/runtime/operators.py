"""Stream operators (port of ``flink_tpu/runtime/operators.py``): map,
filter, flat_map, union, keyBy, the sink, the keyed window aggregation
(event time, or processing time: records stamped with their arrival time,
windows fired by the executor's wall-clock ticks) and the keyed
session-window aggregation.

An operator processes one ``RecordBatch`` per call and reacts to watermark
advances; all operators are single-owner (called from one task loop).
User functions are vectorized: a map takes and returns a RecordBatch.
Stateful operators snapshot into (and restore from) the reference's
checkpoint state dicts.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.runtime.pending import PendingFire
from flink_tpu_torch.state.keygroups import hash_keys_to_i64
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner


def _reject_backend_on_mesh(backend: str) -> None:
    """The reference's refusal, with its message: a placement backend
    cannot apply to mesh-sharded state."""
    if backend not in ("tpu-slot-table",):
        raise ValueError(
            f"state.backend={backend!r} is not supported "
            "at operator parallelism > 1: mesh-sharded state is "
            "placed by the device mesh itself. Use the default "
            "'tpu-slot-table' backend, or run placement-backed "
            "state at parallelism 1 / stage-parallel subtasks "
            "(execution.stage-parallelism), where each subtask owns "
            "a single-device engine that honors the placement")


def _placement(ctx):
    """The device a parallelism-1 engine's state lives on: the
    ``state.backend`` placement (state/backends.py) of the job's
    ``execution.device``."""
    from flink_tpu_torch.state.backends import resolve_placement

    return resolve_placement(ctx.state_backend, ctx.device)


class Operator:
    """Base operator. Subclasses override the hooks they need."""

    name: str = "operator"

    def open(self, ctx: "OperatorContext") -> None:
        pass

    def process_batch(self, batch: RecordBatch, input_index: int = 0
                      ) -> List[RecordBatch]:
        raise NotImplementedError

    def process_watermark(self, watermark: int, input_index: int = 0
                          ) -> List[RecordBatch]:
        return []

    def close(self) -> List[RecordBatch]:
        return []

    def dispose(self) -> None:
        """Release resources without emitting (failure path)."""

    def has_pending_output(self) -> bool:
        return False

    def poll_pending_output(self, wait: bool = False) -> List[RecordBatch]:
        return []

    # checkpointing
    def snapshot_state(self) -> Optional[Dict[str, Any]]:
        return None

    def restore_state(self, state: Dict[str, Any]) -> None:
        pass


class OperatorContext:
    """Per-operator runtime context."""

    def __init__(self, parallelism: int = 1, max_parallelism: int = 128,
                 async_fires: bool = False, max_dispatch_ahead: int = 4,
                 shuffle_mode: str = "device", device=None,
                 operator_index: int = 0, window_layout: str = "auto",
                 state_backend: str = "tpu-slot-table",
                 spill: Optional[dict] = None, pane_preagg: bool = True,
                 watchdog=None, memory_manager=None,
                 key_group_range: Optional[tuple] = None):
        self.operator_index = operator_index
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        #: the hosting executor harvests deferred fires and holds back
        #: watermarks while they are in flight
        self.async_fires = async_fires
        #: per-batch fence depth (execution.pipeline.max-dispatch-batches)
        self.max_dispatch_ahead = max_dispatch_ahead
        #: keyBy data plane for the mesh engine (shuffle.mode)
        self.shuffle_mode = shuffle_mode
        #: execution.device — resolved (and refused without a card) when
        #: a device-backed operator opens
        self.device = device
        #: state.window-layout and state.backend (parallelism 1)
        self.window_layout = window_layout
        self.state_backend = state_backend
        #: the spill tier's options (state.slot-table.max-device-slots,
        #: state.spill.dir, state.spill.host-max-bytes)
        self.spill = dict(spill or {})
        #: latency.pane-preagg: per-window running partials in the pane
        #: layout
        self.pane_preagg = pane_preagg
        #: the job's DeviceWatchdog (watchdog.enabled), attached to every
        #: mesh engine the operators open; None when disabled
        self.watchdog = watchdog
        #: the job's managed device-memory pool (memory.device.size > 0)
        self.memory_manager = memory_manager
        #: (first, last) key groups a stage subtask owns: its mesh engine
        #: spreads them over its shards; None = all of them
        self.key_group_range = key_group_range


class MapOperator(Operator):
    name = "map"

    def __init__(self, fn: Callable[[RecordBatch], RecordBatch]):
        self.fn = fn

    def process_batch(self, batch, input_index=0):
        out = self.fn(batch)
        return [out] if out is not None and len(out) else []


class FilterOperator(Operator):
    name = "filter"

    def __init__(self, predicate: Callable[[RecordBatch], np.ndarray]):
        self.predicate = predicate

    def process_batch(self, batch, input_index=0):
        mask = np.asarray(self.predicate(batch), dtype=bool)
        out = batch.filter(mask)
        return [out] if len(out) else []


class FlatMapOperator(Operator):
    name = "flat_map"

    def __init__(self, fn: Callable[[RecordBatch], List[RecordBatch]]):
        self.fn = fn

    def process_batch(self, batch, input_index=0):
        return [b for b in self.fn(batch) if b is not None and len(b)]


class UnionOperator(Operator):
    """Pass-through merge of several inputs; the watermark is the minimum
    over the inputs (the executor's valve). In the DataStream API timed
    and untimed inputs may mix: nothing checks event time until a window
    does. SQL UNION ALL sets ``require_consistent_time``: its output feeds
    relational operators, so a timed/untimed mix fails here with the
    cause."""

    name = "union"

    def __init__(self, require_consistent_time: bool = False):
        self._require_consistent_time = require_consistent_time
        self._timed: Optional[bool] = None

    def process_batch(self, batch, input_index=0):
        if self._require_consistent_time:
            timed = batch.has_timestamps
            if self._timed is None:
                self._timed = timed
            elif timed != self._timed:
                raise RuntimeError(
                    "union inputs disagree on event time: some carry "
                    "timestamps and some do not — assign timestamps on "
                    "every branch (or none)")
        return [batch]


class KeyByOperator(Operator):
    """Attaches the int64 key identity column (``__key_id__``); routing by
    key group happens in the keyed engine's exchange."""

    name = "key_by"

    def __init__(self, key_field: str):
        self.key_field = key_field

    def process_batch(self, batch, input_index=0):
        key_ids = hash_keys_to_i64(batch[self.key_field])
        return [batch.with_column(KEY_ID_FIELD, key_ids)]


class WindowAggOperator(Operator):
    """keyBy -> window -> aggregate: at parallelism 1 on the single-device
    slot table (``SliceSharedWindower``), above it on the mesh window
    engine."""

    name = "window_agg"

    def __init__(self, assigner: WindowAssigner, agg: AggregateFunction,
                 key_field: str, capacity: int = 1 << 16,
                 allowed_lateness: int = 0, fire_projector=None):
        self.assigner = assigner
        self.agg = agg
        self.key_field = key_field
        self.capacity = capacity
        self.allowed_lateness = allowed_lateness
        self.fire_projector = fire_projector
        #: processing-time assigner: records are stamped with their
        #: wall-clock arrival time and fires come from the executor's
        #: ticks (on_processing_time)
        self.uses_processing_time = bool(
            getattr(assigner, "is_processing_time", False))
        self.windower = None
        #: key_id -> original key value, for non-integer keys
        self._key_values: Dict[int, Any] = {}
        self._keys_hashed = False
        #: wall-clock ms from watermark advance to fired results on host
        #: (bounded reservoir)
        self.fire_latencies_ms = deque(maxlen=8192)
        self.fires_total = 0
        self._pending: deque = deque()
        self._async_fires = False
        #: bound on in-flight fires (the oldest is harvested beyond it)
        self._max_pending = 32
        #: per-batch fences bounding how far the host runs ahead
        self._fences: deque = deque()
        self._max_dispatch_ahead = 4

    def open(self, ctx):
        if ctx.parallelism > 1:
            _reject_backend_on_mesh(ctx.state_backend)
            from flink_tpu_torch.parallel.mesh import make_mesh
            from flink_tpu_torch.parallel.sharded_windower import (
                MeshWindowEngine,
            )

            self.windower = MeshWindowEngine(
                self.assigner, self.agg,
                make_mesh(ctx.parallelism, ctx.device),
                capacity_per_shard=self.capacity,
                max_parallelism=ctx.max_parallelism,
                allowed_lateness=self.allowed_lateness,
                fire_projector=self.fire_projector,
                max_device_slots=ctx.spill.get("max_device_slots", 0),
                spill_dir=ctx.spill.get("spill_dir"),
                spill_host_max_bytes=ctx.spill.get(
                    "spill_host_max_bytes", 0),
                key_group_range=ctx.key_group_range,
                max_dispatch_ahead=ctx.max_dispatch_ahead,
                shuffle_mode=ctx.shuffle_mode,
                memory=self._managed_memory(ctx))
        else:
            self.windower = self._open_single_device(ctx)
        self._attach_watchdog(ctx)
        self._async_fires = bool(ctx.async_fires)
        self._max_dispatch_ahead = int(ctx.max_dispatch_ahead)

    def _managed_memory(self, ctx):
        """(MemoryManager, unique owner) for device-state accounting, or
        None when no budget is configured (core/memory.py)."""
        mm = ctx.memory_manager
        return None if mm is None else (mm, f"{self.name}#{id(self):x}")

    def _table_spill(self, ctx) -> dict:
        """The P=1 slot table's keyword arguments."""
        spill = {**ctx.spill, "device": _placement(ctx)}
        if ctx.memory_manager is not None:
            spill["memory"] = self._managed_memory(ctx)
        return spill

    @property
    def late_records_dropped(self) -> int:
        """Records dropped as late (the numLateRecordsDropped gauge)."""
        return self.windower.late_records_dropped

    def _attach_watchdog(self, ctx) -> None:
        """watchdog.enabled: the job's watchdog times the mesh engine's
        device sections and probes its shards at batch boundaries."""
        wd = getattr(ctx, "watchdog", None)
        if wd is not None and hasattr(self.windower, "attach_watchdog"):
            self.windower.attach_watchdog(wd)

    def _open_single_device(self, ctx):
        """Parallelism 1: state.window-layout 'auto' and 'slots' run the
        slot table (the reference's 'auto' resolves to it too), 'panes'
        the pane layout, for aligned windows without a spill tier."""
        from flink_tpu_torch.windowing.windower import (
            PaneWindower,
            SliceSharedWindower,
        )

        if ctx.window_layout not in ("auto", "slots", "panes"):
            raise ValueError(f"state.window-layout must be 'auto', 'slots' "
                             f"or 'panes', got {ctx.window_layout!r}")
        if ctx.window_layout == "panes":
            if any(ctx.spill.values()):
                raise ValueError(
                    "state.window-layout=panes has no spill tier — use "
                    "'slots' (or 'auto') with state.spill.* options")
            if ctx.state_backend != "tpu-slot-table":
                raise ValueError(
                    "state.window-layout=panes supports only the default "
                    "placement; state.backend placements (host-heap) use "
                    "the slot layout")
            return PaneWindower(
                self.assigner, self.agg, capacity=self.capacity,
                max_parallelism=ctx.max_parallelism,
                allowed_lateness=self.allowed_lateness,
                fire_projector=self.fire_projector,
                preagg=ctx.pane_preagg, device=ctx.device,
                memory=self._managed_memory(ctx))
        return SliceSharedWindower(
            self.assigner, self.agg, capacity=self.capacity,
            max_parallelism=ctx.max_parallelism,
            allowed_lateness=self.allowed_lateness,
            spill=self._table_spill(ctx),
            fire_projector=self.fire_projector)

    def spill_counters(self) -> Optional[Dict[str, int]]:
        """The engine's spill traffic counters (None when it has none)."""
        fn = getattr(self.windower, "spill_counters", None)
        return fn() if fn is not None else None

    def shard_resident_rows(self) -> List[int]:
        """Resident rows per shard (one entry for single-device engines)."""
        fn = getattr(self.windower, "shard_resident_rows", None)
        if fn is not None:
            return fn()
        index = getattr(getattr(self.windower, "table", None), "index",
                        None)
        return [int(index.slot_used.sum())] if index is not None else []

    def process_batch(self, batch, input_index=0):
        keys = batch[self.key_field]
        if keys.dtype.kind not in "iu":
            # remember original key values for emission
            self._keys_hashed = True
            uniq, first = np.unique(batch.key_ids, return_index=True)
            for i, j in zip(uniq.tolist(), first.tolist()):
                self._key_values.setdefault(i, keys[j])
        if self.uses_processing_time:
            # arrival time IS the record time in the processing-time
            # domain: a whole micro-batch arrives at one instant
            now = int(time.time() * 1000)
            batch = batch.with_timestamps(
                np.full(len(batch), now, dtype=np.int64))
        elif not batch.has_timestamps:
            raise RuntimeError(
                f"event-time window {self.name!r} received records without "
                "timestamps — assign a WatermarkStrategy / timestamp_field "
                "on every input (or use a processing-time window)")
        self.windower.process_batch(batch)
        if self._async_fires:
            self._fences.append(self.windower.make_fence())
            while len(self._fences) > self._max_dispatch_ahead:
                self._fences.popleft().block_until_ready()
        return []

    def process_watermark(self, watermark, input_index=0):
        if self.uses_processing_time and watermark < MAX_WATERMARK:
            # event-time watermarks do not drive processing-time windows;
            # only the end-of-input MAX flushes what remains
            return []
        t0 = time.perf_counter()
        fired = self.windower.on_watermark(watermark,
                                           async_ok=self._async_fires)
        outs = []
        fired_sync = False
        for b in fired:
            if isinstance(b, PendingFire):
                self._pending.append(b)
            else:
                fired_sync = True
                outs.append(self._reattach_keys(b))
        if fired_sync:
            self.fire_latencies_ms.append((time.perf_counter() - t0) * 1e3)
            self.fires_total += 1
        while len(self._pending) > self._max_pending:
            outs.extend(self._harvest_one())
        return outs

    def has_pending_output(self) -> bool:
        return bool(self._pending)

    def poll_pending_output(self, wait: bool = False):
        outs = []
        while self._pending:
            if not wait and not self._pending[0].ready():
                break
            outs.extend(self._harvest_one())
        return outs

    def _harvest_one(self) -> List[RecordBatch]:
        pf = self._pending.popleft()
        batch = pf.harvest()
        # fire latency = watermark advance (dispatch) -> results on host
        self.fire_latencies_ms.append(
            (time.perf_counter() - pf.dispatched_at) * 1e3)
        self.fires_total += 1
        if batch is None or len(batch) == 0:
            return []
        return [self._reattach_keys(batch)]

    def on_processing_time(self, now_ms: int) -> List[RecordBatch]:
        """The executor's wall-clock tick (processing-time windows only):
        window [start, end) is complete once the clock passes its end.
        Fired synchronously."""
        return [self._reattach_keys(b)
                for b in self.windower.on_watermark(now_ms - 1)]

    def _reattach_keys(self, batch: RecordBatch) -> RecordBatch:
        kid = batch.key_ids
        if self._keys_hashed:
            vals = np.empty(len(kid), dtype=object)
            vals[:] = [self._key_values.get(int(k)) for k in kid]
        else:
            vals = kid
        return batch.with_column(self.key_field, vals)

    def dispose(self):
        self._pending.clear()
        self._fences.clear()
        release = getattr(self.windower, "release_memory", None)
        if release is None:
            release = getattr(getattr(self.windower, "table", None),
                              "release_memory", None)
        if release is not None:
            release()

    # ---------------------------------------------------------- checkpoints

    def _check_no_pending(self) -> None:
        # the executor drains (and forwards) in-flight fires before a
        # snapshot: dropping them here would lose windows the bookkeeper
        # already marked fired
        if self._pending:
            raise RuntimeError(
                "snapshot with in-flight async fires; the executor must "
                "drain pending outputs (poll_pending_output(wait=True)) "
                "before snapshotting")

    def _state(self, mode: str) -> Dict[str, Any]:
        self._check_no_pending()
        return {
            "windower": self.windower.snapshot(mode=mode),
            "key_values": dict(self._key_values),
            "keys_hashed": self._keys_hashed,
        }

    def snapshot_state(self):
        return self._state("full")

    def snapshot_state_delta(self):
        """Incremental: the keyed table ships only dirty rows and
        tombstones; the host metadata is small and written full."""
        return self._state("delta")

    def snapshot_state_savepoint(self):
        """Full state that keeps the incremental dirty tracking: a
        savepoint must not change what the next delta contains."""
        return self._state("savepoint")

    def restore_state(self, state, key_group_filter=None):
        self.windower.restore(state["windower"],
                              key_group_filter=key_group_filter)
        # empty sub-dicts are pruned by the checkpoint codec
        self._key_values = dict(state.get("key_values", {}))
        self._keys_hashed = state.get("keys_hashed", False)


class SessionWindowAggOperator(WindowAggOperator):
    """Merging session windows: the key reattachment, fire latency and
    async-fire plumbing of WindowAggOperator over a ``SessionWindower``
    (``windowing/sessions.py``) at parallelism 1, and above it over the
    mesh session engine (``parallel/sharded_sessions.py``) on a logical
    mesh of ``parallelism`` shards on ``ctx.device`` — never parallelism 1
    instead."""

    name = "session_window_agg"

    def __init__(self, gap: int, agg: AggregateFunction, key_field: str,
                 capacity: int = 1 << 16, allowed_lateness: int = 0):
        super().__init__(assigner=None, agg=agg, key_field=key_field,
                         capacity=capacity,
                         allowed_lateness=allowed_lateness)
        self.gap = gap

    def open(self, ctx):
        if ctx.parallelism > 1:
            self.windower = self._open_mesh(ctx)
        else:
            from flink_tpu_torch.windowing.sessions import SessionWindower

            self.windower = SessionWindower(
                self.gap, self.agg, capacity=self.capacity,
                max_parallelism=ctx.max_parallelism,
                allowed_lateness=self.allowed_lateness,
                spill=self._table_spill(ctx))
        self._attach_watchdog(ctx)
        self._async_fires = bool(ctx.async_fires)
        self._max_dispatch_ahead = int(ctx.max_dispatch_ahead)

    def _open_mesh(self, ctx):
        """The mesh session engine. ``state.slot-table.capacity`` and
        ``state.slot-table.max-device-slots`` are PER SHARD here (the
        reference's budget is per device; on the logical mesh every shard
        has its own, as ``tools/bench_mesh_sessions.py`` passes it); a
        budget selects the paged spill tier. Dispatch-ahead follows
        ``execution.pipeline.max-dispatch-batches``."""
        _reject_backend_on_mesh(ctx.state_backend)
        from flink_tpu_torch.parallel.mesh import make_mesh
        from flink_tpu_torch.parallel.sharded_sessions import (
            MeshSessionEngine,
        )

        return MeshSessionEngine(
            self.gap, self.agg, make_mesh(ctx.parallelism, ctx.device),
            capacity_per_shard=self.capacity,
            max_parallelism=ctx.max_parallelism,
            allowed_lateness=self.allowed_lateness,
            max_device_slots=ctx.spill.get("max_device_slots", 0),
            spill_dir=ctx.spill.get("spill_dir"),
            spill_host_max_bytes=ctx.spill.get("spill_host_max_bytes", 0),
            key_group_range=ctx.key_group_range,
            memory=self._managed_memory(ctx),
            max_dispatch_ahead=ctx.max_dispatch_ahead,
            shuffle_mode=ctx.shuffle_mode)


class SinkOperator(Operator):
    """Owns the sink lifecycle: open on task start, close on drain."""

    name = "sink"

    def __init__(self, sink):
        self.sink = sink

    def open(self, ctx):
        self.sink.open(ctx.operator_index)

    def process_batch(self, batch, input_index=0):
        self.sink.write(batch)
        return []

    def snapshot_state(self):
        # sinks with writer state take part in checkpoints
        snap = getattr(self.sink, "snapshot_state", None)
        return snap() if snap else None

    def restore_state(self, state, key_group_filter=None):
        restore = getattr(self.sink, "restore_state", None)
        if restore:
            restore(state)

    def close(self):
        self.sink.close()
        return []

    def dispose(self):
        self.sink.close()

