"""Stream operators (port of the Q5 and session operators of
``flink_tpu/runtime/operators.py``): map, keyBy, the sink, the keyed
window aggregation and the keyed session-window aggregation.

An operator processes one ``RecordBatch`` per call and reacts to watermark
advances; all operators are single-owner (called from one task loop).
User functions are vectorized: a map takes and returns a RecordBatch.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
from flink_tpu_torch.runtime.pending import PendingFire
from flink_tpu_torch.state.keygroups import hash_keys_to_i64
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner


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


class OperatorContext:
    """Per-operator runtime context."""

    def __init__(self, parallelism: int = 1, max_parallelism: int = 128,
                 async_fires: bool = False, max_dispatch_ahead: int = 4,
                 shuffle_mode: str = "device", device=None,
                 operator_index: int = 0, window_layout: str = "auto",
                 state_backend: str = "tpu-slot-table",
                 spill: Optional[dict] = None, pane_preagg: bool = True):
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


class MapOperator(Operator):
    name = "map"

    def __init__(self, fn: Callable[[RecordBatch], RecordBatch]):
        self.fn = fn

    def process_batch(self, batch, input_index=0):
        out = self.fn(batch)
        return [out] if out is not None and len(out) else []


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
            if ctx.state_backend != "tpu-slot-table":
                raise ValueError(
                    f"state.backend={ctx.state_backend!r} is not supported "
                    "at operator parallelism > 1: mesh-sharded state is "
                    "placed by the device mesh itself")
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
                max_dispatch_ahead=ctx.max_dispatch_ahead,
                shuffle_mode=ctx.shuffle_mode)
        else:
            self.windower = self._open_single_device(ctx)
        self._async_fires = bool(ctx.async_fires)
        self._max_dispatch_ahead = int(ctx.max_dispatch_ahead)

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
                    "placement; state.backend placements use the slot "
                    "layout")
            return PaneWindower(
                self.assigner, self.agg, capacity=self.capacity,
                max_parallelism=ctx.max_parallelism,
                allowed_lateness=self.allowed_lateness,
                fire_projector=self.fire_projector,
                preagg=ctx.pane_preagg, device=ctx.device)
        if ctx.state_backend != "tpu-slot-table":
            raise NotImplementedError(
                f"state.backend={ctx.state_backend!r}: placement backends "
                "are not ported to flink_tpu_torch yet (ROADMAP.md, Queue A "
                "item 11); the default 'tpu-slot-table' keeps the state on "
                "execution.device")
        return SliceSharedWindower(
            self.assigner, self.agg, capacity=self.capacity,
            max_parallelism=ctx.max_parallelism,
            allowed_lateness=self.allowed_lateness,
            spill={**ctx.spill, "device": ctx.device},
            fire_projector=self.fire_projector)

    def spill_counters(self) -> Optional[Dict[str, int]]:
        """The engine's spill traffic counters (None when it has none)."""
        fn = getattr(self.windower, "spill_counters", None)
        return fn() if fn is not None else None

    def process_batch(self, batch, input_index=0):
        keys = batch[self.key_field]
        if keys.dtype.kind not in "iu":
            # remember original key values for emission
            self._keys_hashed = True
            uniq, first = np.unique(batch.key_ids, return_index=True)
            for i, j in zip(uniq.tolist(), first.tolist()):
                self._key_values.setdefault(i, keys[j])
        if not batch.has_timestamps:
            raise RuntimeError(
                f"event-time window {self.name!r} received records without "
                "timestamps — assign a WatermarkStrategy / timestamp_field")
        self.windower.process_batch(batch)
        if self._async_fires:
            self._fences.append(self.windower.make_fence())
            while len(self._fences) > self._max_dispatch_ahead:
                self._fences.popleft().block_until_ready()
        return []

    def process_watermark(self, watermark, input_index=0):
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

            if ctx.state_backend != "tpu-slot-table":
                raise NotImplementedError(
                    f"state.backend={ctx.state_backend!r}: placement "
                    "backends are not ported to flink_tpu_torch yet "
                    "(ROADMAP.md, Queue A item 11)")
            self.windower = SessionWindower(
                self.gap, self.agg, capacity=self.capacity,
                max_parallelism=ctx.max_parallelism,
                allowed_lateness=self.allowed_lateness,
                spill={**ctx.spill, "device": ctx.device})
        self._async_fires = bool(ctx.async_fires)
        self._max_dispatch_ahead = int(ctx.max_dispatch_ahead)

    def _open_mesh(self, ctx):
        """The mesh session engine. ``state.slot-table.capacity`` and
        ``state.slot-table.max-device-slots`` are PER SHARD here (the
        reference's budget is per device; on the logical mesh every shard
        has its own, as ``tools/bench_mesh_sessions.py`` passes it); a
        budget selects the paged spill tier. Dispatch-ahead follows
        ``execution.pipeline.max-dispatch-batches``."""
        if ctx.state_backend != "tpu-slot-table":
            raise ValueError(
                f"state.backend={ctx.state_backend!r} is not supported at "
                "operator parallelism > 1: mesh-sharded state is placed "
                "by the device mesh itself")
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

    def close(self):
        self.sink.close()
        return []

    def dispose(self):
        self.sink.close()

