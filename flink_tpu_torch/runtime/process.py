"""Process functions: the low-level user API with keyed state, timers and
side outputs (port of ``flink_tpu/runtime/process.py``).

A process function sees whole RecordBatches; timers are registered as
arrays of (key id, timestamp) pairs, one heap per time domain with dedup
and lazy deletion, and ``on_timer`` receives every timer a watermark (or
the processing-time clock) makes due as one batch, in (timestamp, key id)
order. Keyed state handles are the vectorized states of
``state/keyed_state.py`` on a ``KeyedStateStore`` whose device is the
operator's ``execution.device`` (where ``DeviceValueStateDescriptor``
states keep their values); ``ctx.async_state`` gives their
StateFuture-returning views (``state/async_state.py``).
"""

from __future__ import annotations

import dataclasses
import heapq
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.annotations import public
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.elements import MIN_WATERMARK
from flink_tpu_torch.runtime.operators import Operator
from flink_tpu_torch.state.keyed_state import KeyedStateStore


@public
@dataclasses.dataclass(frozen=True)
class OutputTag:
    """Names a side output (reference: flink-core/.../util/OutputTag.java)."""

    name: str


@dataclasses.dataclass(frozen=True)
class TaggedBatch:
    """A batch routed to a side output instead of the main output."""

    tag: OutputTag
    batch: RecordBatch


class TimerService:
    """Keyed timers, both time domains.

    reference: InternalTimerServiceImpl.java keeps two key-grouped priority
    queues (:53-58) and fires event-time timers on advanceWatermark (:314).
    Here one binary heap per domain holds (timestamp, key_id) pairs with a
    set for dedup (registering the same (key, ts) twice fires once — the
    reference's timer semantics).
    """

    def __init__(self, clock: Callable[[], int] = None):
        self._event: List[Tuple[int, int]] = []
        self._event_set: set = set()
        self._proc: List[Tuple[int, int]] = []
        self._proc_set: set = set()
        self.current_watermark = MIN_WATERMARK
        self.clock = clock or (lambda: int(_time.time() * 1000))

    # -- registration (vectorized) ------------------------------------------

    def register_event_time_timers(self, key_ids, timestamps) -> None:
        for k, t in zip(np.atleast_1d(np.asarray(key_ids)).tolist(),
                        np.atleast_1d(np.asarray(timestamps)).tolist()):
            pair = (int(t), int(k))
            if pair not in self._event_set:
                self._event_set.add(pair)
                heapq.heappush(self._event, pair)

    def register_processing_time_timers(self, key_ids, timestamps) -> None:
        for k, t in zip(np.atleast_1d(np.asarray(key_ids)).tolist(),
                        np.atleast_1d(np.asarray(timestamps)).tolist()):
            pair = (int(t), int(k))
            if pair not in self._proc_set:
                self._proc_set.add(pair)
                heapq.heappush(self._proc, pair)

    def delete_event_time_timers(self, key_ids, timestamps) -> None:
        # lazy deletion: drop from the dedup set; heap entries are skipped
        # at fire time (the reference eagerly removes; lazy keeps O(1))
        for k, t in zip(np.atleast_1d(np.asarray(key_ids)).tolist(),
                        np.atleast_1d(np.asarray(timestamps)).tolist()):
            self._event_set.discard((int(t), int(k)))

    # -- firing --------------------------------------------------------------

    @staticmethod
    def _pop_due(heap, dedup, bound) -> Tuple[np.ndarray, np.ndarray]:
        keys, tss = [], []
        while heap and heap[0][0] <= bound:
            t, k = heapq.heappop(heap)
            if (t, k) in dedup:
                dedup.discard((t, k))
                keys.append(k)
                tss.append(t)
        return (np.asarray(keys, dtype=np.int64),
                np.asarray(tss, dtype=np.int64))

    def advance_watermark(self, wm: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (key_ids, timestamps) of fired event-time timers, in
        timestamp order."""
        self.current_watermark = wm
        return self._pop_due(self._event, self._event_set, wm)

    def advance_processing_time(self, now: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._pop_due(self._proc, self._proc_set, now)

    def has_processing_time_timers(self) -> bool:
        return bool(self._proc_set)

    # -- checkpoint ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "event": sorted(self._event_set),
            "proc": sorted(self._proc_set),
            "watermark": self.current_watermark,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        self._event = [tuple(p) for p in snap["event"]]
        self._event_set = set(self._event)
        heapq.heapify(self._event)
        self._proc = [tuple(p) for p in snap["proc"]]
        self._proc_set = set(self._proc)
        heapq.heapify(self._proc)
        self.current_watermark = snap.get("watermark", MIN_WATERMARK)


class Collector:
    """Accumulates main + side outputs of one function invocation."""

    def __init__(self):
        self.out: List[Any] = []

    def collect(self, batch: RecordBatch) -> None:
        if batch is not None and len(batch):
            self.out.append(batch)

    def output(self, tag: OutputTag, batch: RecordBatch) -> None:
        if batch is not None and len(batch):
            self.out.append(TaggedBatch(tag, batch))


class ProcessContext(Collector):
    """Runtime context handed to process functions."""

    def __init__(self, timer_service: TimerService,
                 state_store: Optional[KeyedStateStore] = None,
                 aec=None):
        super().__init__()
        self._timers = timer_service
        self._store = state_store
        self._aec = aec

    def timer_service(self) -> TimerService:
        return self._timers

    @property
    def current_watermark(self) -> int:
        return self._timers.current_watermark

    def state(self, descriptor):
        if self._store is None:
            raise RuntimeError(
                "keyed state requires a KeyedStream (use key_by first)")
        return self._store.get_state(descriptor)

    def async_state(self, descriptor):
        """StateFuture-returning view of a keyed state (State V2 analog;
        reference: runtime/state/v2/). Ops queue into the operator's
        AsyncExecutionController and execute in coalesced waves — drained
        automatically at the end of every invocation and before every
        snapshot, or on any ``StateFuture.value()``."""
        from flink_tpu_torch.state.async_state import make_async_view

        if self._aec is None:
            raise RuntimeError(
                "async state requires a keyed process operator")
        return make_async_view(self._aec, self.state(descriptor))


@public
class ProcessFunction:
    """Vectorized ProcessFunction: override ``process_batch`` (and
    ``on_timer`` for keyed variants)."""

    def open(self, ctx) -> None:
        pass

    def process_batch(self, batch: RecordBatch, ctx: ProcessContext) -> None:
        raise NotImplementedError

    def on_timer(self, key_ids: np.ndarray, timestamps: np.ndarray,
                 ctx: ProcessContext) -> None:
        pass

    def close(self, ctx: ProcessContext) -> None:
        pass


KeyedProcessFunction = ProcessFunction  # keyed-ness comes from the stream


@public
class CoProcessFunction:
    """Two-input process function (reference: co/CoProcessFunction.java)."""

    def open(self, ctx) -> None:
        pass

    def process_batch1(self, batch: RecordBatch, ctx: ProcessContext) -> None:
        raise NotImplementedError

    def process_batch2(self, batch: RecordBatch, ctx: ProcessContext) -> None:
        raise NotImplementedError

    def on_timer(self, key_ids, timestamps, ctx) -> None:
        pass

    def close(self, ctx) -> None:
        pass


@public
class BroadcastProcessFunction:
    """reference: co/BroadcastProcessFunction.java +
    KeyedBroadcastProcessFunction.java. ``process_broadcast`` sees every
    broadcast-side batch and may write broadcast state;
    ``process_batch`` reads it."""

    def open(self, ctx) -> None:
        pass

    def process_batch(self, batch: RecordBatch, ctx,
                      broadcast_state: Dict[Any, Any]) -> None:
        raise NotImplementedError

    def process_broadcast(self, batch: RecordBatch, ctx,
                          broadcast_state: Dict[Any, Any]) -> None:
        raise NotImplementedError

    def on_timer(self, key_ids, timestamps, ctx) -> None:
        pass

    def close(self, ctx) -> None:
        pass


class ProcessOperator(Operator):
    """Drives a (Keyed)ProcessFunction.

    reference: streaming/api/operators/ProcessOperator.java and
    KeyedProcessOperator.java (timer callbacks via Triggerable).
    """

    name = "process"

    def __init__(self, fn: ProcessFunction, keyed: bool = False,
                 state_capacity: int = 1 << 12, clock=None):
        self.fn = fn
        self.keyed = keyed
        self.state_capacity = state_capacity
        self._clock = clock
        self.timer_service: Optional[TimerService] = None
        self.store: Optional[KeyedStateStore] = None

    def open(self, ctx):
        self.timer_service = TimerService(clock=self._clock)
        self.store = KeyedStateStore(
            self.state_capacity, clock=self._clock,
            device=getattr(ctx, "device", None)) if self.keyed else None
        if self.keyed:
            from flink_tpu_torch.state.async_state import AsyncExecutionController

            self.aec = AsyncExecutionController()
        else:
            self.aec = None
        self.fn.open(self._ctx())

    def _ctx(self) -> ProcessContext:
        return ProcessContext(self.timer_service, self.store, aec=self.aec)

    def _drain_processing_time(self, ctx: ProcessContext) -> None:
        if self.timer_service.has_processing_time_timers():
            keys, tss = self.timer_service.advance_processing_time(
                self.timer_service.clock())
            if len(keys):
                self.fn.on_timer(keys, tss, ctx)

    def _drain_async(self) -> None:
        # every invocation boundary is a drain point: no async state op
        # survives past the call that submitted it (reference:
        # AsyncExecutionController.drainInflightRecords before barriers)
        if self.aec is not None:
            self.aec.drain()

    def process_batch(self, batch, input_index=0):
        ctx = self._ctx()
        self.fn.process_batch(batch, ctx)
        self._drain_processing_time(ctx)
        self._drain_async()
        return ctx.out

    def process_watermark(self, watermark, input_index=0):
        ctx = self._ctx()
        keys, tss = self.timer_service.advance_watermark(watermark)
        if len(keys):
            self.fn.on_timer(keys, tss, ctx)
        self._drain_processing_time(ctx)
        self._drain_async()
        if self.store is not None:
            # TTL sweep rides watermark advance (processing-time based;
            # the watermark is just the cadence, like the reference's
            # background cleanup riding other activity)
            self.store.sweep_expired()
        return ctx.out

    #: processing-time timers must fire on an idle stream too — the
    #: executor's wall-clock tick drives them between batches (reference:
    #: ProcessingTimeService scheduled triggers)
    uses_processing_time = True

    def on_processing_time(self, now_ms: int):
        ctx = self._ctx()
        self._drain_processing_time(ctx)
        self._drain_async()
        return ctx.out

    def close(self):
        ctx = self._ctx()
        self.fn.close(ctx)
        self._drain_async()
        return ctx.out

    def snapshot_state(self):
        self._drain_async()
        snap = {"timers": self.timer_service.snapshot()}
        if self.store is not None:
            snap["keyed_state"] = self.store.snapshot()
        fn_snap = getattr(self.fn, "snapshot_state", None)
        if fn_snap is not None:
            snap["fn"] = fn_snap()
        return snap

    def restore_state(self, state):
        self.timer_service.restore(state["timers"])
        if self.store is not None and "keyed_state" in state:
            self.store.restore(state["keyed_state"])
        fn_restore = getattr(self.fn, "restore_state", None)
        if fn_restore is not None and "fn" in state:
            fn_restore(state["fn"])


class CoProcessOperator(ProcessOperator):
    """Two-input variant (reference: co/CoProcessOperator.java,
    KeyedCoProcessOperator.java)."""

    name = "co_process"

    def process_batch(self, batch, input_index=0):
        ctx = self._ctx()
        if input_index == 0:
            self.fn.process_batch1(batch, ctx)
        else:
            self.fn.process_batch2(batch, ctx)
        self._drain_processing_time(ctx)
        self._drain_async()
        return ctx.out


class BroadcastProcessOperator(ProcessOperator):
    """Input 0 = data side, input 1 = broadcast side. Broadcast state is a
    plain host dict replicated per parallel instance by construction (every
    instance sees every broadcast batch — reference:
    api/datastream/BroadcastConnectedStream.java semantics)."""

    name = "broadcast_process"

    def __init__(self, fn: BroadcastProcessFunction, keyed: bool = False,
                 state_capacity: int = 1 << 12, clock=None):
        super().__init__(fn, keyed=keyed, state_capacity=state_capacity,
                         clock=clock)
        self.broadcast_state: Dict[Any, Any] = {}

    def process_batch(self, batch, input_index=0):
        ctx = self._ctx()
        if input_index == 1:
            self.fn.process_broadcast(batch, ctx, self.broadcast_state)
        else:
            self.fn.process_batch(batch, ctx, self.broadcast_state)
        self._drain_processing_time(ctx)
        self._drain_async()
        return ctx.out

    def snapshot_state(self):
        snap = super().snapshot_state()
        snap["broadcast"] = dict(self.broadcast_state)
        return snap

    def restore_state(self, state):
        super().restore_state(state)
        self.broadcast_state = dict(state.get("broadcast", {}))


class SideOutputSelectOperator(Operator):
    """Selector node placed on a side-output edge; the executor routes
    TaggedBatches with a matching tag here and unwraps them."""

    name = "side_output"

    def __init__(self, tag: OutputTag):
        self.tag = tag

    def process_batch(self, batch, input_index=0):
        return [batch]
