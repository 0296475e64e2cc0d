"""Stream operators (port of the Q5 operators of
``flink_tpu/runtime/operators.py``): map, keyBy, the sink, and the keyed
window aggregation.

An operator processes one ``RecordBatch`` per call and reacts to watermark
advances; all operators are single-owner (called from one task loop).
User functions are vectorized: a map takes and returns a RecordBatch.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List

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
                 operator_index: int = 0):
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
    """keyBy -> window -> aggregate on the mesh window engine."""

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
        if ctx.parallelism <= 1:
            raise NotImplementedError(
                "parallelism 1 runs the single-device SliceSharedWindower "
                "engine, which is not ported to flink_tpu_torch yet "
                "(ROADMAP.md, Queue A item 3); set parallelism.default > 1 "
                "for the mesh window engine")
        from flink_tpu_torch.parallel.mesh import make_mesh
        from flink_tpu_torch.parallel.sharded_windower import (
            MeshWindowEngine,
        )

        self.windower = MeshWindowEngine(
            self.assigner, self.agg, make_mesh(ctx.parallelism, ctx.device),
            capacity_per_shard=self.capacity,
            max_parallelism=ctx.max_parallelism,
            allowed_lateness=self.allowed_lateness,
            fire_projector=self.fire_projector,
            max_dispatch_ahead=ctx.max_dispatch_ahead,
            shuffle_mode=ctx.shuffle_mode)
        self._async_fires = bool(ctx.async_fires)
        self._max_dispatch_ahead = int(ctx.max_dispatch_ahead)

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

