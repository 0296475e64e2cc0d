"""The DataStream fluent API (port of the Q5 surface of
``flink_tpu/datastream/stream.py``): map, key_by, window, aggregate and
its shorthands (sum, count, max, min, avg), and sinks. Each method builds
``Transformation`` nodes that the executor turns into batched operators."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Optional

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.graph.transformations import Transformation
from flink_tpu_torch.runtime.operators import (
    KeyByOperator,
    MapOperator,
    SinkOperator,
    WindowAggOperator,
)
from flink_tpu_torch.windowing.aggregates import (
    AggregateFunction,
    AvgAggregate,
    CountAggregate,
    MaxAggregate,
    MinAggregate,
    SumAggregate,
)
from flink_tpu_torch.windowing.assigners import WindowAssigner

if TYPE_CHECKING:
    from flink_tpu_torch.connectors.sinks import Sink


class DataStream:
    def __init__(self, env, transformation: Transformation):
        self.env = env
        self.transformation = transformation

    def set_parallelism(self, parallelism: int) -> "DataStream":
        """Parallelism of this operator: a keyed window at N > 1 runs on an
        N-shard logical mesh (MeshWindowEngine)."""
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        self.transformation.parallelism = parallelism
        return self

    def _one_input(self, name: str, factory, **kw) -> Transformation:
        return Transformation(name=name, kind="one_input",
                              operator_factory=factory,
                              inputs=[self.transformation], **kw)

    def map(self, fn: Callable[[RecordBatch], RecordBatch],
            name: str = "map") -> "DataStream":
        return DataStream(self.env, self._one_input(
            name, lambda: MapOperator(fn)))

    def key_by(self, key_field: str) -> "KeyedStream":
        t = self._one_input(f"key_by({key_field})",
                            lambda: KeyByOperator(key_field),
                            keyed=True, key_field=key_field)
        return KeyedStream(self.env, t, key_field)

    def sink_to(self, sink: "Sink", name: str = "sink") -> "DataStreamSink":
        t = Transformation(name=name, kind="sink",
                           operator_factory=lambda: SinkOperator(sink),
                           inputs=[self.transformation])
        self.env._sinks.append(t)
        return DataStreamSink(self.env, t, sink)


class DataStreamSink:
    def __init__(self, env, transformation, sink):
        self.env = env
        self.transformation = transformation
        self.sink = sink


class KeyedStream(DataStream):
    def __init__(self, env, transformation, key_field: str):
        super().__init__(env, transformation)
        self.key_field = key_field

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)


class WindowedStream:
    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self.keyed = keyed
        self.assigner = assigner
        self._allowed_lateness = 0

    def allowed_lateness(self, ms: int) -> "WindowedStream":
        self._allowed_lateness = ms
        return self

    def aggregate(self, agg: AggregateFunction, name: Optional[str] = None,
                  fire_projector=None) -> DataStream:
        """``fire_projector`` reduces each fired window's rows before they
        leave the engine (e.g. top-k for an arg-max consumer)."""
        env = self.keyed.env
        capacity = env.state_slot_capacity
        key_field = self.keyed.key_field
        assigner = self.assigner
        lateness = self._allowed_lateness
        t = Transformation(
            name=name or f"window_agg({type(agg).__name__})",
            kind="one_input",
            operator_factory=lambda: WindowAggOperator(
                assigner, agg, key_field, capacity=capacity,
                allowed_lateness=lateness, fire_projector=fire_projector),
            inputs=[self.keyed.transformation],
            keyed=True, key_field=key_field)
        return DataStream(env, t)

    # SQL-ish shorthands
    def sum(self, field: str) -> DataStream:
        return self.aggregate(SumAggregate(field))

    def count(self) -> DataStream:
        return self.aggregate(CountAggregate())

    def max(self, field: str) -> DataStream:
        return self.aggregate(MaxAggregate(field))

    def min(self, field: str) -> DataStream:
        return self.aggregate(MinAggregate(field))

    def avg(self, field: str) -> DataStream:
        return self.aggregate(AvgAggregate(field))
