"""The DataStream fluent API (port of ``flink_tpu/datastream/stream.py``):
map, filter, flat_map, union, key_by, window — aligned (event or
processing time) or merging (sessions) —, aggregate and its shorthands
(sum, count, max, min, avg, aggregate_all), the window join
(``join().where().equal_to().window().apply()``), the interval join
(``interval_join().between()``), process functions (``process``,
``KeyedStream.process``, ``get_side_output``, ``connect`` with
``ConnectedStreams``, ``broadcast`` with ``BroadcastConnectedStream``),
async I/O (``AsyncDataStream``), the running keyed aggregates
(``KeyedStream.reduce``/``sum``/``max``/``min``, changelog emission by
``GroupAggOperator``), sinks, ``print`` and ``execute_and_collect``. Each method builds ``Transformation`` nodes that
the executor turns into batched operators. User functions are vectorized:
a map takes and returns a RecordBatch, a filter returns a mask, a flat_map
a list of batches."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.annotations import public, public_evolving
from flink_tpu_torch.core.config import DeploymentOptions
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.graph.transformations import Transformation
from flink_tpu_torch.runtime.operators import (
    FilterOperator,
    FlatMapOperator,
    KeyByOperator,
    MapOperator,
    SessionWindowAggOperator,
    SinkOperator,
    UnionOperator,
    WindowAggOperator,
)
from flink_tpu_torch.windowing.aggregates import (
    AggregateFunction,
    AvgAggregate,
    CountAggregate,
    MaxAggregate,
    MinAggregate,
    MultiAggregate,
    SumAggregate,
)
from flink_tpu_torch.windowing.assigners import WindowAssigner

if TYPE_CHECKING:
    from flink_tpu_torch.connectors.sinks import Sink


@public
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

    def ml_predict(self, model, input_fields=None, output_prefix: str = "",
                   asynchronous: bool = False, capacity: int = 4,
                   name: str = "ml_predict") -> "DataStream":
        """Batched model inference appending the model's output columns
        (SQL ML_PREDICT's operator; a ``TorchModel`` runs on its own
        device). With ``asynchronous=True``, inference overlaps upstream
        work under a bounded in-flight budget (AsyncMLPredictRunner)."""
        from flink_tpu_torch.ml.operators import (
            AsyncMLPredictOperator,
            MLPredictOperator,
        )

        if asynchronous:
            factory = lambda: AsyncMLPredictOperator(  # noqa: E731
                model, input_fields, output_prefix, capacity=capacity)
        else:
            factory = lambda: MLPredictOperator(  # noqa: E731
                model, input_fields, output_prefix)
        return DataStream(self.env, Transformation(
            name=name, kind="one_input", operator_factory=factory,
            inputs=[self.transformation]))

    def filter(self, predicate: Callable[[RecordBatch], np.ndarray],
               name: str = "filter") -> "DataStream":
        return DataStream(self.env, self._one_input(
            name, lambda: FilterOperator(predicate)))

    def flat_map(self, fn: Callable[[RecordBatch], List[RecordBatch]],
                 name: str = "flat_map") -> "DataStream":
        return DataStream(self.env, self._one_input(
            name, lambda: FlatMapOperator(fn)))

    def union(self, *others: "DataStream",
              _require_consistent_time: bool = False) -> "DataStream":
        """Merge streams; the watermark is the minimum over the inputs.
        Timed and untimed inputs may mix when nothing downstream uses
        event time; SQL UNION ALL passes the strict flag."""
        t = Transformation(
            name="union", kind="union",
            operator_factory=lambda: UnionOperator(
                require_consistent_time=_require_consistent_time),
            inputs=[self.transformation] + [o.transformation for o in others])
        return DataStream(self.env, t)

    def join(self, other: "DataStream") -> "JoinedStreams":
        """Window equi-join builder:
        ``a.join(b).where(f).equal_to(g).window(assigner).apply()``."""
        return JoinedStreams(self, other)

    def process(self, fn, name: str = "process") -> "DataStream":
        """Low-level processing with timers and side outputs
        (``ProcessOperator``)."""
        from flink_tpu_torch.runtime.process import ProcessOperator

        return DataStream(self.env, self._one_input(
            name, lambda: ProcessOperator(fn)))

    def slot_sharing_group(self, name: str) -> "DataStream":
        """Put this transformation (and, by inheritance, its downstream
        chain) into slot sharing group ``name``."""
        self.transformation.slot_group = name
        return self

    def get_side_output(self, tag) -> "DataStream":
        """The batches this stream's operator emitted under ``tag`` (an
        ``OutputTag`` or its name)."""
        from flink_tpu_torch.runtime.process import (
            OutputTag,
            SideOutputSelectOperator,
        )

        if isinstance(tag, str):
            tag = OutputTag(tag)
        return DataStream(self.env, self._one_input(
            f"side_output({tag.name})",
            lambda: SideOutputSelectOperator(tag), side_tag=tag.name))

    def connect(self, other) -> "ConnectedStreams":
        """Two inputs into one co-process operator;
        ``BroadcastConnectedStream`` when ``other`` is ``.broadcast()``."""
        if isinstance(other, BroadcastStream):
            return BroadcastConnectedStream(self, other)
        return ConnectedStreams(self, other)

    def broadcast(self) -> "BroadcastStream":
        return BroadcastStream(self)

    def key_by(self, key_field: str) -> "KeyedStream":
        t = self._one_input(f"key_by({key_field})",
                            lambda: KeyByOperator(key_field),
                            keyed=True, key_field=key_field)
        return KeyedStream(self.env, t, key_field)

    def sink_to(self, sink: "Sink", name: str = "sink") -> "DataStreamSink":
        """A ``TwoPhaseCommitSink`` runs under ``TwoPhaseSinkOperator``
        (its transactions commit once a checkpoint is durable), any other
        sink under ``SinkOperator``."""
        from flink_tpu_torch.connectors.two_phase import (
            TwoPhaseCommitSink,
            TwoPhaseSinkOperator,
        )

        if isinstance(sink, TwoPhaseCommitSink):
            factory = lambda: TwoPhaseSinkOperator(sink)  # noqa: E731
        else:
            factory = lambda: SinkOperator(sink)  # noqa: E731
        t = Transformation(name=name, kind="sink",
                           operator_factory=factory,
                           inputs=[self.transformation])
        self.env._sinks.append(t)
        return DataStreamSink(self.env, t, sink)

    def print(self, label: str = "") -> "DataStreamSink":
        from flink_tpu_torch.connectors.sinks import PrintSink

        return self.sink_to(PrintSink(label), name="print")

    def execute_and_collect(self) -> RecordBatch:
        """Attach a collect sink, run the job, return its rows as one
        batch."""
        from flink_tpu_torch.connectors.sinks import CollectSink

        sink = CollectSink()
        self.sink_to(sink, name="collect")
        self.env.execute()
        return sink.result()


class DataStreamSink:
    def __init__(self, env, transformation, sink):
        self.env = env
        self.transformation = transformation
        self.sink = sink


@public
class KeyedStream(DataStream):
    def __init__(self, env, transformation, key_field: str):
        super().__init__(env, transformation)
        self.key_field = key_field

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)

    def interval_join(self, other: "KeyedStream") -> "IntervalJoinBuilder":
        """Keyed interval join with ``other`` (INNER)."""
        return IntervalJoinBuilder(self, other)

    def process(self, fn, name: str = "keyed_process") -> DataStream:
        """A keyed process function: per-key state (on the operator's
        ``execution.device`` for ``DeviceValueStateDescriptor`` states)
        and timers."""
        from flink_tpu_torch.runtime.process import ProcessOperator

        capacity = self.env.state_slot_capacity
        return DataStream(self.env, self._one_input(
            name, lambda: ProcessOperator(fn, keyed=True,
                                          state_capacity=capacity),
            keyed=True, key_field=self.key_field))

    # -- running (unwindowed) keyed aggregates: upsert emission by the
    # -- slot-table GroupAggOperator the SQL layer uses -------------------

    def reduce(self, agg: AggregateFunction, name: str = None) -> DataStream:
        from flink_tpu_torch.runtime.group_agg import GroupAggOperator

        capacity = self.env.state_slot_capacity
        key_field = self.key_field
        return DataStream(self.env, self._one_input(
            name or f"keyed_reduce({type(agg).__name__})",
            lambda: GroupAggOperator(agg, key_field, capacity=capacity),
            keyed=True, key_field=key_field))

    def sum(self, field: str) -> DataStream:
        return self.reduce(SumAggregate(field))

    def max(self, field: str) -> DataStream:
        return self.reduce(MaxAggregate(field))

    def min(self, field: str) -> DataStream:
        return self.reduce(MinAggregate(field))


class ConnectedStreams:
    """Two streams into one two-input operator."""

    def __init__(self, first: DataStream, second: DataStream):
        self.first = first
        self.second = second
        self._keyed = False

    def key_by(self, first_key: str, second_key: str) -> "ConnectedStreams":
        c = ConnectedStreams(self.first.key_by(first_key),
                             self.second.key_by(second_key))
        c._keyed = True
        return c

    def process(self, fn, name: str = "co_process") -> DataStream:
        from flink_tpu_torch.runtime.process import CoProcessOperator

        keyed = self._keyed
        t = Transformation(
            name=name, kind="two_input",
            operator_factory=lambda: CoProcessOperator(fn, keyed=keyed),
            inputs=[self.first.transformation, self.second.transformation],
            keyed=keyed)
        return DataStream(self.first.env, t)

    def map(self, fn1, fn2, name: str = "co_map") -> DataStream:
        """``fn1`` on the first input's batches, ``fn2`` on the second's."""
        from flink_tpu_torch.runtime.process import CoProcessFunction

        class _CoMap(CoProcessFunction):
            def process_batch1(self, batch, ctx):
                ctx.collect(fn1(batch))

            def process_batch2(self, batch, ctx):
                ctx.collect(fn2(batch))

        return self.process(_CoMap(), name=name)


class BroadcastStream:
    """Marker wrapper produced by ``DataStream.broadcast()``."""

    def __init__(self, stream: DataStream):
        self.stream = stream


class BroadcastConnectedStream:
    """A data stream with a broadcast side: every instance of the
    operator sees every broadcast batch (input 1)."""

    def __init__(self, data: DataStream, broadcast: BroadcastStream):
        self.data = data
        self.broadcast = broadcast

    def process(self, fn, name: str = "broadcast_process") -> DataStream:
        from flink_tpu_torch.runtime.process import BroadcastProcessOperator

        keyed = isinstance(self.data, KeyedStream)
        bt = Transformation(
            name="broadcast", kind="one_input", operator_factory=UnionOperator,
            inputs=[self.broadcast.stream.transformation], broadcast=True)
        t = Transformation(
            name=name, kind="two_input",
            operator_factory=lambda: BroadcastProcessOperator(fn, keyed=keyed),
            inputs=[self.data.transformation, bt], keyed=keyed)
        return DataStream(self.data.env, t)


@public_evolving
class AsyncDataStream:
    """Async I/O over a stream (``AsyncWaitOperator``): ordered or
    unordered results, a capacity of batches in flight, a timeout."""

    @staticmethod
    def _wait(stream: DataStream, fn, ordered: bool, timeout_ms, capacity,
              name: str) -> DataStream:
        from flink_tpu_torch.runtime.async_operator import AsyncWaitOperator

        return DataStream(stream.env, stream._one_input(
            name, lambda: AsyncWaitOperator(
                fn, ordered=ordered, capacity=capacity,
                timeout_ms=timeout_ms)))

    @staticmethod
    def ordered_wait(stream: DataStream, fn, timeout_ms: int = None,
                     capacity: int = 8) -> DataStream:
        return AsyncDataStream._wait(stream, fn, True, timeout_ms, capacity,
                                     "async_wait_ordered")

    @staticmethod
    def unordered_wait(stream: DataStream, fn, timeout_ms: int = None,
                       capacity: int = 8) -> DataStream:
        return AsyncDataStream._wait(stream, fn, False, timeout_ms, capacity,
                                     "async_wait_unordered")


class JoinedStreams:
    def __init__(self, left: DataStream, right: DataStream):
        self.left = left
        self.right = right
        self.left_key: Optional[str] = None
        self.right_key: Optional[str] = None

    def where(self, left_key: str) -> "JoinedStreams":
        self.left_key = left_key
        return self

    def equal_to(self, right_key: str) -> "JoinedStreams":
        self.right_key = right_key
        return self

    def window(self, assigner: WindowAssigner) -> "WindowedJoin":
        if self.left_key is None or self.right_key is None:
            raise ValueError(
                "call .where(left_key).equal_to(right_key) before .window()")
        return WindowedJoin(self, assigner)


class WindowedJoin:
    def __init__(self, joined: JoinedStreams, assigner: WindowAssigner):
        self.joined = joined
        self.assigner = assigner

    def apply(self, suffixes=("_l", "_r"), name: str = "window_join"
              ) -> DataStream:
        from flink_tpu_torch.runtime.join_operators import WindowJoinOperator

        j = self.joined
        left_keyed = j.left.key_by(j.left_key).transformation
        right_keyed = j.right.key_by(j.right_key).transformation
        assigner = self.assigner
        key_fields = (j.left_key, j.right_key)
        t = Transformation(
            name=name, kind="two_input",
            operator_factory=lambda: WindowJoinOperator(
                assigner, suffixes, key_fields=key_fields),
            inputs=[left_keyed, right_keyed], keyed=True)
        return DataStream(j.left.env, t)


class IntervalJoinBuilder:
    def __init__(self, left: KeyedStream, right: KeyedStream):
        self.left = left
        self.right = right

    def between(self, lower_ms: int, upper_ms: int,
                suffixes=("_l", "_r")) -> DataStream:
        """``join.mode=device`` runs the join on the device row tables of
        a logical mesh of the operator's parallelism
        (``DeviceIntervalJoinOperator``); ``host`` (the default) on the
        host operator."""
        env = self.left.env
        mode = env.config.get(DeploymentOptions.JOIN_MODE)
        if mode == "device":
            from flink_tpu_torch.joins.operators import (
                DeviceIntervalJoinOperator,
            )

            capacity = env.state_slot_capacity
            spill = env.state_spill_options
            factory = lambda: DeviceIntervalJoinOperator(  # noqa: E731
                lower_ms, upper_ms, suffixes, capacity=capacity,
                max_device_slots=spill["max_device_slots"],
                spill_dir=spill["spill_dir"],
                spill_host_max_bytes=spill["spill_host_max_bytes"])
        elif mode == "host":
            from flink_tpu_torch.runtime.join_operators import (
                IntervalJoinOperator,
            )

            factory = lambda: IntervalJoinOperator(  # noqa: E731
                lower_ms, upper_ms, suffixes)
        else:
            raise ValueError(
                f"join.mode must be 'host' or 'device', got {mode!r}")
        t = Transformation(
            name="interval_join", kind="two_input",
            operator_factory=factory,
            inputs=[self.left.transformation, self.right.transformation],
            keyed=True)
        return DataStream(env, t)


@public
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
        if getattr(assigner, "is_merging", False):
            if fire_projector is not None:
                raise ValueError(
                    "fire_projector is not supported for merging (session) "
                    "windows yet — a session fire emits one row per "
                    "(key, merged window), not one batch per aligned window")
            gap = assigner.gap
            factory = lambda: SessionWindowAggOperator(  # noqa: E731
                gap, agg, key_field, capacity=capacity,
                allowed_lateness=lateness)
        else:
            factory = lambda: WindowAggOperator(  # noqa: E731
                assigner, agg, key_field, capacity=capacity,
                allowed_lateness=lateness, fire_projector=fire_projector)
        t = Transformation(
            name=name or f"window_agg({type(agg).__name__})",
            kind="one_input", operator_factory=factory,
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

    def aggregate_all(self, aggs: Sequence[AggregateFunction]) -> DataStream:
        return self.aggregate(MultiAggregate(aggs))
