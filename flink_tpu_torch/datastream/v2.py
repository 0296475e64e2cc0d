"""DataStream V2 API — the reference's next-generation stream surface
(port of ``flink_tpu/datastream/v2.py``).

reference: flink-datastream-api
(flink-datastream-api/src/main/java/org/apache/flink/datastream/api/
ExecutionEnvironment.java, stream/NonKeyedPartitionStream.java,
stream/KeyedPartitionStream.java, stream/GlobalStream.java,
stream/BroadcastStream.java, function/OneInputStreamProcessFunction.java,
function/TwoInputNonBroadcastStreamProcessFunction.java,
function/TwoOutputStreamProcessFunction.java). The V2 design:
partitioning is a property of the STREAM TYPE (non-keyed / keyed /
global / broadcast), every transformation is ``process`` with a process
function receiving (input, output collector, partitioned context), and
side outputs are a second typed collector instead of OutputTags.

Batch-granular re-design (the house rule): process functions see whole
``RecordBatch``es; the two-output function receives two collectors;
keyed streams carry a key selector and expose keyed state + timers
through the context, exactly as V1's keyed process operator does — the
V2 facade maps onto the SAME engine (operators, state plane, executor),
so everything it runs inherits checkpointing, rescale, and the device
state plane. V1 and V2 programs can coexist in one process.
"""

from __future__ import annotations

from typing import Callable, Optional

from flink_tpu_torch.core.annotations import public
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.records import RecordBatch


@public
class OneInputStreamProcessFunction:
    """reference: function/OneInputStreamProcessFunction.java —
    processRecord(record, output, ctx); here batch-granular."""

    def open(self, ctx) -> None:
        pass

    def process_batch(self, batch: RecordBatch, out, ctx) -> None:
        raise NotImplementedError

    def on_timer(self, key_ids, timestamps, out, ctx) -> None:
        pass

    def close(self) -> None:
        pass


@public
class TwoInputNonBroadcastStreamProcessFunction:
    """reference: function/TwoInputNonBroadcastStreamProcessFunction.java
    — processRecordFromFirstInput / processRecordFromSecondInput."""

    def open(self, ctx) -> None:
        pass

    def process_batch_first(self, batch, out, ctx) -> None:
        raise NotImplementedError

    def process_batch_second(self, batch, out, ctx) -> None:
        raise NotImplementedError

    def on_timer(self, key_ids, timestamps, out, ctx) -> None:
        pass

    def close(self) -> None:
        pass


@public
class TwoInputBroadcastStreamProcessFunction:
    """reference: function/TwoInputBroadcastStreamProcessFunction.java —
    the non-broadcast side is processed per partition, the broadcast
    side is delivered to every partition."""

    def open(self, ctx) -> None:
        pass

    def process_batch(self, batch, out, ctx, broadcast_state) -> None:
        raise NotImplementedError

    def process_broadcast_batch(self, batch, out, ctx,
                                broadcast_state) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


@public
class TwoOutputStreamProcessFunction:
    """reference: function/TwoOutputStreamProcessFunction.java —
    processRecord(record, output1, output2, ctx): typed side output as
    a SECOND COLLECTOR instead of V1's OutputTag."""

    def open(self, ctx) -> None:
        pass

    def process_batch(self, batch, out1, out2, ctx) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class _Collector:
    """The V2 output collector; a thin adapter onto the V1 context."""

    def __init__(self, emit: Callable[[RecordBatch], None]):
        self._emit = emit

    def collect(self, batch: RecordBatch) -> None:
        if batch is not None and len(batch):
            self._emit(batch)


class _V2Context:
    """reference: context/PartitionedContext — state + timers for keyed
    partitions; watermark access everywhere."""

    def __init__(self, v1_ctx, keyed: bool):
        self._ctx = v1_ctx
        self._keyed = keyed

    @property
    def current_watermark(self) -> int:
        return self._ctx.current_watermark

    def timer_service(self):
        if not self._keyed:
            raise RuntimeError("timers require a KeyedPartitionStream")
        return self._ctx.timer_service()

    def state(self, descriptor):
        if not self._keyed:
            raise RuntimeError(
                "keyed state requires a KeyedPartitionStream")
        return self._ctx.state(descriptor)

    def async_state(self, descriptor):
        if not self._keyed:
            raise RuntimeError(
                "keyed state requires a KeyedPartitionStream")
        return self._ctx.async_state(descriptor)


def _wrap_one_input(fn: OneInputStreamProcessFunction, keyed: bool):
    """V2 function -> V1 ProcessFunction driving the same operator."""
    from flink_tpu_torch.runtime.process import ProcessFunction

    class _Adapter(ProcessFunction):
        def open(self, ctx) -> None:
            fn.open(_V2Context(ctx, keyed) if ctx is not None else None)

        def process_batch(self, batch, ctx) -> None:
            fn.process_batch(batch, _Collector(ctx.collect),
                             _V2Context(ctx, keyed))

        def on_timer(self, key_ids, timestamps, ctx) -> None:
            fn.on_timer(key_ids, timestamps, _Collector(ctx.collect),
                        _V2Context(ctx, keyed))

        def close(self, ctx) -> None:
            fn.close()

    return _Adapter()


@public
class NonKeyedPartitionStream:
    """reference: stream/NonKeyedPartitionStream.java."""

    def __init__(self, v1_stream, keyed: bool = False):
        self._s = v1_stream
        self._keyed = keyed

    # -- transformations -----------------------------------------------------

    def process(self, fn) -> "NonKeyedPartitionStream":
        if isinstance(fn, TwoOutputStreamProcessFunction):
            raise TypeError("use process_two_output for two-output "
                            "functions (returns both streams)")
        out = self._s.process(_wrap_one_input(fn, self._keyed))
        return NonKeyedPartitionStream(out)

    def process_two_output(self, fn: TwoOutputStreamProcessFunction
                           ) -> tuple:
        """Returns (main_stream, side_stream) — V2's typed second
        output, mapped onto the engine's side-output routing."""
        from flink_tpu_torch.runtime.process import (
            OutputTag,
            ProcessFunction,
        )

        tag = OutputTag("v2-second-output")
        keyed = self._keyed

        class _Adapter(ProcessFunction):
            def open(self, ctx) -> None:
                fn.open(_V2Context(ctx, keyed) if ctx is not None
                        else None)

            def process_batch(self, batch, ctx) -> None:
                fn.process_batch(
                    batch, _Collector(ctx.collect),
                    _Collector(lambda b: ctx.output(tag, b)),
                    _V2Context(ctx, keyed))

            def close(self, ctx) -> None:
                fn.close()

        main = self._s.process(_Adapter())
        side = main.get_side_output(tag)
        return (NonKeyedPartitionStream(main),
                NonKeyedPartitionStream(side))

    def connect_and_process(self, other, fn) -> "NonKeyedPartitionStream":
        """reference: NonKeyedPartitionStream.connectAndProcess — two
        plain inputs, or a BroadcastStream second input."""
        if isinstance(other, BroadcastStream):
            return other._connect(self, fn)
        keyed = self._keyed
        if keyed != other._keyed:
            raise TypeError(
                "connectAndProcess requires both streams keyed or both "
                "non-keyed (reference: KeyedPartitionStream connects "
                "with another KeyedPartitionStream)")
        from flink_tpu_torch.runtime.process import CoProcessFunction

        class _Adapter(CoProcessFunction):
            def open(self, ctx) -> None:
                fn.open(_V2Context(ctx, keyed) if ctx is not None
                        else None)

            def process_batch1(self, batch, ctx) -> None:
                fn.process_batch_first(batch, _Collector(ctx.collect),
                                       _V2Context(ctx, keyed))

            def process_batch2(self, batch, ctx) -> None:
                fn.process_batch_second(batch, _Collector(ctx.collect),
                                        _V2Context(ctx, keyed))

            def on_timer(self, key_ids, timestamps, ctx) -> None:
                fn.on_timer(key_ids, timestamps,
                            _Collector(ctx.collect),
                            _V2Context(ctx, keyed))

            def close(self, ctx) -> None:
                fn.close()

        connected = self._s.connect(other._s)
        if keyed:
            # the V1 streams are already KeyedStreams; re-keying by the
            # same fields marks the ConnectedStreams keyed so the
            # co-process operator opens a state store
            connected = connected.key_by(self._s.key_field,
                                         other._s.key_field)
        out = connected.process(_Adapter())
        return NonKeyedPartitionStream(out)

    # -- repartitioning ------------------------------------------------------

    def key_by(self, key_field: str) -> "KeyedPartitionStream":
        return KeyedPartitionStream(self._s.key_by(key_field))

    def global_(self) -> "GlobalStream":
        return GlobalStream(self._s)

    def broadcast(self) -> "BroadcastStream":
        return BroadcastStream(self._s)

    # -- sinks ---------------------------------------------------------------

    def to_sink(self, sink) -> None:
        self._s.sink_to(sink)


@public
class KeyedPartitionStream(NonKeyedPartitionStream):
    """reference: stream/KeyedPartitionStream.java — per-key partitions
    with keyed state + timers in the process context."""

    def __init__(self, v1_keyed_stream):
        super().__init__(v1_keyed_stream, keyed=True)

    def process(self, fn) -> NonKeyedPartitionStream:
        if isinstance(fn, TwoOutputStreamProcessFunction):
            raise TypeError("use process_two_output for two-output "
                            "functions (returns both streams)")
        out = self._s.process(_wrap_one_input(fn, True))
        return NonKeyedPartitionStream(out)

    # windows stay available on keyed streams (the V2 extension ships
    # window support as a built-in extension; here it is the engine's
    # native windowing)
    def window(self, assigner):
        return self._s.window(assigner)


@public
class GlobalStream(NonKeyedPartitionStream):
    """reference: stream/GlobalStream.java — all records in ONE
    partition. In this engine a non-keyed pipeline IS a single
    partition (subtask expansion applies to keyed stages), so the
    wrapper is the type-level marker the V2 API wants."""

    def __init__(self, v1_stream):
        super().__init__(v1_stream, keyed=False)


@public
class BroadcastStream:
    """reference: stream/BroadcastStream.java — every downstream
    partition sees every record; combined with a keyed/non-keyed stream
    via connectAndProcess."""

    def __init__(self, v1_stream):
        self._s = v1_stream

    def _connect(self, data: NonKeyedPartitionStream,
                 fn: TwoInputBroadcastStreamProcessFunction
                 ) -> NonKeyedPartitionStream:
        from flink_tpu_torch.runtime.process import BroadcastProcessFunction

        class _Adapter(BroadcastProcessFunction):
            def open(self, ctx) -> None:
                fn.open(_V2Context(ctx, data._keyed)
                        if ctx is not None else None)

            def process_batch(self, batch, ctx, broadcast_state) -> None:
                fn.process_batch(batch, _Collector(ctx.collect),
                                 _V2Context(ctx, data._keyed),
                                 broadcast_state)

            def process_broadcast(self, batch, ctx,
                                  broadcast_state) -> None:
                fn.process_broadcast_batch(
                    batch, _Collector(ctx.collect),
                    _V2Context(ctx, data._keyed), broadcast_state)

            def close(self, ctx) -> None:
                fn.close()

        out = data._s.connect(self._s.broadcast()).process(_Adapter())
        return NonKeyedPartitionStream(out)


@public
class ExecutionEnvironment:
    """reference: ExecutionEnvironment.java — getInstance() +
    fromSource() + execute(). Wraps the V1 environment so both APIs
    share one engine, one config surface, one executor."""

    def __init__(self, config: Optional[Configuration] = None):
        from flink_tpu_torch.datastream.environment import (
            StreamExecutionEnvironment,
        )

        self._env = StreamExecutionEnvironment(config or Configuration({}))

    @staticmethod
    def get_instance(config: Optional[Configuration] = None
                     ) -> "ExecutionEnvironment":
        return ExecutionEnvironment(config)

    @property
    def config(self) -> Configuration:
        return self._env.config

    def from_source(self, source, watermark_strategy=None,
                    name: str = "v2-source") -> NonKeyedPartitionStream:
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

        strategy = watermark_strategy or \
            WatermarkStrategy.for_bounded_out_of_orderness(0)
        return NonKeyedPartitionStream(
            self._env.from_source(source, strategy, name=name))

    def execute(self, job_name: str = "v2-job"):
        return self._env.execute(job_name)
