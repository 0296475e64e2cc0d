"""flink_tpu_torch — the PyTorch/CUDA port of flink_tpu.

The JAX package ``flink_tpu`` is the reference; this package mirrors its
module layout so every module has an obvious counterpart, and runs the
same semantics on PyTorch tensors. Device arrays are ``torch.Tensor``s on
an explicit device: entry points take a ``device`` (or read
``execution.device`` from the configuration), which defaults to
``"cuda"``. A host without CUDA raises on that default — the port never
drops to the CPU by itself; callers (the tests) ask for ``"cpu"``.

The port carries the Nexmark Q5 path — ``keyBy -> window -> aggregate``
at ``parallelism.default > 1`` on a logical P-shard mesh on one device
(the exchange rank as the hand-written CUDA kernel ``csrc/rank.cu``) and
at parallelism 1 in the slot and pane layouts — and session windows at
parallelism 1 and above over the paged spill tier; float folds run in
stream order through the hand-written ``csrc/ordered_fold.cu``. Streaming
joins run on the host operators or, with ``join.mode=device``, on the
device interval and temporal join engines of ``joins/``; Nexmark Q7 runs
through the host window join, its float32 window max on the ordered
fold. CEP
(``cep/``) runs ``CEP.pattern(keyed, p).select()`` on the host NFA, as the
reference plans it, and the bounded-partial pattern class on the device
NFA engine (``MeshCepEngine``, ``MeshCepOperator``). Every
engine checkpoints and restores in the reference's on-disk format
(``checkpoint/``), and ``chaos/`` holds the fault points and the
crash-restore-verify harness. The mesh window engine runs under a per-shard
device budget (the namespace spill layout, hybrid fires), batch mode fires
every window once at the end of input, and the DataStream surface carries
BASELINE row 1 (socket WordCount over processing-time windows,
``benchmarks/wordcount.py``). Process functions carry keyed state (host
states with TTL, and ``DeviceValueState`` on the operator's device),
timers, side outputs, ``connect``/``broadcast`` and async I/O; the
changelog backend, the columnar serializers with the binary file sink
and source, and stop-with-savepoint carry the rest of durability.
Unwindowed GROUP BY and ``KeyedStream.reduce/sum/max/min`` emit changelogs
(``runtime/group_agg.py``; retractions fold signed, float leaves on the
ordered fold), and the SQL/Table front end (``table/``) plans window TVFs,
GROUP BY, Top-N, the interval and temporal joins and MATCH_RECOGNIZE onto
these operators over the Kafka, datagen and collect connectors
(BASELINE row 4). The package imports neither ``jax`` nor anything of
``flink_tpu`` (importing ``flink_tpu`` loads jax).
"""

from flink_tpu_torch.core.config import ConfigOption, Configuration
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.datastream.environment import StreamExecutionEnvironment
from flink_tpu_torch.datastream.stream import AsyncDataStream
from flink_tpu_torch.runtime.process import (
    BroadcastProcessFunction,
    CoProcessFunction,
    KeyedProcessFunction,
    OutputTag,
    ProcessFunction,
)
from flink_tpu_torch.state.keyed_state import (
    ListStateDescriptor,
    MapStateDescriptor,
    ReducingStateDescriptor,
    ValueStateDescriptor,
)

__all__ = [
    "AsyncDataStream",
    "BroadcastProcessFunction",
    "ConfigOption",
    "Configuration",
    "CoProcessFunction",
    "KeyedProcessFunction",
    "ListStateDescriptor",
    "MapStateDescriptor",
    "OutputTag",
    "ProcessFunction",
    "RecordBatch",
    "ReducingStateDescriptor",
    "StreamExecutionEnvironment",
    "ValueStateDescriptor",
]
