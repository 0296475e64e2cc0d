"""flink_tpu_torch — the PyTorch/CUDA port of flink_tpu.

The JAX package ``flink_tpu`` is the reference; this package mirrors its
module layout so every module has an obvious counterpart, and runs the
same semantics on PyTorch tensors. Device arrays are ``torch.Tensor``s on
an explicit device: entry points take a ``device`` (or read
``execution.device`` from the configuration), which defaults to
``"cuda"``. A host without CUDA raises on that default — the port never
drops to the CPU by itself; callers (the tests) ask for ``"cpu"``.

This slice carries the Nexmark Q5 mesh path: ``keyBy -> window ->
aggregate`` at ``parallelism.default > 1`` on a logical P-shard mesh on
one device, with the exchange rank as a hand-written CUDA kernel
(``csrc/rank.cu``). The package imports neither ``jax`` nor anything of
``flink_tpu`` (importing ``flink_tpu`` loads jax).
"""

from flink_tpu_torch.core.config import ConfigOption, Configuration
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.datastream.environment import StreamExecutionEnvironment

__all__ = ["ConfigOption", "Configuration", "RecordBatch",
           "StreamExecutionEnvironment"]
