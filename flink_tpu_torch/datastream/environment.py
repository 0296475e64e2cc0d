"""StreamExecutionEnvironment — the API entry point (port of
``flink_tpu/datastream/environment.py``).

The environment collects sink transformations, builds a StreamGraph and
runs it on the local executor. ``execution.device`` in its configuration
selects the device of the keyed state (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional

from flink_tpu_torch.core.config import (
    BatchOptions,
    Configuration,
    StateOptions,
)
from flink_tpu_torch.graph.transformations import StreamGraph, Transformation
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy


class StreamExecutionEnvironment:
    def __init__(self, config: Optional[Configuration] = None):
        self.config = config or Configuration()
        self._sinks: List[Transformation] = []
        #: JobExecutionResult of the most recent execute()
        self.last_execution_result = None

    @property
    def batch_size(self) -> int:
        return self.config.get(BatchOptions.BATCH_SIZE)

    @property
    def state_slot_capacity(self) -> int:
        return self.config.get(StateOptions.SLOT_CAPACITY)

    def add_source(self, source, watermark_strategy: Optional[
            WatermarkStrategy] = None, name: Optional[str] = None):
        from flink_tpu_torch.datastream.stream import DataStream

        t = Transformation(
            name=name or type(source).__name__, kind="source",
            source=source,
            watermark_strategy=watermark_strategy
            or WatermarkStrategy.for_monotonous_timestamps())
        return DataStream(self, t)

    def from_source(self, source, watermark_strategy=None, name=None):
        return self.add_source(source, watermark_strategy, name)

    def get_stream_graph(self) -> StreamGraph:
        if not self._sinks:
            raise RuntimeError("no sinks defined — nothing to execute")
        return StreamGraph(self._sinks)

    def execute(self, job_name: str = "job") -> "JobExecutionResult":
        """Run the pipeline to completion on the local executor."""
        from flink_tpu_torch.cluster.local_executor import LocalExecutor

        graph = self.get_stream_graph()
        result = LocalExecutor(self.config).run(graph, job_name=job_name)
        self._sinks = []
        self.last_execution_result = result
        return result


class JobExecutionResult:
    def __init__(self, job_name: str, metrics: dict):
        self.job_name = job_name
        self.metrics = metrics

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"JobExecutionResult({self.job_name}, {self.metrics})"
