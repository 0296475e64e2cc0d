"""StreamExecutionEnvironment — the API entry point (port of
``flink_tpu/datastream/environment.py``).

The environment collects sink transformations, builds a StreamGraph and
runs it on the local executor. ``execution.device`` in its configuration
selects the device of the keyed state (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from flink_tpu_torch.core.annotations import public
from flink_tpu_torch.core.config import (
    BatchOptions,
    CheckpointOptions,
    Configuration,
    CoreOptions,
    DeploymentOptions,
    StateOptions,
)
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.graph.transformations import StreamGraph, Transformation
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy


@public
class StreamExecutionEnvironment:
    def __init__(self, config: Optional[Configuration] = None):
        self.config = config or Configuration()
        self._sinks: List[Transformation] = []
        #: JobExecutionResult of the most recent execute()
        self.last_execution_result = None

    def _effective_config(self) -> Configuration:
        """The CLI's ``-D`` dynamic properties (``FLINK_TPU_DYNAMIC_PROPS``,
        set by ``cli run``) override the programmatic configuration —
        applied at execute() time, so they win over any mutator the script
        called after building the environment (reference: CliFrontend
        dynamic properties > user Configuration)."""
        import json
        import os

        raw = os.environ.get("FLINK_TPU_DYNAMIC_PROPS")
        if not raw:
            return self.config
        try:
            props = json.loads(raw)
        except ValueError:
            return self.config
        return Configuration(props).with_fallback(self.config)

    @staticmethod
    def get_execution_environment(
        config: Optional[Configuration] = None,
    ) -> "StreamExecutionEnvironment":
        return StreamExecutionEnvironment(config)

    @property
    def parallelism(self) -> int:
        return self._effective_config().get(CoreOptions.DEFAULT_PARALLELISM)

    def set_parallelism(self, p: int) -> "StreamExecutionEnvironment":
        self.config.set(CoreOptions.DEFAULT_PARALLELISM, p)
        return self

    @property
    def max_parallelism(self) -> int:
        return self.config.get(CoreOptions.MAX_PARALLELISM)

    @property
    def window_layout(self) -> str:
        """state.window-layout: 'slots' | 'panes' | 'auto'."""
        return self.config.get(StateOptions.WINDOW_LAYOUT)

    @property
    def shuffle_mode(self) -> str:
        """shuffle.mode: 'device' (in-program keyBy exchange, default)
        | 'host' (the reference's bucketing into [P, B] blocks on the
        host)."""
        return self.config.get(DeploymentOptions.SHUFFLE_MODE)

    @property
    def state_backend(self) -> str:
        """state.backend: keyed-state placement (state/backends.py)."""
        return self.config.get(StateOptions.BACKEND)

    def enable_checkpointing(self, interval_ms: int
                             ) -> "StreamExecutionEnvironment":
        self.config.set(CheckpointOptions.INTERVAL_MS, interval_ms)
        return self

    @property
    def batch_size(self) -> int:
        return self._effective_config().get(BatchOptions.BATCH_SIZE)

    @property
    def state_slot_capacity(self) -> int:
        return self.config.get(StateOptions.SLOT_CAPACITY)

    @property
    def state_spill_options(self) -> dict:
        """The spill tier's options handed to keyed-state operators."""
        return {
            "max_device_slots": self.config.get(
                StateOptions.MAX_DEVICE_SLOTS),
            "spill_dir": self.config.get(StateOptions.SPILL_DIR),
            "spill_host_max_bytes": self.config.get(
                StateOptions.SPILL_HOST_MAX_BYTES),
        }

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

    def from_collection(self, rows, timestamp_field: Optional[str] = None,
                        watermark_strategy: Optional[
                            WatermarkStrategy] = None):
        """A source of ``rows`` (dicts) in micro-batches of the configured
        size; ``timestamp_field`` names their event-time column."""
        from flink_tpu_torch.connectors.sources import CollectionSource

        src = CollectionSource.of_rows(rows, batch_size=self.batch_size)
        ws = (watermark_strategy
              or WatermarkStrategy.for_monotonous_timestamps())
        if timestamp_field is not None:
            ws = ws.with_timestamp_field(timestamp_field)
        return self.add_source(src, ws, name="collection")

    def from_batches(self, batches: Sequence[RecordBatch],
                     watermark_strategy: Optional[
                         WatermarkStrategy] = None):
        """A source of the given batches, one per poll."""
        from flink_tpu_torch.connectors.sources import CollectionSource

        return self.add_source(CollectionSource(list(batches)),
                               watermark_strategy, name="batches")

    def get_stream_graph(self) -> StreamGraph:
        if not self._sinks:
            raise RuntimeError("no sinks defined — nothing to execute")
        return StreamGraph(self._sinks)

    def execute(self, job_name: str = "job",
                restore_from: Optional[str] = None,
                restore_mode: str = "no-claim") -> "JobExecutionResult":
        """Run the pipeline to completion on the local executor.
        ``restore_from`` points at a checkpoint root (its newest complete
        checkpoint wins) or directly at a savepoint / single checkpoint
        directory; ``restore_mode`` is "no-claim" (default: the artifact
        stays user-owned and untouched) or "claim" (the job deletes it
        once a newer checkpoint subsumes it). Without ``restore_from`` the
        ``FLINK_TPU_RESTORE_FROM`` / ``FLINK_TPU_RESTORE_MODE`` environment
        variables are honored, as in the reference."""
        import os

        from flink_tpu_torch.cluster.stage_executor import make_executor

        if restore_from is None:
            restore_from = os.environ.get("FLINK_TPU_RESTORE_FROM") or None
            restore_mode = os.environ.get("FLINK_TPU_RESTORE_MODE",
                                          restore_mode)
        graph = self.get_stream_graph()
        # execution.stage-parallelism expands the graph into source and
        # keyed subtasks wired by the shuffle SPI (cluster/stage_executor)
        result = make_executor(self._effective_config(), graph).run(
            graph, job_name=job_name, restore_from=restore_from,
            restore_mode=restore_mode)
        self._sinks = []
        self.last_execution_result = result
        return result


@public
class JobExecutionResult:
    def __init__(self, job_name: str, metrics: dict):
        self.job_name = job_name
        self.metrics = metrics
        #: MetricRegistry with the job's operator-scoped metrics
        self.registry = None
        #: TraceCollector with checkpoint/recovery spans
        self.traces = None
        #: a result that came back from a cluster carries the registry's
        #: snapshot and the spans as plain data instead
        #: (``cluster/minicluster.py`` ``_result_from_wire``)
        self.metric_snapshot = None
        self.spans = None

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"JobExecutionResult({self.job_name}, {self.metrics})"
