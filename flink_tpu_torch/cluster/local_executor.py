"""Local single-process executor (port of the execution loop of
``flink_tpu/cluster/local_executor.py``).

One thread owns the whole dataflow: sources are polled round-robin into
micro-batches, each batch is pushed depth-first through the operator DAG,
watermarks are min-merged per operator input. Window fires dispatched
asynchronously are harvested once their results land; until then the
operator's output watermark is held back, so a watermark never overtakes
the results it covers.

Not in this slice: source pump threads (sources are polled inline),
checkpoints and restore, control requests, autoscale, metrics registry,
tracing, chaos — see ROADMAP.md.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from flink_tpu_torch.core.config import (
    BatchOptions,
    Configuration,
    CoreOptions,
    DeploymentOptions,
    ExecutionOptions,
)
from flink_tpu_torch.graph.transformations import StreamGraph, Transformation
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.runtime.operators import Operator, OperatorContext
from flink_tpu_torch.runtime.watermarks import WatermarkValve


class _Node:
    __slots__ = ("transformation", "operator", "valve", "children",
                 "child_input_idx", "records_in", "records_out", "held_wm")

    def __init__(self, transformation: Transformation,
                 operator: Optional[Operator]):
        self.transformation = transformation
        self.operator = operator
        self.valve = WatermarkValve(max(len(transformation.inputs), 1))
        self.children: List[_Node] = []
        self.child_input_idx: List[int] = []
        self.records_in = 0
        self.records_out = 0
        #: watermark held back while the operator has in-flight fires
        self.held_wm: Optional[int] = None


def _quantile_sorted(data: List[float], q: float) -> float:
    if not data:
        return 0.0
    return data[min(len(data) - 1, int(q * len(data)))]


class LocalExecutor:
    def __init__(self, config: Optional[Configuration] = None):
        self.config = config or Configuration()

    def run(self, graph: StreamGraph, job_name: str = "job"):
        """Execute the graph to completion; returns a JobExecutionResult
        with throughput and fire-latency metrics."""
        from flink_tpu_torch.datastream.environment import JobExecutionResult

        cfg = self.config
        batch_size = cfg.get(BatchOptions.BATCH_SIZE)
        default_par = cfg.get(CoreOptions.DEFAULT_PARALLELISM)
        nodes: Dict[int, _Node] = {}
        sources = [(t, None) for t in graph.sources]
        try:
            for t in graph.nodes:
                op = t.operator_factory() if t.operator_factory else None
                node = _Node(t, op)
                nodes[t.uid] = node
                if op is not None:
                    # explicit set_parallelism wins; otherwise keyed
                    # operators pick up parallelism.default
                    par = t.parallelism if t.parallelism else (
                        default_par if t.keyed else 1)
                    op.open(OperatorContext(
                        parallelism=par,
                        max_parallelism=cfg.get(CoreOptions.MAX_PARALLELISM),
                        async_fires=cfg.get(BatchOptions.ASYNC_FIRES),
                        max_dispatch_ahead=cfg.get(
                            BatchOptions.MAX_DISPATCH_AHEAD),
                        shuffle_mode=cfg.get(DeploymentOptions.SHUFFLE_MODE),
                        device=cfg.get(ExecutionOptions.DEVICE)))
            for t in graph.nodes:
                n = nodes[t.uid]
                for child_t in graph.children(t):
                    n.children.append(nodes[child_t.uid])
                    n.child_input_idx.append(graph.input_index(t, child_t))
            sources = [(t, nodes[t.uid]) for t in graph.sources]
            generators = {}
            for t, _ in sources:
                t.source.open(0, 1)
                generators[t.uid] = t.watermark_strategy.create()

            t0 = time.perf_counter()
            total_records = 0
            active = {t.uid for t, _ in sources}
            while active:
                self._drain_pending(nodes)
                for t, node in sources:
                    if t.uid not in active:
                        continue
                    batch = t.source.poll_batch(batch_size)
                    if batch is None:
                        active.discard(t.uid)
                        self._emit_watermark(node, MAX_WATERMARK)
                        t.source.close()
                        continue
                    if len(batch) == 0:
                        continue
                    batch = t.watermark_strategy.assign_timestamps(batch)
                    wm = generators[t.uid].on_batch(batch)
                    total_records += len(batch)
                    self._emit_batch(node, batch)
                    if wm is not None:
                        self._emit_watermark(node, wm)
            self._drain_pending(nodes, wait=True)
            for t in graph.nodes:
                node = nodes[t.uid]
                if node.operator is not None:
                    for out in node.operator.close():
                        self._forward(node, out)
        except BaseException:
            # failure path: release resources without emitting
            for t, _ in sources:
                t.source.close()
            for node in nodes.values():
                if node.operator is not None:
                    node.operator.dispose()
            raise

        elapsed = time.perf_counter() - t0
        fire_latencies: List[float] = []
        for node in nodes.values():
            fire_latencies.extend(
                getattr(node.operator, "fire_latencies_ms", ()))
        metrics = {
            "records_emitted_by_sources": total_records,
            "runtime_s": elapsed,
            "records_per_s": total_records / elapsed if elapsed > 0 else 0.0,
            "per_operator": {
                f"{n.transformation.name}#{uid}": {
                    "records_in": n.records_in,
                    "records_out": n.records_out}
                for uid, n in nodes.items()},
        }
        if fire_latencies:
            fire_latencies.sort()
            metrics["window_fire_latency_ms"] = {
                "p50": _quantile_sorted(fire_latencies, 0.5),
                "p99": _quantile_sorted(fire_latencies, 0.99),
                "max": fire_latencies[-1],
                "count": len(fire_latencies),
            }
        return JobExecutionResult(job_name, metrics)

    # ------------------------------------------------------------- plumbing

    def _emit_batch(self, node: _Node, batch) -> None:
        for child, idx in zip(node.children, node.child_input_idx):
            self._process(child, batch, idx)

    def _emit_watermark(self, node: _Node, wm: int) -> None:
        for child, idx in zip(node.children, node.child_input_idx):
            self._process_watermark(child, wm, idx)

    def _process(self, node: _Node, batch, input_idx: int) -> None:
        node.records_in += len(batch)
        for out in node.operator.process_batch(batch, input_idx):
            self._forward(node, out)

    def _process_watermark(self, node: _Node, wm: int,
                           input_idx: int) -> None:
        advanced = node.valve.advance(input_idx, wm)
        if advanced is None:
            return
        for out in node.operator.process_watermark(advanced):
            self._forward(node, out)
        if node.operator.has_pending_output():
            # fires in flight: hold the watermark until they land
            node.held_wm = advanced
            return
        node.held_wm = None
        self._emit_watermark(node, advanced)

    def _drain_pending(self, nodes: Dict[int, _Node],
                       wait: bool = False) -> None:
        """Forward landed fire results and release held watermarks; with
        ``wait``, block until every pending output is drained."""
        while True:
            for node in nodes.values():
                op = node.operator
                if op is None:
                    continue
                if op.has_pending_output():
                    for out in op.poll_pending_output(wait=wait):
                        self._forward(node, out)
                if node.held_wm is not None and not op.has_pending_output():
                    wm = node.held_wm
                    node.held_wm = None
                    self._emit_watermark(node, wm)
            if not wait:
                return
            # a released watermark can cascade new fires downstream
            if not any(n.operator is not None
                       and (n.operator.has_pending_output()
                            or n.held_wm is not None)
                       for n in nodes.values()):
                return

    def _forward(self, node: _Node, batch) -> None:
        node.records_out += len(batch)
        self._emit_batch(node, batch)
