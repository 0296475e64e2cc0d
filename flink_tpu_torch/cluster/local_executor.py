"""Local single-process executor (port of the execution loop of
``flink_tpu/cluster/local_executor.py``).

One thread owns the whole dataflow: sources are polled round-robin into
micro-batches, each batch is pushed depth-first through the operator DAG,
watermarks are min-merged per operator input (a two-input operator, a
join, sees the smaller of its inputs' watermarks; one upstream may feed
several children, as Q7's source feeds both sides of its join). Window fires dispatched
asynchronously are harvested once their results land; until then the
operator's output watermark is held back, so a watermark never overtakes
the results it covers. With ``latency.fire-deadline-ms`` a source batch is
split against the budget at the measured per-record rate, with watermarks
and harvests between the splits (``_emit_deadline_split``). With
``execution.micro-batch.latency-target-ms`` the batch size follows the
measured throughput (``runtime/debloater.py``). Operators with
processing-time windows get a wall-clock tick every loop iteration.

``execution.runtime-mode=batch`` rejects unbounded sources at submit and
emits no intermediate watermark and no deadline split: every window fires
once, on the MAX_WATERMARK at source exhaustion. A reference key the port
does not read raises at submit when set to a value the port cannot honour
(``core/config.py`` ``check_unread_keys``).

Checkpoints: with ``state.checkpoints.dir`` and an every-n-batches or
interval trigger the loop cuts a checkpoint between source batches — in-
flight fires drained first, then every operator's state (full, or a delta
under ``execution.checkpointing.incremental``) and every source's consumed
position written through ``CheckpointStorage``, then retention.
``run(restore_from=...)`` restores the operators and source positions of
the newest checkpoint under a root (or of one snapshot directory) before
the first batch. The ``task.batch`` fault point sits where every operator
takes a batch.

``watchdog.enabled`` builds one device watchdog per job and attaches it to
every mesh engine; a shard it declares dead raises ``ShardFailedError``
out of ``execute()``, and ``result.metrics["watchdog"]`` holds its
counters.

Side outputs: a ``TaggedBatch`` goes only to the children on an edge with
its tag (``Transformation.side_tag``); a main output skips side edges.

Control requests: ``run(control_queue=...)`` serves ``SavepointRequest``s
between source batches. In-flight fires are drained and every operator's
state and source position is written with ``write_savepoint``; with
``stop=True`` the sources are stopped and closed and the job ends without
firing what is open (the operators are disposed: those windows resume
from the savepoint), and with ``drain=True`` as well every source first
advances to ``MAX_WATERMARK`` so every window and timer fires before the
snapshot. ``result.metrics["savepoint"]`` names a stop's savepoint. A
state query (item 12e) or rescale request (12g) fails its future; requests
still queued when the job ends fail too.

Source pumps: with ``execution.pipeline.in-flight-batches`` > 0 (default
2) each source is polled and timestamped by a thread of its own, a
bounded queue of that many batches ahead of the loop; each entry carries
the position after its batch, so a checkpoint cut covers exactly the
consumed prefix.

Observability: every job builds a ``MetricRegistry`` and a
``TraceCollector`` (``result.registry``, ``result.traces``): per operator
``numRecordsIn/Out``, ``currentInputWatermark``, ``busyTimeMsTotal``,
event-time latency markers and watermark lag, the ``state`` group from
``spill_counters()``, the ``window`` group's fire-latency percentiles and
``numLateRecordsDropped`` where an operator counts late records; the
chaos and watchdog groups when armed, and the flight recorder's per-kind
aggregates at the registry root. ``memory.device.size`` > 0 makes one
``MemoryManager`` the pool every stateful operator reserves from.

Not in this slice: state queries (ROADMAP.md Queue A item 12e), rescale
requests and autoscale (12g), restart strategies (12c), and the
``key_imbalance`` gauge (12g).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.core.config import (
    BatchOptions,
    CheckpointOptions,
    Configuration,
    CoreOptions,
    DeploymentOptions,
    ExecutionModeOptions,
    ExecutionOptions,
    LatencyOptions,
    MemoryOptions,
    StateOptions,
    check_unread_keys,
)
from flink_tpu_torch.graph.transformations import StreamGraph, Transformation
from flink_tpu_torch.metrics.core import quantile_sorted
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.runtime.operators import Operator, OperatorContext
from flink_tpu_torch.runtime.process import TaggedBatch
from flink_tpu_torch.runtime.watchdog import watchdog_from_config
from flink_tpu_torch.runtime.watermarks import WatermarkValve


class _Node:
    __slots__ = ("transformation", "operator", "valve", "children",
                 "child_input_idx", "records_in", "records_out", "held_wm",
                 "busy_s", "marker_hist")

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
        #: wall seconds inside this operator's hooks (busyTimeMsTotal)
        self.busy_s = 0.0
        #: the operator's latency-marker histogram
        self.marker_hist = None


class _ControlRequest:
    """Completion plumbing shared by the task loop's control requests: the
    loop completes one with ``finish(result, error)``, the client blocks
    in ``wait``."""

    timeout_message = "control request not served"

    def __init__(self):
        self.result = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def finish(self, result, error=None) -> None:
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(self.timeout_message)
        if self.error is not None:
            raise self.error
        return self.result


class StateQueryRequest(_ControlRequest):
    """A point lookup of an operator's state (served by the reference;
    refused here, item 12e)."""

    timeout_message = "state query not served"

    def __init__(self, operator_name: str, key, namespace=None):
        super().__init__()
        self.operator_name = operator_name
        self.key = key
        self.namespace = namespace


class RescaleRequest(_ControlRequest):
    """A live rescale of the job's mesh engine (served by the reference;
    refused here, item 12g)."""

    timeout_message = "rescale not served"

    def __init__(self, new_shards: int):
        super().__init__()
        self.new_shards = int(new_shards)


class SavepointRequest(_ControlRequest):
    """A savepoint, or with ``stop`` a stop-with-savepoint (``drain``:
    fire everything first), served between source batches."""

    def __init__(self, path: str, stop: bool = False, drain: bool = False):
        super().__init__()
        self.path = path
        self.stop = stop
        self.drain = drain
        self.timeout_message = f"savepoint {path!r} not completed"

    @property
    def result_path(self) -> Optional[str]:
        return self.result


class _SourcePump:
    """Bounded-prefetch source reader: a thread that polls one source,
    assigns timestamps and watermarks, and hands (batch, watermark,
    position) entries to the task loop through a bounded queue.

    The queue bound IS the backpressure (credit-based flow control,
    reference: RemoteInputChannel.java:114 unannouncedCredit — here a
    credit is a queue slot). Each entry carries the source position taken
    AFTER that batch, so a checkpoint cut at batch boundary N snapshots
    exactly the consumed prefix — prefetched-but-unprocessed batches are
    re-read after restore.

    The pump owns the source object while running (single-owner
    discipline); the task loop touches the source only after ``stop()``.
    """

    _EOS = object()

    def __init__(self, transformation, batch_size: int, in_flight: int):
        self.t = transformation
        self.batch_size = batch_size
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(in_flight, 1))
        self.wm_gen = transformation.watermark_strategy.create()
        self._stop = threading.Event()    # stop reading new batches
        self._abort = threading.Event()   # discard mode: puts give up
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=f"source-pump-{transformation.name}",
            daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _put(self, item) -> bool:
        # an already-polled batch advanced the source position, so it must
        # reach the consumer unless the job is abandoning data outright
        # (_abort); a mere stop_filling keeps trying while the drain path
        # consumes
        while not self._abort.is_set():
            try:
                self.queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        src = self.t.source
        strategy = self.t.watermark_strategy
        try:
            while not self._stop.is_set():
                # batch_size is re-read each poll: the adaptive controller
                # on the task loop may resize it (benign cross-thread read)
                batch = src.poll_batch(self.batch_size)
                if batch is None:
                    self._put((self._EOS, None, src.snapshot_position()))
                    return
                if len(batch) == 0:
                    continue
                batch = strategy.assign_timestamps(batch)
                wm = self.wm_gen.on_batch(batch)
                pos = src.snapshot_position()
                if not self._put((batch, wm, pos)):
                    return
        except BaseException as e:  # noqa: BLE001 - surfaced to task loop
            self.error = e
            self._put((self._EOS, None, None))

    def poll(self, timeout: float = 0.0):
        """One queue entry or None. Raises the pump's error, if any."""
        try:
            entry = self.queue.get(timeout=timeout) if timeout \
                else self.queue.get_nowait()
        except queue.Empty:
            return None
        if entry[0] is self._EOS and self.error is not None:
            raise self.error
        return entry

    def stop_filling(self) -> None:
        """Stop reading new batches; already-queued entries stay consumable
        (the drain path processes them before the final snapshot)."""
        self._stop.set()

    def consume_remaining(self):
        """Yield the queued entries after ``stop_filling`` until the pump
        thread has exited and the queue is empty."""
        while self._thread.is_alive() or not self.queue.empty():
            try:
                yield self.queue.get(timeout=0.05)
            except queue.Empty:
                continue

    def stop(self) -> None:
        """Hard stop: discard prefetched entries (no-drain paths — the
        consumed-prefix position makes dropped entries re-readable)."""
        self._stop.set()
        self._abort.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


def operator_context(cfg: Configuration, parallelism: int,
                     async_fires: Optional[bool] = None,
                     **kwargs) -> OperatorContext:
    """The context an operator opens with, from the job's configuration
    (``kwargs``: ``operator_index``, ``watchdog``, ``memory_manager``,
    ``key_group_range``)."""
    return OperatorContext(
        parallelism=parallelism,
        max_parallelism=cfg.get(CoreOptions.MAX_PARALLELISM),
        async_fires=(cfg.get(BatchOptions.ASYNC_FIRES)
                     if async_fires is None else async_fires),
        max_dispatch_ahead=cfg.get(BatchOptions.MAX_DISPATCH_AHEAD),
        shuffle_mode=cfg.get(DeploymentOptions.SHUFFLE_MODE),
        device=cfg.get(ExecutionOptions.DEVICE),
        window_layout=cfg.get(StateOptions.WINDOW_LAYOUT),
        state_backend=cfg.get(StateOptions.BACKEND),
        spill={
            "max_device_slots": cfg.get(StateOptions.MAX_DEVICE_SLOTS),
            "spill_dir": cfg.get(StateOptions.SPILL_DIR),
            "spill_host_max_bytes": cfg.get(
                StateOptions.SPILL_HOST_MAX_BYTES),
        },
        pane_preagg=cfg.get(LatencyOptions.PANE_PREAGG),
        **kwargs)


class LocalExecutor:
    def __init__(self, config: Optional[Configuration] = None):
        self.config = config or Configuration()

    def run(self, graph: StreamGraph, job_name: str = "job",
            restore_from: Optional[str] = None,
            restore_mode: str = "no-claim",
            control_queue: Optional["queue.Queue"] = None):
        """Execute the graph to completion; returns a JobExecutionResult
        with throughput, fire-latency and checkpoint metrics.
        ``restore_from``: a checkpoint root (its newest checkpoint) or one
        snapshot directory; ``restore_mode``: "no-claim" or "claim";
        ``control_queue``: a queue of ``SavepointRequest``s served between
        source batches."""
        from flink_tpu_torch.datastream.environment import JobExecutionResult

        cfg = self.config
        # a reference key set to a value the port cannot honour fails the
        # submit, naming its ROADMAP item
        check_unread_keys(cfg)
        batch_size = cfg.get(BatchOptions.BATCH_SIZE)
        # batch mode: no intermediate watermark, so every window fires
        # exactly once, on the MAX_WATERMARK at source exhaustion
        batch_mode = cfg.get(ExecutionModeOptions.RUNTIME_MODE) == "batch"
        if batch_mode:
            for t in graph.sources:
                if not getattr(t.source, "bounded", True):
                    raise RuntimeError(
                        "execution.runtime-mode=batch requires bounded "
                        f"sources; {t.name!r} is unbounded (reference: "
                        "batch mode rejects unbounded sources)")
        default_par = cfg.get(CoreOptions.DEFAULT_PARALLELISM)
        self._chaos_job = job_name
        ckpt_interval = cfg.get(CheckpointOptions.INTERVAL_MS)
        ckpt_every_n = cfg.get(CheckpointOptions.EVERY_N_BATCHES)
        ckpt_dir = cfg.get(StateOptions.CHECKPOINT_DIR)
        storage = None
        if ckpt_dir and (ckpt_interval or ckpt_every_n):
            from flink_tpu_torch.checkpoint.storage import CheckpointStorage

            storage = CheckpointStorage(
                ckpt_dir, compress=cfg.get(CheckpointOptions.COMPRESSION))
        #: per checkpoint written: id, incremental, bytes, write ms
        self.checkpoints: List[Dict[str, Any]] = []
        self.restore_ms = 0.0
        # the device watchdog (watchdog.enabled): one per job, attached to
        # every mesh engine through the operator context; a
        # ShardFailedError it raises leaves execute() (the shard-granular
        # recovery protocol is chaos.harness.run_shard_loss_verify)
        watchdog = watchdog_from_config(cfg, default_par)
        # metrics and traces: the job's metric tree, its checkpoint and
        # recovery spans, and the flight recorder named for this job
        from flink_tpu_torch.metrics import MetricRegistry, TraceCollector
        from flink_tpu_torch.observe.export import (
            LatencyMarkerPlane,
            register_flight_metrics,
        )

        registry = MetricRegistry()
        traces = TraceCollector()
        job_group = registry.root_group("job", job_name)
        chaos.register_chaos_metrics(job_group)
        flight.set_job(job_name)
        # the flight aggregates are process-global (one recorder for
        # every job of the process): they sit at the registry root
        register_flight_metrics(registry.root_group())
        # each source batch is the latency marker
        lat_plane = self._lat_plane = LatencyMarkerPlane()
        if watchdog is not None:
            watchdog.register_metrics(job_group)
        memory_manager = None
        if cfg.get(MemoryOptions.DEVICE_MEMORY_BUDGET) > 0:
            from flink_tpu_torch.core.memory import MemoryManager

            # one pool per job: every stateful operator's device state
            # reserves from it
            memory_manager = MemoryManager(
                cfg.get(MemoryOptions.DEVICE_MEMORY_BUDGET))
        self.memory_manager = memory_manager
        nodes: Dict[int, _Node] = {}
        sources = [(t, None) for t in graph.sources]
        pumps: Dict[int, _SourcePump] = {}
        try:
            for t in graph.nodes:
                op = t.operator_factory() if t.operator_factory else None
                node = _Node(t, op)
                nodes[t.uid] = node
                self._register_node_metrics(job_group, lat_plane, node)
                if op is not None:
                    # explicit set_parallelism wins; otherwise keyed
                    # operators pick up parallelism.default
                    par = t.parallelism if t.parallelism else (
                        default_par if t.keyed else 1)
                    op.open(operator_context(
                        cfg, par, watchdog=watchdog,
                        memory_manager=memory_manager))
                    self._register_operator_metrics(job_group, node)
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

            checkpoint_count = 0
            claimed = None
            # a delta may build on the restored checkpoint only when it is
            # the job's OWN chk-<id> (a savepoint inside the root is not:
            # its id would alias a sibling checkpoint)
            last_written_id = None
            if restore_from is not None:
                with flight.span("checkpoint.restore"), \
                        traces.span("recovery", "restore") as rsp:
                    checkpoint_count, claimed, last_written_id = \
                        self._restore(graph, nodes, restore_from,
                                      restore_mode, ckpt_dir, storage)
                    rsp.set_attribute("checkpointId", checkpoint_count)
            source_positions: Dict[int, Any] = {
                t.uid: t.source.snapshot_position() for t, _ in sources}
            # host/device overlap: pump threads poll and timestamp the
            # next batches while this loop drives the current one
            in_flight = cfg.get(BatchOptions.IN_FLIGHT_BATCHES)
            if in_flight > 0:
                for t, _ in sources:
                    pumps[t.uid] = _SourcePump(t, batch_size, in_flight)
                for pump in pumps.values():
                    pump.start()
            # records prefetched but not yet processed (the backlog)
            job_group.gauge(
                "sourceBacklogRecordsEstimate",
                lambda: sum(pump.queue.qsize() * pump.batch_size
                            for pump in pumps.values()))
            batches_since_ckpt = 0
            last_ckpt = time.time() * 1000
            incremental = cfg.get(CheckpointOptions.INCREMENTAL)
            full_every = max(cfg.get(CheckpointOptions.FULL_EVERY), 1)
            since_full = 0

            #: fire-deadline splitting (latency.fire-deadline-ms), sized by
            #: an EMA of the records/s through the dataflow
            self._fire_deadline_ms = cfg.get(LatencyOptions.FIRE_DEADLINE_MS)
            self._deadline_rate = 0.0
            debloater = None
            latency_target = cfg.get(BatchOptions.LATENCY_TARGET_MS)
            if latency_target > 0:
                from flink_tpu_torch.runtime.debloater import (
                    BatchSizeController,
                )

                debloater = BatchSizeController(
                    initial=batch_size,
                    min_size=cfg.get(BatchOptions.MIN_BATCH_SIZE),
                    max_size=batch_size,
                    target_latency_ms=latency_target)
                batch_size = debloater.size
            # wall-clock tick targets (processing-time windows)
            pt_nodes = [n for n in nodes.values()
                        if n.operator is not None
                        and getattr(n.operator, "uses_processing_time",
                                    False)]
            t0 = time.perf_counter()
            total_records = 0
            savepoint_path = None
            suppress_final_drain = False
            active = {t.uid for t, _ in sources}
            while active:
                self._drain_pending(nodes)
                if pt_nodes:
                    now_ms = int(time.time() * 1000)
                    for n in pt_nodes:
                        for out in n.operator.on_processing_time(now_ms):
                            self._forward(n, out)
                progressed = False
                for t, node in sources:
                    if t.uid not in active:
                        continue
                    if pumps:
                        entry = pumps[t.uid].poll(
                            timeout=0.002 if not progressed else 0.0)
                        if entry is None:
                            continue
                        batch, wm, pos = entry
                        if batch is _SourcePump._EOS:
                            active.discard(t.uid)
                            if pos is not None:
                                source_positions[t.uid] = pos
                            self._emit_watermark(node, MAX_WATERMARK)
                            t.source.close()
                            continue
                    else:
                        batch = t.source.poll_batch(batch_size)
                        if batch is None:
                            active.discard(t.uid)
                            self._emit_watermark(node, MAX_WATERMARK)
                            t.source.close()
                            continue
                        if len(batch) == 0:
                            continue
                        batch = t.watermark_strategy.assign_timestamps(
                            batch)
                        wm = generators[t.uid].on_batch(batch)
                        pos = t.source.snapshot_position()
                    progressed = True
                    source_positions[t.uid] = pos
                    batches_since_ckpt += 1
                    total_records += len(batch)
                    tb = time.perf_counter() if debloater else 0.0
                    # this batch IS the latency marker; it dies with the
                    # synchronous push (later drains are not its latency)
                    lat_plane.stamp_source()
                    if wm is not None and not batch_mode:
                        lat_plane.note_source_watermark(int(wm),
                                                        source=t.uid)
                    try:
                        if self._fire_deadline_ms > 0 and not batch_mode:
                            self._emit_deadline_split(node, batch, nodes,
                                                      wm)
                        else:
                            self._emit_batch(node, batch)
                            if wm is not None and not batch_mode:
                                self._emit_watermark(node, wm)
                    finally:
                        lat_plane.end_marker()
                    if debloater is not None:
                        batch_size = debloater.observe(
                            len(batch), time.perf_counter() - tb)
                        for pump in pumps.values():
                            pump.batch_size = batch_size
                if not progressed and active and not pumps:
                    # an idle source (a socket without data): do not spin
                    time.sleep(0.001)
                if storage is not None:
                    if ckpt_every_n:
                        due = batches_since_ckpt >= ckpt_every_n
                    else:
                        due = (time.time() * 1000 - last_ckpt
                               >= ckpt_interval)
                    if due:
                        checkpoint_count += 1
                        use_delta = (incremental
                                     and last_written_id is not None
                                     and since_full < full_every)
                        with flight.span("checkpoint.write"), traces.span(
                                "checkpoint",
                                f"checkpoint-{checkpoint_count}") as sp:
                            new_dir = self._write_checkpoint(
                                graph, nodes, storage, checkpoint_count,
                                job_name, source_positions, use_delta,
                                last_written_id)
                            sp.set_attribute("checkpointId",
                                             checkpoint_count)
                            sp.set_attribute("incremental", use_delta)
                            sp.set_attribute(
                                "stateSizeBytes",
                                self.checkpoints[-1]["bytes"])
                        last_written_id = checkpoint_count
                        since_full = since_full + 1 if use_delta else 1
                        if claimed is not None:
                            claimed.on_checkpoint_complete(new_dir)
                        # checkpoint durable -> two-phase sinks publish
                        # (notifyCheckpointComplete -> commit)
                        for node in nodes.values():
                            op = node.operator
                            if op is not None and hasattr(
                                    op, "notify_checkpoint_complete"):
                                op.notify_checkpoint_complete(
                                    checkpoint_count)
                        storage.retain(cfg.get(StateOptions.NUM_RETAINED))
                        last_ckpt = time.time() * 1000
                        batches_since_ckpt = 0
                if control_queue is not None:
                    stopped = self._serve_control(
                        control_queue, graph, nodes, sources, active,
                        job_name, checkpoint_count, source_positions,
                        pumps)
                    if stopped is not None:
                        savepoint_path = stopped.result_path
                        suppress_final_drain = not stopped.drain
                        break
            self._drain_pending(nodes, wait=True)
            if suppress_final_drain:
                # a stop without drain: the savepoint holds what is open;
                # release without emitting
                for node in nodes.values():
                    if node.operator is not None:
                        node.operator.dispose()
            else:
                for t in graph.nodes:
                    node = nodes[t.uid]
                    if node.operator is not None:
                        for out in node.operator.close():
                            self._forward(node, out)
            self._fail_pending_controls(
                control_queue, f"job {job_name!r} already terminated")
        except BaseException:
            # failure path: release resources without emitting
            for pump in pumps.values():
                pump.stop()
            for t, _ in sources:
                t.source.close()
            for node in nodes.values():
                if node.operator is not None:
                    node.operator.dispose()
            self._fail_pending_controls(
                control_queue, f"job {job_name!r} terminated abnormally")
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
                    "records_out": n.records_out,
                    **(n.operator.counters()
                       if hasattr(n.operator, "counters") else {})}
                for uid, n in nodes.items()},
        }
        if getattr(self, "fallback_reason", None):
            # execution.stage-parallelism was asked for and the graph could
            # not be expanded (execution.stage-fallback)
            metrics["stage_fallback"] = self.fallback_reason
        if watchdog is not None:
            # the numbers the reference's job.<name>.watchdog gauges read
            metrics["watchdog"] = watchdog.counters()
        if savepoint_path is not None:
            metrics["savepoint"] = savepoint_path
        if self.checkpoints or restore_from is not None:
            metrics["checkpoints"] = list(self.checkpoints)
            metrics["restore_ms"] = self.restore_ms
        if fire_latencies:
            fire_latencies.sort()
            metrics["window_fire_latency_ms"] = {
                "p50": quantile_sorted(fire_latencies, 0.5),
                "p99": quantile_sorted(fire_latencies, 0.99),
                "max": fire_latencies[-1],
                "count": len(fire_latencies),
            }
        result = JobExecutionResult(job_name, metrics)
        result.registry = registry
        result.traces = traces
        return result

    # -------------------------------------------------------------- metrics

    @staticmethod
    def _register_node_metrics(job_group, lat_plane, node: _Node) -> None:
        """Every node's task I/O gauges under ``job.<name>.<op>#<uid>``."""
        t = node.transformation
        g = job_group.add_group(f"{t.name}#{t.uid}")
        g.gauge("numRecordsIn", lambda n=node: n.records_in)
        g.gauge("numRecordsOut", lambda n=node: n.records_out)
        g.gauge("currentInputWatermark", lambda n=node: n.valve.combined)
        g.gauge("busyTimeMsTotal", lambda n=node: n.busy_s * 1000.0)
        if node.operator is not None:
            # the marker histogram and the watermark lag behind the
            # sources' frontier, under <op>.latency
            node.marker_hist = lat_plane.operator_group(
                g, f"{t.name}#{t.uid}", lambda n=node: n.valve.combined)

    @staticmethod
    def _register_operator_metrics(job_group, node: _Node) -> None:
        """An opened operator's ``state`` and ``window`` groups and its
        late-record count, where it has them."""
        op = node.operator
        t = node.transformation
        g = job_group.add_group(f"{t.name}#{t.uid}")
        if hasattr(op, "spill_counters"):
            counters = op.spill_counters()
            if counters is not None:
                sg = g.add_group("state")
                for cname in counters:
                    sg.gauge(cname,
                             lambda o=op, c=cname:
                             (o.spill_counters() or {}).get(c, 0))
                sg.gauge("resident_rows_per_shard",
                         lambda o=op: list(o.shard_resident_rows()))
                sg.gauge("resident_rows",
                         lambda o=op: sum(o.shard_resident_rows()))
        if hasattr(op, "fire_latencies_ms"):
            wg = g.add_group("window")
            wg.gauge("fireLatencyP50Ms",
                     lambda o=op: quantile_sorted(
                         sorted(o.fire_latencies_ms), 0.5))
            wg.gauge("fireLatencyP99Ms",
                     lambda o=op: quantile_sorted(
                         sorted(o.fire_latencies_ms), 0.99))
            wg.gauge("fireCount",
                     lambda o=op: getattr(o, "fires_total",
                                          len(o.fire_latencies_ms)))
        if hasattr(op, "late_records_dropped"):
            g.gauge("numLateRecordsDropped",
                    lambda o=op: o.late_records_dropped)

    # -------------------------------------------------------------- control

    def _serve_control(self, control_queue, graph, nodes, sources, active,
                       job_name: str, checkpoint_id: int,
                       source_positions, pumps) -> Optional[SavepointRequest]:
        """Serve the requests queued at this batch boundary; returns the
        savepoint request that stops the job, else None."""
        from flink_tpu_torch.checkpoint.savepoint import (
            check_savepoint_target,
            write_savepoint,
        )

        def stop_sources():
            # a pump owns its source while it runs: stop it, then close
            for t, _ in sources:
                if t.uid in active:
                    if t.uid in pumps:
                        pumps[t.uid].stop()
                    t.source.close()
            active.clear()

        # at most the requests already queued: a client re-submitting
        # must not starve the data path
        for _ in range(max(control_queue.qsize(), 1)):
            try:
                req = control_queue.get_nowait()
            except queue.Empty:
                return None
            if not isinstance(req, SavepointRequest):
                item = "12g" if isinstance(req, RescaleRequest) else "12e"
                req.finish(None, NotImplementedError(
                    f"{type(req).__name__}: state queries and live rescale "
                    "are not ported to flink_tpu_torch yet (ROADMAP.md, "
                    f"Queue A item {item}); the port serves "
                    "SavepointRequest"))
                continue
            try:
                # a bad target fails before anything irreversible: the job
                # keeps running
                check_savepoint_target(req.path)
                if req.stop and req.drain:
                    # the pumps' prefetched batches first (their positions
                    # are consumed from the source), then fire every
                    # window and timer before the snapshot
                    for t, node in sources:
                        if t.uid not in active:
                            continue
                        pump = pumps.get(t.uid)
                        if pump is not None:
                            pump.stop_filling()
                            for batch, _wm, pos in pump.consume_remaining():
                                if pos is not None:
                                    source_positions[t.uid] = pos
                                if batch is not _SourcePump._EOS:
                                    self._emit_batch(node, batch)
                            if pump.error is not None:
                                # a failed source is no clean end of input
                                raise pump.error
                        self._emit_watermark(node, MAX_WATERMARK)
                    stop_sources()
                self._drain_pending(nodes, wait=True)
                snap = self.snapshot_all(graph, nodes, source_positions,
                                         savepoint=True)
                path = write_savepoint(req.path, job_name, snap,
                                       checkpoint_id=checkpoint_id)
                if req.stop and not req.drain:
                    stop_sources()
                req.finish(path)
            except Exception as e:  # reported to the requester
                req.finish(None, e)
                continue
            if req.stop:
                return req
        return None

    @staticmethod
    def _fail_pending_controls(control_queue, reason: str) -> None:
        """Complete the requests still queued so that no client blocks on
        a job that has ended."""
        if control_queue is None:
            return
        while True:
            try:
                req = control_queue.get_nowait()
            except queue.Empty:
                return
            req.finish(None, RuntimeError(reason))

    # ---------------------------------------------------------- checkpoints

    def _restore(self, graph, nodes, restore_from, restore_mode, ckpt_dir,
                 storage):
        """Restore every operator and source position from ``restore_from``;
        returns (the id new checkpoints count on from, the claim tracker,
        the id a delta may build on or None)."""
        from flink_tpu_torch.checkpoint.savepoint import prepare_restore
        from flink_tpu_torch.checkpoint.storage import (
            read_checkpoint_chain,
            read_manifest,
        )

        t0 = time.perf_counter()
        snap_dir, claimed = prepare_restore(restore_from, restore_mode,
                                            own_checkpoint_root=ckpt_dir)
        states = read_checkpoint_chain(snap_dir)
        self._restore_all(graph, nodes, states)
        self.restore_ms = (time.perf_counter() - t0) * 1e3
        restored_id = int(read_manifest(snap_dir)["checkpoint_id"])
        restored_in_root = bool(ckpt_dir) and (
            os.path.dirname(os.path.abspath(snap_dir))
            == os.path.abspath(ckpt_dir)) and (
            os.path.basename(snap_dir) == f"chk-{restored_id}")
        count = restored_id
        if storage is not None:
            # the root may hold higher-numbered checkpoints of an abandoned
            # timeline: ids stay monotonic, so new checkpoints supersede
            # them instead of being retained away
            count = max(count, storage.latest_checkpoint_id() or 0)
        base = (restored_id if storage is not None and restored_in_root
                else None)
        return count, claimed, base

    def _write_checkpoint(self, graph, nodes, storage, checkpoint_id: int,
                          job_name: str, source_positions, use_delta: bool,
                          base_id: Optional[int]) -> str:
        # in-flight fire results reach their sinks before the cut: the
        # bookkeeper already marked those windows fired
        self._drain_pending(nodes, wait=True)
        t0 = time.perf_counter()
        snap = self.snapshot_all(graph, nodes, source_positions,
                                 delta=use_delta)
        extra = ({"incremental": True, "base": base_id}
                 if use_delta else None)
        new_dir = storage.write_checkpoint(checkpoint_id, job_name, snap,
                                           extra=extra)
        self.checkpoints.append({
            "id": checkpoint_id,
            "incremental": bool(use_delta),
            "bytes": sum(e.stat().st_size for e in os.scandir(new_dir)
                         if e.is_file()),
            "write_ms": (time.perf_counter() - t0) * 1e3,
        })
        return new_dir

    @staticmethod
    def snapshot_all(graph: StreamGraph, nodes: Dict[int, _Node],
                     source_positions: Optional[Dict[int, Any]] = None,
                     delta: bool = False,
                     savepoint: bool = False) -> Dict[str, Any]:
        """Every stateful operator's state and every source's position,
        keyed by ``graph.stable_id``."""
        snap: Dict[str, Any] = {}
        for uid, node in nodes.items():
            t = node.transformation
            op = node.operator
            if op is None:
                # the CONSUMED prefix: the cut is the batch boundary
                if source_positions is not None and uid in source_positions:
                    state = {"source": source_positions[uid]}
                else:
                    state = {"source": t.source.snapshot_position()}
            elif delta and hasattr(op, "snapshot_state_delta"):
                state = op.snapshot_state_delta()
            elif savepoint and hasattr(op, "snapshot_state_savepoint"):
                state = op.snapshot_state_savepoint()
            else:
                state = op.snapshot_state()
            if state:
                snap[graph.stable_id(t)] = state
        return snap

    @staticmethod
    def _restore_all(graph: StreamGraph, nodes: Dict[int, _Node],
                     states: Dict[str, Any]) -> None:
        consumed = set()
        for uid, node in nodes.items():
            t = node.transformation
            sid = graph.stable_id(t)
            state = states.get(sid)
            if state is None:
                continue
            consumed.add(sid)
            if node.operator is None:
                t.source.restore_position(state["source"])
            else:
                node.operator.restore_state(state)
        leftover = set(states) - consumed
        if leftover:
            # silently dropping state would undercount aggregates after a
            # graph edit: fail like the reference
            raise RuntimeError(
                "checkpoint contains state for operators not present in the "
                f"graph (graph changed since snapshot?): {sorted(leftover)}")

    # --------------------------------------------- fire-deadline splitting

    def _deadline_observe(self, n: int, dt: float) -> None:
        """Fold one emitted chunk into the per-record rate EMA."""
        if dt <= 1e-6 or n <= 0:
            return
        inst = n / dt
        self._deadline_rate = inst if self._deadline_rate <= 0 else (
            0.7 * self._deadline_rate + 0.3 * inst)

    def _emit_deadline_split(self, node: _Node, batch, nodes,
                             wm: Optional[int]) -> None:
        """Split one source batch so each push fits latency.fire-deadline-ms
        at the measured rate, advancing the watermark between the splits
        and harvesting landed fires. After chunk i the watermark is
        ``min(final, min timestamp of the remaining records - 1)``: no
        remaining record is late against it and no window fires before
        its last record arrived, so the rows and their order are the
        unsplit run's."""
        n = len(batch)
        rate = self._deadline_rate
        chunk = n if rate <= 0 else max(
            int(rate * self._fire_deadline_ms / 1000.0), 256)
        if chunk >= n:
            t0 = time.perf_counter()
            self._emit_batch(node, batch)
            self._deadline_observe(n, time.perf_counter() - t0)
            if wm is not None:
                self._emit_watermark(node, wm)
            return
        suffix_min = None
        if wm is not None and batch.has_timestamps:
            ts = np.asarray(batch.timestamps)
            suffix_min = np.minimum.accumulate(ts[::-1])[::-1]
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            t0 = time.perf_counter()
            self._emit_batch(node, batch.slice(a, b))
            self._deadline_observe(b - a, time.perf_counter() - t0)
            if b < n:
                if suffix_min is not None:
                    self._emit_watermark(
                        node, min(int(wm), int(suffix_min[b]) - 1))
                self._drain_pending(nodes)
        if wm is not None:
            self._emit_watermark(node, wm)

    # ------------------------------------------------------------- plumbing

    def _emit_batch(self, node: _Node, batch) -> None:
        """Route an output: a TaggedBatch only to the side edges with its
        tag, a main output only to the other edges."""
        tag = batch.tag.name if isinstance(batch, TaggedBatch) else None
        payload = batch.batch if tag is not None else batch
        for child, idx in zip(node.children, node.child_input_idx):
            if child.transformation.side_tag == tag:
                self._process(child, payload, idx)

    def _emit_watermark(self, node: _Node, wm: int) -> None:
        for child, idx in zip(node.children, node.child_input_idx):
            self._process_watermark(child, wm, idx)

    def _process(self, node: _Node, batch, input_idx: int) -> None:
        # chaos: a task crash mid-batch — surfaces through the normal
        # failure path (the job fails; a restore resumes it)
        chaos.fault_point("task.batch", op=node.transformation.name,
                          job=getattr(self, "_chaos_job", None))
        node.records_in += len(batch)
        t0 = time.perf_counter()
        with flight.span("op.process"):
            outs = node.operator.process_batch(batch, input_idx)
        node.busy_s += time.perf_counter() - t0
        if node.marker_hist is not None:
            self._lat_plane.observe(node.marker_hist)
        for out in outs:
            self._forward(node, out)

    def _process_watermark(self, node: _Node, wm: int,
                           input_idx: int) -> None:
        advanced = node.valve.advance(input_idx, wm)
        if advanced is None:
            return
        t0 = time.perf_counter()
        with flight.span("op.watermark", watermark=int(advanced)):
            outs = node.operator.process_watermark(advanced)
        node.busy_s += time.perf_counter() - t0
        for out in outs:
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
        node.records_out += len(batch.batch if isinstance(batch, TaggedBatch)
                                else batch)
        # an instant: the push below recurses through the whole subtree,
        # whose time the operators' own spans hold
        flight.instant("emit")
        self._emit_batch(node, batch)
