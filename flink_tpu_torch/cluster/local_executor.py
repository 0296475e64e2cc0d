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
state query or rescale request fails its future (item 12); requests
still queued when the job ends fail too.

Not in this slice: source pump threads (sources are polled inline),
state queries and rescale requests, restart strategies, autoscale,
managed memory, the metrics registry and tracing — see ROADMAP.md
(item 12).
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
    StateOptions,
    check_unread_keys,
)
from flink_tpu_torch.graph.transformations import StreamGraph, Transformation
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.runtime.operators import Operator, OperatorContext
from flink_tpu_torch.runtime.process import TaggedBatch
from flink_tpu_torch.runtime.watchdog import watchdog_from_config
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
    refused here, item 12)."""

    timeout_message = "state query not served"

    def __init__(self, operator_name: str, key, namespace=None):
        super().__init__()
        self.operator_name = operator_name
        self.key = key
        self.namespace = namespace


class RescaleRequest(_ControlRequest):
    """A live rescale of the job's mesh engine (served by the reference;
    refused here, item 12)."""

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


def _quantile_sorted(data: List[float], q: float) -> float:
    if not data:
        return 0.0
    return data[min(len(data) - 1, int(q * len(data)))]


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
                        device=cfg.get(ExecutionOptions.DEVICE),
                        window_layout=cfg.get(StateOptions.WINDOW_LAYOUT),
                        state_backend=cfg.get(StateOptions.BACKEND),
                        spill={
                            "max_device_slots": cfg.get(
                                StateOptions.MAX_DEVICE_SLOTS),
                            "spill_dir": cfg.get(StateOptions.SPILL_DIR),
                            "spill_host_max_bytes": cfg.get(
                                StateOptions.SPILL_HOST_MAX_BYTES),
                        },
                        pane_preagg=cfg.get(LatencyOptions.PANE_PREAGG),
                        watchdog=watchdog))
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
                checkpoint_count, claimed, last_written_id = self._restore(
                    graph, nodes, restore_from, restore_mode, ckpt_dir,
                    storage)
            source_positions: Dict[int, Any] = {
                t.uid: t.source.snapshot_position() for t, _ in sources}
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
                    batch = t.source.poll_batch(batch_size)
                    if batch is None:
                        active.discard(t.uid)
                        self._emit_watermark(node, MAX_WATERMARK)
                        t.source.close()
                        continue
                    if len(batch) == 0:
                        continue
                    progressed = True
                    batch = t.watermark_strategy.assign_timestamps(batch)
                    wm = generators[t.uid].on_batch(batch)
                    source_positions[t.uid] = t.source.snapshot_position()
                    batches_since_ckpt += 1
                    total_records += len(batch)
                    tb = time.perf_counter() if debloater else 0.0
                    if self._fire_deadline_ms > 0 and not batch_mode:
                        self._emit_deadline_split(node, batch, nodes, wm)
                    else:
                        self._emit_batch(node, batch)
                        if wm is not None and not batch_mode:
                            self._emit_watermark(node, wm)
                    if debloater is not None:
                        batch_size = debloater.observe(
                            len(batch), time.perf_counter() - tb)
                if not progressed and active:
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
                        new_dir = self._write_checkpoint(
                            graph, nodes, storage, checkpoint_count,
                            job_name, source_positions, use_delta,
                            last_written_id)
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
                        job_name, checkpoint_count, source_positions)
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
                "p50": _quantile_sorted(fire_latencies, 0.5),
                "p99": _quantile_sorted(fire_latencies, 0.99),
                "max": fire_latencies[-1],
                "count": len(fire_latencies),
            }
        return JobExecutionResult(job_name, metrics)

    # -------------------------------------------------------------- control

    def _serve_control(self, control_queue, graph, nodes, sources, active,
                       job_name: str, checkpoint_id: int,
                       source_positions) -> Optional[SavepointRequest]:
        """Serve the requests queued at this batch boundary; returns the
        savepoint request that stops the job, else None."""
        from flink_tpu_torch.checkpoint.savepoint import (
            check_savepoint_target,
            write_savepoint,
        )

        def stop_sources():
            for t, _ in sources:
                if t.uid in active:
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
                req.finish(None, NotImplementedError(
                    f"{type(req).__name__}: state queries and live rescale "
                    "are not ported to flink_tpu_torch yet (ROADMAP.md, "
                    "Queue A item 12); the port serves SavepointRequest"))
                continue
            try:
                # a bad target fails before anything irreversible: the job
                # keeps running
                check_savepoint_target(req.path)
                if req.stop and req.drain:
                    # fire every window and timer before the snapshot
                    for t, node in sources:
                        if t.uid in active:
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
        node.records_out += len(batch.batch if isinstance(batch, TaggedBatch)
                                else batch)
        self._emit_batch(node, batch)
