"""MiniCluster — dispatcher / resource manager / task executors over real RPC
(port of ``flink_tpu/cluster/minicluster.py``).

reference: runtime/minicluster/MiniCluster.java runs Dispatcher + RM + N
TaskExecutors in one JVM with real RPC and real checkpoints (SURVEY.md §4
tier 3 — this is how the reference tests "multi-node" without a cluster);
Dispatcher.submitJob (runtime/dispatcher/Dispatcher.java:586), per-job
JobMaster (runtime/jobmaster/JobMaster.java:1263 startScheduling), slot
brokering (resourcemanager/ResourceManager.java), heartbeats
(runtime/heartbeat/HeartbeatManagerImpl.java), region failover + restart
backoff (executiongraph/failover/*).

Re-design: the same three roles as RPC endpoints (``cluster/rpc.py``, TCP
sockets) in one process. A job's dataflow is one failover region
(pipelined whole-graph restart — the reference's behavior for
fully-pipelined streaming jobs); recovery restores the latest completed
checkpoint. Job graphs travel through the wire pickled by the RPC
serializer (the user's lambdas and closures by value), like the reference
ships serialized JobGraphs through Pekko. A TaskExecutor runs each
deployment with the job's own configuration, so the job's
``execution.device`` (the card unless it says ``cpu``) is where its state
lives. Point queries (``query_state(_batch)``) travel Dispatcher ->
JobMaster -> TaskExecutor -> the task's control queue, where the executor
answers them at its next batch boundary; the answers cross the RPC frame
as plain Python scalars.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional

from flink_tpu_torch.cluster.local_executor import JobCancelledError
from flink_tpu_torch.cluster.restart_strategies import (
    RestartStrategy,
    restart_strategy_from_config,
)
from flink_tpu_torch.cluster.rpc import RpcEndpoint, RpcService
from flink_tpu_torch.core.config import (
    CheckpointOptions,
    ClusterOptions,
    Configuration,
    DeploymentOptions,
    SchedulerOptions,
    StateOptions,
)

# job lifecycle (reference: org.apache.flink.api.common.JobStatus; the
# WAITING_FOR_RESOURCES state comes from the adaptive scheduler's state
# machine, reference: scheduler/adaptive/WaitingForResources.java)
CREATED = "CREATED"
WAITING_FOR_RESOURCES = "WAITING_FOR_RESOURCES"
RUNNING = "RUNNING"
RESTARTING = "RESTARTING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELED = "CANCELED"
TERMINAL = (FINISHED, FAILED, CANCELED)
_RESCALED = "RESCALED"  # internal attempt outcome, not a job status


class TaskExecutorEndpoint(RpcEndpoint):
    """Worker: owns task slots, runs deployed pipelines on task threads.

    reference: taskexecutor/TaskExecutor.java:659 submitTask -> Task thread
    -> StreamTask.invoke. Here a deployment is the whole (chained) pipeline,
    executed by the micro-batch task loop (LocalExecutor.run).
    """

    def __init__(self, executor_id: str, num_slots: int = 1,
                 master_timeout_s: Optional[float] = None):
        super().__init__(executor_id)
        self.num_slots = num_slots
        self._tasks: Dict[str, dict] = {}  # execution_id -> task record
        #: wall time of the last master contact (heartbeat ping); with
        #: ``master_timeout_s`` set, a watchdog cancels running tasks when
        #: the master goes silent — a partitioned worker must not keep
        #: writing checkpoints the failed-over attempt races (reference:
        #: TaskExecutor fails its tasks on heartbeat timeout to the JM)
        self._last_master_contact = time.monotonic()
        self._watchdog_stop = threading.Event()
        if master_timeout_s:
            def watchdog():
                while not self._watchdog_stop.wait(master_timeout_s / 4):
                    if time.monotonic() - self._last_master_contact \
                            > master_timeout_s:
                        self._cancel_all_tasks()

            threading.Thread(target=watchdog,
                             name=f"{executor_id}-master-watchdog",
                             daemon=True).start()

    def _cancel_all_tasks(self) -> None:
        for rec in list(self._tasks.values()):
            if rec["status"] == RUNNING:
                rec["cancel"].set()

    def on_stop(self) -> None:
        # a stopping worker takes its tasks down with it (reference:
        # TaskExecutor shutdown fails running tasks) — otherwise the task
        # threads keep running (and writing checkpoints) as zombies that
        # race the failed-over attempt
        self._watchdog_stop.set()
        self._cancel_all_tasks()

    # -- rpc: lifecycle -----------------------------------------------------

    #: terminal task records kept for status queries (bounded history)
    MAX_FINISHED_RECORDS = 32

    def _touch_master(self) -> None:
        self._last_master_contact = time.monotonic()

    def submit_task(self, execution_id: str, graph, config_dict: dict,
                    job_name: str, restore_from: Optional[str]) -> str:
        import queue

        # any master RPC proves the master is alive — a deployment from a
        # just-recovered master must not be killed by a stale watchdog
        # before the first heartbeat ping lands
        self._touch_master()
        cancel = threading.Event()
        control: "queue.Queue" = queue.Queue()
        record = {"status": RUNNING, "cancel": cancel, "result": None,
                  "error": None, "alive": True, "control": control}
        self._tasks[execution_id] = record
        self._prune_finished()

        def run():
            try:
                from flink_tpu_torch.cluster.stage_executor import make_executor

                executor = make_executor(Configuration(config_dict), graph)
                result = executor.run(graph, job_name=job_name,
                                      restore_from=restore_from,
                                      cancel_event=cancel,
                                      control_queue=control)
                # store only the slim wire view: the live result's registry
                # gauges close over the whole operator DAG (device buffers,
                # native slot maps) and must not outlive the attempt
                record["result"] = _slim_result(result)
                record["status"] = FINISHED
            except JobCancelledError:
                record["status"] = CANCELED
            except BaseException as e:  # noqa: BLE001 - reported to master
                record["error"] = e
                record["status"] = FAILED
            finally:
                # a savepoint request racing with termination must not hang
                # its client: fail anything still queued or newly enqueued
                # between the executor's own drain and the status flip
                while True:
                    try:
                        req = control.get_nowait()
                    except queue.Empty:
                        break
                    req.finish(None, RuntimeError(
                        f"task {execution_id} already terminated"))

        t = threading.Thread(target=run, name=f"task-{execution_id}",
                             daemon=True)
        record["thread"] = t
        t.start()
        return execution_id

    def _prune_finished(self) -> None:
        terminal = [eid for eid, r in self._tasks.items()
                    if r["status"] in TERMINAL]
        excess = len(terminal) - self.MAX_FINISHED_RECORDS
        for eid in terminal[:max(0, excess)]:
            del self._tasks[eid]

    def cancel_task(self, execution_id: str) -> None:
        self._touch_master()
        rec = self._tasks.get(execution_id)
        if rec is not None:
            rec["cancel"].set()

    def trigger_savepoint(self, execution_id: str, path: str,
                          stop: bool = False, drain: bool = False) -> str:
        """Enqueue a savepoint (optionally stop-with-savepoint) for the
        task's next batch boundary; returns a request id to poll with
        ``savepoint_status`` (reference: TaskExecutor triggerCheckpoint RPC
        is async too — the ack arrives later). Non-blocking so the endpoint
        main thread stays responsive to heartbeats."""
        import uuid as _uuid

        from flink_tpu_torch.cluster.local_executor import SavepointRequest

        self._touch_master()
        rec = self._tasks.get(execution_id)
        if rec is None or rec["status"] != RUNNING:
            raise RuntimeError(
                f"no running task {execution_id!r} to savepoint")
        req = SavepointRequest(path, stop=stop, drain=drain)
        request_id = _uuid.uuid4().hex[:12]
        rec.setdefault("savepoints", {})[request_id] = req
        rec["control"].put(req)
        return request_id

    def query_state(self, execution_id: str, operator_name: str, key,
                    namespace=None, timeout_s: float = 10.0):
        """Queryable-state lookup against a running task (reference:
        KvStateServer). Short blocking wait: queries are served at the very
        next batch boundary."""
        from flink_tpu_torch.cluster.local_executor import StateQueryRequest

        self._touch_master()
        rec = self._tasks.get(execution_id)
        if rec is None or rec["status"] != RUNNING:
            raise RuntimeError(
                f"no running task {execution_id!r} to query")
        req = StateQueryRequest(operator_name, key, namespace)
        rec["control"].put(req)
        return req.wait(timeout_s)

    def query_state_batch(self, execution_id: str, operator_name: str,
                          keys, namespace=None, timeout_s: float = 10.0):
        """Batched lookup: the whole key list served in one pass at the
        task's next batch boundary, one gather and one device-to-host copy
        (``LocalExecutor._serve_query``)."""
        from flink_tpu_torch.cluster.local_executor import (
            StateQueryBatchRequest,
        )

        self._touch_master()
        rec = self._tasks.get(execution_id)
        if rec is None or rec["status"] != RUNNING:
            raise RuntimeError(
                f"no running task {execution_id!r} to query")
        req = StateQueryBatchRequest(operator_name, keys, namespace)
        rec["control"].put(req)
        return req.wait(timeout_s)

    def savepoint_status(self, execution_id: str, request_id: str) -> dict:
        self._touch_master()
        rec = self._tasks.get(execution_id)
        req = (rec or {}).get("savepoints", {}).get(request_id)
        if req is None:
            raise RuntimeError(f"unknown savepoint request {request_id!r}")
        if not req._done.is_set():
            return {"done": False}
        return {"done": True, "path": req.result_path, "error": req.error}

    def task_status(self, execution_id: str) -> dict:
        rec = self._tasks.get(execution_id)
        if rec is None:
            return {"status": "UNKNOWN", "error": None}
        return {"status": rec["status"], "error": rec["error"]}

    def task_result(self, execution_id: str):
        rec = self._tasks.get(execution_id)
        return None if rec is None else rec["result"]

    def running_count(self) -> int:
        """Slots currently occupied by running tasks (the registration
        slot report; also the heartbeat payload's `slots_free` input)."""
        return sum(1 for r in self._tasks.values()
                   if r["status"] == RUNNING)

    def heartbeat(self) -> dict:
        """reference: TaskExecutor heartbeat payload (slot report)."""
        self._last_master_contact = time.monotonic()
        return {"id": self.endpoint_id, "slots_total": self.num_slots,
                "slots_free": self.num_slots - self.running_count(),
                "ts": time.monotonic()}


class ResourceManagerEndpoint(RpcEndpoint):
    """Slot broker between JobMasters and TaskExecutors.

    reference: resourcemanager/ResourceManager.java (slot requests) +
    runtime/blocklist (bad nodes excluded from allocation).
    """

    def __init__(self):
        super().__init__("resourcemanager")
        self._executors: Dict[str, dict] = {}
        self._blocklist: set = set()
        #: eviction tombstones: eid -> last_heartbeat at eviction time. A
        #: re-registration inherits the stale liveness, so a one-way-
        #: partitioned worker (its keepalive reaches us, our pings don't
        #: reach it) cannot flap back to "fresh" every eviction; only an
        #: answered ping (heartbeat_from) clears the tombstone.
        self._evicted: Dict[str, float] = {}
        #: notification hook the hosting process sets to react to remote
        #: joins (adaptive-scheduler jobs rescale to new resources);
        #: invoked on the endpoint main thread — implementations must not
        #: block
        self.on_register = None

    def register_task_executor(self, executor_id: str, address: str,
                               num_slots: int,
                               running_tasks: int = 0) -> None:
        fresh = executor_id not in self._executors
        prev = self._executors.get(executor_id, {})
        # a keepalive RE-registration must NOT refresh liveness: a worker
        # that can reach the master while the master cannot reach it
        # (wrong advertised address, one-way partition) has to age out of
        # the registry — only answered pings (heartbeat_from) refresh.
        # An evicted worker's re-registration inherits its tombstoned
        # staleness so it cannot flap back in; a ping answer clears it.
        hb = prev.get("last_heartbeat",
                      self._evicted.get(executor_id, time.monotonic()))
        # After a JobManager restart the registry is empty, but a surviving
        # worker's tasks are still occupying slots. Seed a SEPARATE
        # `seeded` estimate from the worker's slot report on FRESH
        # registrations only (reference: TaskExecutor registration carries
        # a SlotReport) — it must not touch `allocated`, which is the
        # JobMaster-driven promise count, or a stale keepalive racing a
        # release would leak slots. `seeded` decays via heartbeat
        # reconciliation (heartbeat_from) as orphaned tasks finish.
        self._executors[executor_id] = {
            "address": address, "slots": num_slots,
            "allocated": prev.get("allocated", 0),
            "seeded": prev.get("seeded", running_tasks),
            "alloc_times": prev.get("alloc_times", []),
            "last_heartbeat": hb,
        }
        if fresh and self.on_register is not None:
            self.on_register(executor_id)

    def executor_registry(self) -> Dict[str, dict]:
        """Membership view: executor_id -> {address, slots, allocated,
        heartbeat_age_s} (REST /taskexecutors + the heartbeat pump)."""
        now = time.monotonic()
        return {
            eid: {"address": info["address"], "slots": info["slots"],
                  "allocated": info["allocated"] + info.get("seeded", 0),
                  "heartbeat_age_s": now - info["last_heartbeat"]}
            for eid, info in self._executors.items()
        }

    #: seconds a freshly promised slot may take to show up in the
    #: worker's running-task report; reconciliation credits promises
    #: younger than this instead of suspending entirely, so steady
    #: allocation churn cannot keep a stale orphan seed alive forever
    SEED_RECONCILE_GRACE_S = 10.0

    def heartbeat_from(self, executor_id: str,
                       running_tasks: Optional[int] = None) -> None:
        info = self._executors.get(executor_id)
        if info is not None:
            info["last_heartbeat"] = time.monotonic()
            if running_tasks is not None and info.get("seeded", 0):
                # reconcile the restart-seeded estimate against the live
                # slot report. Slots promised within the grace window may
                # not be RUNNING yet, so give the report the benefit of
                # exactly that many tasks — under steady churn the seed
                # still drains (orphans finishing can only shrink it),
                # instead of reconciliation being suspended whenever the
                # LAST allocation was recent.
                now = time.monotonic()
                recent = [t for t in info.get("alloc_times", [])
                          if now - t <= self.SEED_RECONCILE_GRACE_S]
                info["alloc_times"] = recent
                info["seeded"] = min(
                    info["seeded"],
                    max(0, running_tasks + len(recent)
                        - info["allocated"]))
        self._evicted.pop(executor_id, None)  # reachable again

    def mark_dead(self, executor_id: str) -> None:
        info = self._executors.pop(executor_id, None)
        if info is not None:
            self._evicted[executor_id] = info["last_heartbeat"]
            if len(self._evicted) > 256:  # bounded tombstone memory
                self._evicted.pop(next(iter(self._evicted)))

    def block_node(self, executor_id: str) -> None:
        self._blocklist.add(executor_id)

    def request_slot(self, exclude: tuple = ()) -> Optional[dict]:
        for eid, info in self._executors.items():
            if eid in self._blocklist or eid in exclude:
                continue
            if info["allocated"] + info.get("seeded", 0) < info["slots"]:
                info["allocated"] += 1
                now = time.monotonic()
                # pending-promise timestamps for seed reconciliation
                # (bounded: entries older than the grace window drop)
                info["alloc_times"] = [
                    t for t in info.get("alloc_times", [])
                    if now - t <= self.SEED_RECONCILE_GRACE_S] + [now]
                return {"executor_id": eid, "address": info["address"]}
        return None

    def release_slot(self, executor_id: str) -> None:
        info = self._executors.get(executor_id)
        if info is not None and info["allocated"] > 0:
            info["allocated"] -= 1

    def live_executors(self) -> List[str]:
        return list(self._executors)


def _slim_result(result) -> dict:
    """Wire-safe view of a JobExecutionResult: the live registry holds
    gauges closing over device state (not serializable, and shouldn't
    travel — the reference ships accumulator snapshots, not operators)."""
    return {
        "job_name": result.job_name,
        "metrics": result.metrics,
        "metric_snapshot":
            result.registry.snapshot() if result.registry else {},
        "spans": [
            {"scope": s.scope, "name": s.name,
             "duration_ms": s.duration_ms, "attributes": s.attributes}
            for s in (result.traces.spans() if result.traces else [])
        ],
    }


def _result_from_wire(wire: Optional[dict]):
    """Rebuild a client-side JobExecutionResult from the wire-safe dict."""
    if wire is None:
        return None
    from flink_tpu_torch.datastream.environment import JobExecutionResult

    result = JobExecutionResult(wire["job_name"], wire["metrics"])
    result.metric_snapshot = wire.get("metric_snapshot", {})
    result.spans = wire.get("spans", [])
    return result


class JobMasterThread:
    """Per-job master: deploy, monitor, failover.

    reference: jobmaster/JobMaster.java + DefaultScheduler — here the
    scheduling problem is one failover region on one slot, so the master is
    a supervision loop: deploy -> watch heartbeats + task status -> on
    failure consult the RestartStrategy, restore from the latest checkpoint.
    """

    def __init__(self, cluster: "MiniCluster", job_id: str, job_name: str,
                 graph, config: Configuration):
        self.cluster = cluster
        self.job_id = job_id
        self.job_name = job_name
        self.graph = graph
        self.config = config
        self.status = CREATED
        self.attempt = 0
        self.error: Optional[BaseException] = None
        self.result = None
        self.restart_strategy: RestartStrategy = \
            restart_strategy_from_config(config)
        self.adaptive = config.get(SchedulerOptions.MODE) == "adaptive"
        #: adaptive-scheduler state machine transcript
        #: (reference: AdaptiveScheduler's State objects)
        self.state_history: List[tuple] = [(CREATED, time.time())]
        self._rescale_requested = threading.Event()
        self._cancel_requested = threading.Event()
        # suspension (cluster shutdown / leadership loss) terminates the
        # attempt but is NOT globally terminal: the job stays in the HA
        # store for the next leader (reference: JobStatus.SUSPENDED)
        self._suspended = threading.Event()
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"jobmaster-{job_id}", daemon=True)
        self._current_executor: Optional[str] = None
        self._current_address: Optional[str] = None
        self._current_execution_id: Optional[str] = None
        self._thread.start()

    # -- supervision loop ---------------------------------------------------

    def _run(self) -> None:
        # the supervision thread must always reach a terminal state and set
        # _done, or client.wait() blocks forever and the slot leaks
        try:
            self._supervise()
        except BaseException as e:  # noqa: BLE001 - job must terminate
            self.error = e
            self.status = FAILED
        finally:
            if self.status not in TERMINAL:
                self.status = FAILED
            self._archive()
            # globally-terminal jobs leave the HA job graph store; a
            # suspended job (cluster shutdown) stays for the next leader
            # (reference: Dispatcher#jobReachedTerminalState vs SUSPENDED)
            store = getattr(self.cluster, "job_graph_store", None)
            if store is not None and not self._suspended.is_set():
                try:
                    store.remove(self.job_id)
                except Exception:
                    pass
            self._done.set()

    def _set_status(self, status: str) -> None:
        self.status = status
        self.state_history.append((status, time.time()))

    def _archive(self) -> None:
        """Terminal jobs outlive the cluster: write the history-server
        archive (reference: JobManagers archive REST payloads to
        jobmanager.archive.fs.dir for the HistoryServer)."""
        from flink_tpu_torch.cluster.history_server import (
            ARCHIVE_DIR,
            archive_job,
        )

        if self._suspended.is_set():
            # a suspended job (cluster shutdown / leadership loss) is NOT
            # globally terminal — it stays in the HA store for the next
            # leader and must not appear archived (same guard as the
            # job-graph-store removal; reference:
            # Dispatcher#jobReachedTerminalState vs SUSPENDED)
            return
        # cluster-level setting with a per-job override (reference:
        # jobmanager.archive.fs.dir is a JobManager option)
        archive_dir = self.config.get(ARCHIVE_DIR) or \
            self.cluster.config.get(ARCHIVE_DIR)
        if not archive_dir:
            return
        try:
            payload = {
                "job_id": self.job_id,
                "job_name": self.job_name,
                "status": self.status,
                "attempts": self.attempt,
                "start_time": self.state_history[0][1],
                "end_time": time.time(),
                "state_history": [[s, t] for s, t in self.state_history],
                "error": repr(self.error) if self.error else None,
            }
            if self.result is not None:
                payload["metrics"] = getattr(self.result, "metrics", None)
                payload["metric_snapshot"] = getattr(
                    self.result, "metric_snapshot", None)
                traces = getattr(self.result, "spans", None)
                if traces is not None:
                    payload["spans"] = traces
            archive_job(archive_dir, self.job_id, payload)
        except Exception:  # noqa: BLE001 - archiving must not fail the job
            pass

    def _acquire_slot(self, rm):
        """Default mode: fail fast without a slot. Adaptive: enter
        WaitingForResources and poll until a slot appears or the wait
        timeout expires (reference: WaitingForResources state)."""
        slot = rm.request_slot()
        if slot is not None or not self.adaptive:
            return slot
        self._set_status(WAITING_FOR_RESOURCES)
        deadline = time.monotonic() + self.config.get(
            SchedulerOptions.RESOURCE_WAIT_TIMEOUT_MS) / 1000.0
        while time.monotonic() < deadline:
            if self._cancel_requested.is_set():
                return None
            slot = rm.request_slot()
            if slot is not None:
                # settle: let the resource picture stabilize briefly
                time.sleep(self.config.get(
                    SchedulerOptions.RESOURCE_STABILIZATION_MS) / 1000.0)
                return slot
            time.sleep(0.02)
        return None

    def _supervise(self) -> None:
        rm = self.cluster.rm_gateway()
        ckpt_dir = self.config.get(StateOptions.CHECKPOINT_DIR)
        while True:
            # re-read each attempt: request_rescale() retargets the
            # stage parallelism between attempts (the cold rescale path)
            want_stage_par = self.config.get(
                DeploymentOptions.STAGE_PARALLELISM)
            slot = self._acquire_slot(rm)
            if slot is None:
                if self._cancel_requested.is_set():
                    self._set_status(CANCELED)
                    return
                self._set_status(FAILED)
                self.error = RuntimeError(
                    "no slots available" + (
                        " within the resource wait timeout"
                        if self.adaptive else ""))
                return
            self._current_executor = slot["executor_id"]
            self._current_address = slot["address"]
            execution_id = f"{self.job_id}-{self.attempt}"
            self._current_execution_id = execution_id
            # slot demand = SUM over slot sharing groups of the group's
            # max parallelism (reference:
            # SlotSharingExecutionSlotAllocator): a group containing the
            # keyed stage needs stage-parallelism slots, any other group
            # needs one. Acquire what the cluster can actually give,
            # release any surplus immediately, and scale the stage to
            # the remainder — reactive, like the adaptive scheduler.
            extra_slots: List[dict] = []
            config = self.config
            per_group = max(want_stage_par, 1)
            keyed_count, plain_count = 1, 0
            if hasattr(self.graph, "slot_groups"):
                resolved = self.graph.slot_groups()
                keyed_groups = {resolved[t.uid]
                                for t in self.graph.nodes if t.keyed}
                all_groups = set(resolved.values()) or {"default"}
                keyed_count = len(keyed_groups)
                plain_count = len(all_groups) - keyed_count
            want_slots = per_group * keyed_count + plain_count
            if want_slots > 1:
                for _ in range(want_slots - 1):
                    extra = rm.request_slot()
                    if extra is None:
                        break
                    extra_slots.append(extra)
                total = 1 + len(extra_slots)
                effective = (max(1, min(per_group,
                                        (total - plain_count)
                                        // keyed_count))
                             if keyed_count else 1)
                used = effective * keyed_count + plain_count
                while len(extra_slots) + 1 > used:
                    # surplus from the floor division: give it back now
                    # (a held-but-unused slot starves other jobs AND
                    # joins the failover region for no benefit)
                    surplus = extra_slots.pop()
                    try:
                        rm.release_slot(surplus["executor_id"])
                    except Exception:
                        pass
                if want_stage_par > 1 and effective != want_stage_par:
                    config = Configuration(
                        {**self.config.to_dict(),
                         "execution.stage-parallelism": effective})
            participating = [slot["executor_id"]] + [
                s["executor_id"] for s in extra_slots]
            try:
                te = self.cluster.service.connect(slot["address"],
                                                  slot["executor_id"])
                restore = self._latest_restore_path(ckpt_dir)
                self._set_status(RUNNING)
                te.submit_task(execution_id, self.graph,
                               config.to_dict(), self.job_name, restore)
                outcome = self._watch(te, execution_id,
                                      participating=participating)
                if outcome == FINISHED:
                    self.result = _result_from_wire(
                        te.task_result(execution_id))
            except Exception as e:  # executor vanished mid-deploy
                self.error = e
                outcome = FAILED
            finally:
                for s in [slot] + extra_slots:
                    try:
                        rm.release_slot(s["executor_id"])
                    except Exception:
                        pass
            if outcome == FINISHED:
                self._set_status(FINISHED)
                return
            if outcome == CANCELED:
                self._set_status(CANCELED)
                return
            if outcome == _RESCALED:
                if self._cancel_requested.is_set():
                    self._set_status(CANCELED)
                    return
                # reactive rescale (adaptive scheduler): redeploy from the
                # latest checkpoint on the changed resource set WITHOUT
                # consuming restart budget — a rescale is not a failure
                # (reference: AdaptiveScheduler Executing -> Restarting on
                # resource change)
                self._rescale_requested.clear()
                self.attempt += 1
                self._set_status(RESTARTING)
                continue
            # failure path
            self.restart_strategy.notify_failure()
            if self._cancel_requested.is_set():
                self._set_status(CANCELED)
                return
            if not self.restart_strategy.can_restart():
                self._set_status(FAILED)
                return
            self.attempt += 1
            self._set_status(RESTARTING)
            time.sleep(self.restart_strategy.backoff_ms() / 1000.0)

    def _watch(self, te, execution_id: str,
               participating: Optional[List[str]] = None) -> str:
        """Poll task status + executor liveness until a terminal outcome.

        ``participating`` lists every executor holding one of this job's
        slots (subtask expansion spans executors); losing ANY of them fails
        the attempt — the whole pipeline is one failover region."""
        timeout_s = self.config.get(
            ClusterOptions.HEARTBEAT_TIMEOUT_MS) / 1000.0
        rescaling = False
        watch_executors = participating or [self._current_executor]
        while True:
            if self._cancel_requested.is_set():
                try:
                    te.cancel_task(execution_id)
                except Exception:
                    return CANCELED
            elif self._rescale_requested.is_set() and not rescaling:
                # adaptive reactive rescale: stop this attempt cleanly; the
                # supervision loop redeploys on the new resource picture
                rescaling = True
                try:
                    te.cancel_task(execution_id)
                except Exception:
                    return _RESCALED
            try:
                st = te.task_status(execution_id)
            except Exception as e:  # executor gone: treat as task failure
                self.error = RuntimeError(
                    f"task executor lost: {e}")
                if self._current_executor:
                    self.cluster.rm_gateway().mark_dead(
                        self._current_executor)
                return FAILED
            if st["status"] in TERMINAL:
                if rescaling and st["status"] == CANCELED and \
                        not self._cancel_requested.is_set():
                    # user cancellation racing the rescale wins: never
                    # resurrect a cancelled job
                    return _RESCALED
                self.error = st["error"]
                return st["status"]
            for eid in watch_executors:
                hb = self.cluster.last_heartbeat(eid)
                # a missing record means the executor left the membership
                # entirely (killed/unregistered) — every registration seeds
                # a timestamp, so None is as dead as a timed-out beat
                if hb is None or time.monotonic() - hb > timeout_s:
                    self.error = RuntimeError(
                        f"heartbeat timeout for {eid}")
                    self.cluster.rm_gateway().mark_dead(eid)
                    try:
                        te.cancel_task(execution_id)
                    except Exception:
                        pass
                    return FAILED
            time.sleep(0.01)

    @staticmethod
    def _latest_restore_path(ckpt_dir: Optional[str]) -> Optional[str]:
        if not ckpt_dir:
            return None
        from flink_tpu_torch.checkpoint.storage import CheckpointStorage

        try:
            store = CheckpointStorage(ckpt_dir)
            if store.latest_checkpoint_id() is not None:
                return ckpt_dir
        except FileNotFoundError:
            pass
        return None

    def on_new_resources(self) -> None:
        """Reactive-mode hook: the resource picture changed (reference:
        AdaptiveScheduler#onNewResourcesAvailable). A rescale redeploy is
        only safe when the job can resume from a checkpoint — without
        checkpointing it would replay from record 0 and double-emit (the
        reference's reactive mode likewise requires checkpointing)."""
        if not (self.adaptive and self.status == RUNNING):
            return
        if self._can_rescale():
            self._rescale_requested.set()

    def _can_rescale(self) -> bool:
        """A rescale redeploy replays from the latest checkpoint; without
        checkpointing it would replay from record 0 and double-emit."""
        return bool(self.config.get(StateOptions.CHECKPOINT_DIR)) and bool(
            self.config.get(CheckpointOptions.INTERVAL_MS)
            or self.config.get(CheckpointOptions.EVERY_N_BATCHES))

    def request_rescale(self, parallelism: int) -> bool:
        """Autoscaler entry point — the COLD rescale path: retarget the
        keyed stage parallelism and redeploy from the latest checkpoint
        (key-group-range filtered restore re-shards the state; no
        restart budget is consumed — a rescale is not a failure).
        Returns False when the job cannot rescale right now (not
        running, or no checkpointing to resume from); the mesh engines'
        LIVE path (engine.reshard) never stops the job at all.

        reference: AdaptiveScheduler Executing -> Restarting on a
        resource-requirements change (the externally-driven form of
        on_new_resources)."""
        parallelism = int(parallelism)
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1: {parallelism}")
        if self.status != RUNNING or not self._can_rescale():
            return False
        if parallelism == self.config.get(
                DeploymentOptions.STAGE_PARALLELISM):
            return False
        self.config = Configuration({
            **self.config.to_dict(),
            DeploymentOptions.STAGE_PARALLELISM.key: parallelism})
        self._rescale_requested.set()
        return True

    @property
    def current_parallelism(self) -> int:
        """The stage parallelism the current/next attempt deploys with
        (the autoscale controller's current_shards view)."""
        return int(self.config.get(DeploymentOptions.STAGE_PARALLELISM))

    # -- client surface -----------------------------------------------------

    def cancel(self) -> None:
        self._cancel_requested.set()

    def suspend(self) -> None:
        """Terminate the attempt WITHOUT removing the job from the HA
        store (cluster shutdown / leadership loss)."""
        self._suspended.set()
        self._cancel_requested.set()

    def trigger_savepoint(self, path: str, stop: bool = False,
                          drain: bool = False) -> dict:
        """Start a savepoint of the running attempt; returns polling
        coordinates (reference: JobMaster triggerSavepoint returns a
        CompletableFuture — here the client polls savepoint_status)."""
        if self.status != RUNNING or self._current_executor is None:
            raise RuntimeError(
                f"job {self.job_id} is {self.status}, cannot savepoint")
        te = self.cluster.service.connect(self._current_address,
                                          self._current_executor)
        request_id = te.trigger_savepoint(
            self._current_execution_id, path, stop, drain)
        return {"executor_id": self._current_executor,
                "address": self._current_address,
                "execution_id": self._current_execution_id,
                "request_id": request_id}

    def query_state(self, operator_name: str, key, namespace=None):
        if self.status != RUNNING or self._current_executor is None:
            raise RuntimeError(
                f"job {self.job_id} is {self.status}, cannot query state")
        te = self.cluster.service.connect(self._current_address,
                                          self._current_executor)
        return te.query_state(self._current_execution_id, operator_name,
                              key, namespace)

    def query_state_batch(self, operator_name: str, keys, namespace=None):
        if self.status != RUNNING or self._current_executor is None:
            raise RuntimeError(
                f"job {self.job_id} is {self.status}, cannot query state")
        te = self.cluster.service.connect(self._current_address,
                                          self._current_executor)
        return te.query_state_batch(self._current_execution_id,
                                    operator_name, keys, namespace)

    def wait(self, timeout: Optional[float] = None) -> str:
        self._done.wait(timeout)
        return self.status


class DispatcherEndpoint(RpcEndpoint):
    """Job submission front door; spawns a JobMaster per job.

    reference: dispatcher/Dispatcher.java:586 submitJob.
    """

    def __init__(self, cluster: "MiniCluster"):
        super().__init__("dispatcher")
        self.cluster = cluster
        self._masters: Dict[str, JobMasterThread] = {}
        self._recovery_lock = threading.Lock()

    def submit_job(self, graph, config_dict: dict, job_name: str,
                   job_id: Optional[str] = None) -> str:
        job_id = job_id or uuid.uuid4().hex[:16]
        store = getattr(self.cluster, "job_graph_store", None)
        # under the recovery lock: a leadership grant's recovery running
        # between the store's put and the master's start would find the
        # job stored but not running and start it a second time (ROADMAP
        # Queue C item R8: the reference's race)
        with self._recovery_lock:
            if store is not None:
                # persist BEFORE starting: a dispatcher that dies right
                # after accepting the submission must still recover the
                # job
                store.put(job_id, job_name, graph, config_dict)
            master = JobMasterThread(self.cluster, job_id, job_name, graph,
                                     Configuration(config_dict))
            self._masters[job_id] = master
        return job_id

    def recover_jobs(self, leader_check=None) -> List[str]:
        """Resubmit every unfinished job from the HA job graph store
        (reference: Dispatcher HA recovery via JobGraphStore on leadership
        grant). ``leader_check`` is re-consulted before each resubmission —
        recovery may run concurrently with a leadership loss."""
        store = getattr(self.cluster, "job_graph_store", None)
        if store is None:
            return []
        # leadership can flap: two grants -> two recovery threads; the lock
        # serializes them so the check-then-insert on _masters cannot race
        # and double-start a job
        with self._recovery_lock:
            return self._recover_jobs_locked(store, leader_check)

    def _recover_jobs_locked(self, store, leader_check) -> List[str]:
        recovered = []
        for job_id in store.job_ids():
            if leader_check is not None and not leader_check():
                return recovered  # leadership lost mid-recovery: stop
            existing = self._masters.get(job_id)
            if existing is not None:
                if existing._suspended.is_set():
                    # a master this dispatcher suspended on leadership loss
                    # is resumed when leadership returns (transient renew
                    # blip) — once its thread has wound down
                    if not existing._done.wait(timeout=10):
                        continue  # still winding down; next grant retries
                elif existing.status in TERMINAL:
                    # a terminal (FINISHED/FAILED/CANCELED) job still in
                    # the store means its remove() silently failed — retry
                    # the removal, NEVER re-run it (duplicate sink output)
                    try:
                        store.remove(job_id)
                    except Exception:
                        pass
                    continue
                else:
                    continue  # live master: must not double-start
            rec = store.get(job_id)
            master = JobMasterThread(self.cluster, job_id, rec["job_name"],
                                     rec["graph"],
                                     Configuration(rec["config"]))
            self._masters[job_id] = master
            recovered.append(job_id)
        return recovered

    def job_plan(self, job_id: str) -> dict:
        """The chained JobGraph of a submitted job (reference: REST
        /jobs/:id/plan served from JsonPlanGenerator output)."""
        m = self._masters.get(job_id)
        if m is None:
            raise KeyError(job_id)
        from flink_tpu_torch.core.config import CoreOptions
        from flink_tpu_torch.graph.job_graph import build_job_graph

        return build_job_graph(
            m.graph,
            default_parallelism=m.config.get(
                CoreOptions.DEFAULT_PARALLELISM)).to_json()

    def job_status(self, job_id: str) -> dict:
        m = self._masters.get(job_id)
        if m is None:
            return {"status": "UNKNOWN"}
        return {"status": m.status, "attempt": m.attempt,
                "error": repr(m.error) if m.error else None,
                "name": m.job_name,
                "state_history": [
                    {"state": s, "ts": ts} for s, ts in m.state_history]}

    def list_jobs(self) -> List[dict]:
        return [dict(self.job_status(jid), job_id=jid)
                for jid in self._masters]

    def cancel_job(self, job_id: str) -> None:
        m = self._masters.get(job_id)
        if m is not None:
            m.cancel()

    def trigger_savepoint(self, job_id: str, path: str, stop: bool = False,
                          drain: bool = False) -> dict:
        m = self._masters.get(job_id)
        if m is None:
            raise RuntimeError(f"unknown job {job_id}")
        return m.trigger_savepoint(path, stop=stop, drain=drain)

    def query_state(self, job_id: str, operator_name: str, key,
                    namespace=None):
        m = self._masters.get(job_id)
        if m is None:
            raise RuntimeError(f"unknown job {job_id}")
        return m.query_state(operator_name, key, namespace)

    def query_state_batch(self, job_id: str, operator_name: str, keys,
                          namespace=None):
        m = self._masters.get(job_id)
        if m is None:
            raise RuntimeError(f"unknown job {job_id}")
        return m.query_state_batch(operator_name, keys, namespace)

    # local-only helpers (not serializable across processes)
    def master(self, job_id: str) -> Optional[JobMasterThread]:
        return self._masters.get(job_id)


class JobClient:
    """Handle on a submitted job (reference: core/execution/JobClient)."""

    def __init__(self, cluster: "MiniCluster", job_id: str):
        self.cluster = cluster
        self.job_id = job_id

    def status(self) -> dict:
        return self.cluster.dispatcher.job_status(self.job_id)

    def cancel(self) -> None:
        self.cluster.dispatcher.cancel_job(self.job_id)

    def trigger_savepoint(self, path: str, timeout_s: float = 60.0) -> str:
        """reference: JobClient.triggerSavepoint."""
        return self._savepoint(path, stop=False, drain=False,
                               timeout_s=timeout_s)

    def stop_with_savepoint(self, path: str, drain: bool = False,
                            timeout_s: float = 60.0) -> str:
        """reference: JobClient.stopWithSavepoint (--drain flushes all
        windows/timers before the snapshot)."""
        return self._savepoint(path, stop=True, drain=drain,
                               timeout_s=timeout_s)

    def _savepoint(self, path: str, stop: bool, drain: bool,
                   timeout_s: float) -> str:
        coords = self.cluster.dispatcher_gateway().trigger_savepoint(
            self.job_id, path, stop=stop, drain=drain)
        te = self.cluster.service.connect(coords["address"],
                                          coords["executor_id"])
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            st = te.savepoint_status(coords["execution_id"],
                                     coords["request_id"])
            if st["done"]:
                if st["error"] is not None:
                    raise st["error"]
                return st["path"]
            time.sleep(0.02)
        raise TimeoutError(f"savepoint {path!r} did not complete in "
                           f"{timeout_s}s")

    def wait(self, timeout: Optional[float] = None) -> dict:
        master = self.cluster.dispatcher.master(self.job_id)
        if master is not None:
            master.wait(timeout)
        return self.status()

    def result(self):
        master = self.cluster.dispatcher.master(self.job_id)
        return master.result if master else None


class MiniCluster:
    """RM + Dispatcher control plane with real RPC between the roles and a
    background heartbeat pump. With ``cluster.task-executors`` > 0 it hosts
    that many TaskExecutors in-process (the reference MiniCluster); with 0
    it is a standalone JobManager — pin ``rpc.port`` and join remote
    TaskExecutor processes via flink_tpu_torch.cluster.standalone
    (reference: StandaloneSessionClusterEntrypoint + TaskManagerRunner)."""

    def __init__(self, config: Optional[Configuration] = None):
        from flink_tpu_torch.core.config import HighAvailabilityOptions

        self.config = config or Configuration()
        self.service = RpcService(
            bind_address=self.config.get(ClusterOptions.RPC_BIND_ADDRESS),
            port=self.config.get(ClusterOptions.RPC_PORT),
            advertised_address=self.config.get(
                ClusterOptions.RPC_ADVERTISED_ADDRESS))
        self.rm = ResourceManagerEndpoint()
        self.service.register(self.rm)
        # HA services (reference: HighAvailabilityServices wiring)
        self.job_graph_store = None
        self.blob_store = None
        ha_mode = self.config.get(HighAvailabilityOptions.MODE)
        ha_dir = self.config.get(HighAvailabilityOptions.STORAGE_DIR)
        if ha_mode == "filesystem" and ha_dir:
            from flink_tpu_torch.cluster.ha import BlobStore, JobGraphStore

            self.job_graph_store = JobGraphStore(ha_dir)
            self.blob_store = BlobStore(ha_dir)
        self.dispatcher = DispatcherEndpoint(self)
        self.service.register(self.dispatcher)
        self.executors: List[TaskExecutorEndpoint] = []
        self._heartbeats: Dict[str, float] = {}
        self._hb_stop = threading.Event()
        n = self.config.get(ClusterOptions.NUM_TASK_EXECUTORS)
        slots = self.config.get(ClusterOptions.SLOTS_PER_EXECUTOR)
        for i in range(n):
            self.add_task_executor(slots)
        # HA recovery happens only on winning dispatcher leadership — a
        # standby sharing the storageDir must NOT also run the jobs
        # (reference: DispatcherLeaderProcess recovers on leadership grant)
        self._leader_election = None
        if self.job_graph_store is not None:
            from flink_tpu_torch.cluster.ha import (
                FileLeaderElectionDriver,
                LeaderContender,
                LeaderElectionService,
            )
            cluster = self

            class _DispatcherContender(LeaderContender):
                def grant_leadership(self, fencing_token):
                    # recovery can block on winding-down masters, so it runs
                    # OFF the election thread (which must keep renewing the
                    # lease) and re-checks leadership before each resubmit
                    election = cluster._leader_election

                    def _recover():
                        cluster.dispatcher.recover_jobs(
                            leader_check=lambda: election is None
                            or election.is_leader)

                    threading.Thread(target=_recover,
                                     name="dispatcher-recovery",
                                     daemon=True).start()

                def revoke_leadership(self):
                    # split-brain guard: the new leader's recover_jobs()
                    # will resubmit these jobs from the JobGraphStore, so
                    # this dispatcher must stop running them (suspend keeps
                    # them in the HA store for the new leader)
                    for master in list(
                            cluster.dispatcher._masters.values()):
                        try:
                            master.suspend()
                        except Exception:
                            pass

            lease_s = self.config.get(
                HighAvailabilityOptions.LEASE_TIMEOUT_MS) / 1000.0
            self._leader_election = LeaderElectionService(
                FileLeaderElectionDriver(
                    self.config.get(HighAvailabilityOptions.STORAGE_DIR),
                    "dispatcher", lease_timeout_s=lease_s),
                _DispatcherContender(), poll_interval_s=min(lease_s / 4,
                                                            0.25))
            self._leader_election.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="heartbeat-manager",
            daemon=True)
        self._hb_thread.start()
        self._rest = None
        rest_port = self.config.get(ClusterOptions.REST_PORT)
        if rest_port >= 0:
            from flink_tpu_torch.cluster.rest import RestServer

            self._rest = RestServer(self, port=rest_port)

        # remote TE joins must wake adaptive-scheduler jobs, exactly like
        # add_task_executor does for local ones. Wired LAST: the RM is
        # network-reachable the moment its endpoint registers, and a
        # keepalive re-registration from a surviving worker must not hit a
        # callback touching attributes that don't exist yet. (Joins that
        # land before this line just miss the wake-up; the keepalive
        # re-register and the heartbeat pump pick them up.)
        cluster_ref = self

        def _on_remote_register(executor_id: str) -> None:
            self._heartbeats[executor_id] = time.monotonic()

            def wake():
                for master in list(
                        cluster_ref.dispatcher._masters.values()):
                    master.on_new_resources()

            threading.Thread(target=wake, name="resource-wake",
                             daemon=True).start()

        self.rm.on_register = _on_remote_register

    # -- membership ---------------------------------------------------------

    def add_task_executor(self, num_slots: int = 1) -> TaskExecutorEndpoint:
        te = TaskExecutorEndpoint(f"taskexecutor-{len(self.executors)}",
                                  num_slots)
        self.service.register(te)
        self.rm_gateway().register_task_executor(
            te.endpoint_id, self.service.address, num_slots)
        self.executors.append(te)
        self._heartbeats[te.endpoint_id] = time.monotonic()
        # adaptive-scheduler jobs react to the changed resource picture
        for master in list(self.dispatcher._masters.values()):
            master.on_new_resources()
        return te

    def kill_task_executor(self, executor_id: str) -> None:
        """Fault injection: make an executor vanish (tests; the reference
        kills TaskManagers in its recovery ITCases — SURVEY.md §4)."""
        for te in list(self.executors):
            if te.endpoint_id == executor_id:
                for rec in te._tasks.values():
                    rec["cancel"].set()
                self.service.unregister(executor_id)
                # drop from membership so REST /taskexecutors and /overview
                # stop reporting the dead executor's slots as capacity
                self.executors.remove(te)
        self._heartbeats.pop(executor_id, None)
        self.rm_gateway().mark_dead(executor_id)

    # -- heartbeats ---------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        from concurrent import futures as _futures

        interval = self.config.get(
            ClusterOptions.HEARTBEAT_INTERVAL_MS) / 1000.0
        timeout_s = self.config.get(
            ClusterOptions.HEARTBEAT_TIMEOUT_MS) / 1000.0
        rm = self.rm_gateway()  # through RPC: keep the main-thread invariant
        # parallel pings with a short per-RPC deadline: one blackholed
        # remote worker must not starve every healthy executor's refresh
        # (serial pings with the default 120s deadline would)
        pool = _futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="hb-ping")
        ping_deadline = max(min(timeout_s / 2, 5.0), 0.5)

        def ping(eid: str, address: str) -> bool:
            gw = self.service.connect(address, eid,
                                      call_timeout=ping_deadline)
            report = gw.heartbeat()
            self._heartbeats[eid] = time.monotonic()
            # forward the slot report so the RM reconciles its
            # restart-seeded occupancy estimate against live truth
            running = (report["slots_total"] - report["slots_free"]
                       if isinstance(report, dict)
                       and "slots_free" in report else None)
            rm.heartbeat_from(eid, running_tasks=running)
            return True

        try:
            while not self._hb_stop.wait(interval):
                # every registered executor, local AND remote — each
                # pinged at its own registered address (reference:
                # HeartbeatManager pings TaskManagers wherever they run)
                try:
                    registry = rm.executor_registry()
                except Exception:
                    continue
                fs = {pool.submit(ping, eid, info["address"]): eid
                      for eid, info in registry.items()}
                answered = set()
                try:
                    for f in _futures.as_completed(
                            fs, timeout=max(timeout_s, ping_deadline) + 1):
                        try:
                            if f.result():
                                answered.add(fs[f])
                        except Exception:
                            pass  # missed beat; timeout decides
                except _futures.TimeoutError:
                    pass  # stragglers keep running into their deadline
                # evict executors silent for several timeouts so their
                # slots stop being offered and their pings stop costing.
                # Liveness is re-read AFTER this round's pings: an
                # executor that just answered (e.g. after the pump itself
                # was suspended for a while) must never be evicted on a
                # stale pre-ping snapshot.
                try:
                    registry = rm.executor_registry()
                except Exception:
                    continue
                for eid, info in registry.items():
                    if eid not in answered \
                            and info["heartbeat_age_s"] > timeout_s * 3:
                        try:
                            rm.mark_dead(eid)
                        except Exception:
                            pass
        finally:
            pool.shutdown(wait=False)

    def last_heartbeat(self, executor_id: str) -> Optional[float]:
        return self._heartbeats.get(executor_id)

    # -- gateways -----------------------------------------------------------

    def rm_gateway(self):
        return self.service.connect(self.service.address, "resourcemanager")

    def dispatcher_gateway(self):
        return self.service.connect(self.service.address, "dispatcher")

    # -- client surface -----------------------------------------------------

    def submit(self, env, job_name: str = "job") -> JobClient:
        """Submit a built StreamExecutionEnvironment pipeline."""
        graph = env.get_stream_graph()
        env._sinks = []
        job_id = self.dispatcher_gateway().submit_job(
            graph, env.config.to_dict(), job_name)
        return JobClient(self, job_id)

    @property
    def rest_port(self) -> Optional[int]:
        return self._rest.port if self._rest else None

    def shutdown(self) -> None:
        if self._leader_election is not None:
            self._leader_election.stop()  # graceful release -> standby wins
        self._hb_stop.set()
        for jid, master in list(self.dispatcher._masters.items()):
            if self.job_graph_store is not None:
                master.suspend()  # job survives in the HA store
            else:
                master.cancel()
        if self._rest is not None:
            self._rest.close()
        self.service.stop()
