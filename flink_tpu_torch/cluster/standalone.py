"""Standalone deployment: JobManager and TaskExecutor as separate
processes joined over RPC (port of ``flink_tpu/cluster/standalone.py``).

reference: StandaloneSessionClusterEntrypoint (the jobmanager.sh process:
Dispatcher + ResourceManager + REST) and TaskManagerRunner (the
taskmanager.sh process registering with the ResourceManager and offering
slots). The control plane here is the same MiniCluster code — a
MiniCluster with ``cluster.task-executors: 0`` IS the standalone
JobManager; this module adds the worker-side runner and the process
entrypoints (exposed as ``python3 -m flink_tpu_torch.cli jobmanager`` /
``taskexecutor``). A TaskExecutor process runs each deployed job with the
job's own configuration, so the job's ``execution.device`` decides where
its state lives (the card unless it says ``cpu``).

The data plane between stage-parallel subtasks picks its transport via
``shuffle.service`` (``grpc`` for cross-process); checkpoints/savepoints
need a filesystem path all processes share (``state.checkpoints.dir``),
like the reference's requirement of a shared checkpoint directory.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from flink_tpu_torch.cluster.minicluster import TaskExecutorEndpoint
from flink_tpu_torch.cluster.rpc import RpcService
from flink_tpu_torch.core.config import ClusterOptions, Configuration


class TaskExecutorRunner:
    """One worker process: hosts a TaskExecutorEndpoint on its own RPC
    server, registers with the remote ResourceManager, and keeps
    re-registering as a liveness keepalive (a restarted JobManager
    re-learns the worker without manual intervention; re-registration
    preserves slot accounting server-side)."""

    def __init__(self, jobmanager_address: str,
                 config: Optional[Configuration] = None,
                 executor_id: Optional[str] = None):
        self.config = config or Configuration()
        self.jm_address = jobmanager_address
        self.service = RpcService(
            bind_address=self.config.get(ClusterOptions.RPC_BIND_ADDRESS),
            advertised_address=self.config.get(
                ClusterOptions.RPC_ADVERTISED_ADDRESS))
        self.executor_id = executor_id or f"taskexecutor-{uuid.uuid4().hex[:8]}"
        self.num_slots = self.config.get(ClusterOptions.SLOTS_PER_EXECUTOR)
        # a worker that loses its master cancels its tasks rather than
        # keep writing output/checkpoints the failover will race
        timeout_s = self.config.get(
            ClusterOptions.HEARTBEAT_TIMEOUT_MS) / 1000.0
        self.endpoint = TaskExecutorEndpoint(self.executor_id,
                                             self.num_slots,
                                             master_timeout_s=timeout_s * 3)
        self.service.register(self.endpoint)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return self.service.address

    def register_once(self) -> None:
        rm = self.service.connect(self.jm_address, "resourcemanager")
        # running_count iterates the endpoint's task dict — read it on the
        # endpoint main thread (keepalive runs on its own thread; a
        # concurrent submit_task would otherwise mutate mid-iteration)
        running = self.endpoint.run_in_main_thread(
            self.endpoint.running_count).result()
        rm.register_task_executor(self.executor_id, self.service.address,
                                  self.num_slots, running_tasks=running)

    def start(self) -> "TaskExecutorRunner":
        self.register_once()
        interval = self.config.get(
            ClusterOptions.HEARTBEAT_INTERVAL_MS) / 1000.0

        def keepalive():
            while not self._stop.wait(max(interval * 4, 1.0)):
                try:
                    self.register_once()
                except Exception:
                    pass  # JobManager away; keep trying (it may restart)

        self._thread = threading.Thread(target=keepalive,
                                        name="te-keepalive", daemon=True)
        self._thread.start()
        return self

    def run_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(3600):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # an in-flight keepalive re-register completing AFTER
            # mark_dead would resurrect a dead entry in the RM registry
            self._thread.join(timeout=10)
        try:
            rm = self.service.connect(self.jm_address, "resourcemanager",
                                      call_timeout=5)
            rm.mark_dead(self.executor_id)
        except Exception:
            pass
        self.service.stop()


def run_jobmanager(config: Optional[Configuration] = None):
    """Start the standalone JobManager (blocking). Equivalent of
    ``MiniCluster`` with no local executors + a pinned rpc.port."""
    from flink_tpu_torch.cluster.minicluster import MiniCluster

    config = config or Configuration()
    config.set("cluster.task-executors", 0)
    cluster = MiniCluster(config)
    print(f"jobmanager rpc on {cluster.service.address}"
          + (f", rest on :{cluster.rest_port}"
             if cluster.rest_port else ""), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        cluster.shutdown()


def remote_submit(jobmanager_address: str, env, job_name: str = "job"):
    """Submit a built pipeline to a remote standalone JobManager; returns
    (job_id, dispatcher_gateway) — poll with ``job_status(job_id)``.
    Client-only: no server is hosted, channels are cached process-wide."""
    dispatcher = RpcService.client_connect(jobmanager_address, "dispatcher")
    graph = env.get_stream_graph()
    env._sinks = []
    # effective config: includes CLI -D dynamic properties and restore
    # flags, exactly what a local execute() would apply
    config = env._effective_config() if hasattr(
        env, "_effective_config") else env.config
    job_id = dispatcher.submit_job(graph, config.to_dict(), job_name)
    return job_id, dispatcher
