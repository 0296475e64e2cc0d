"""Container deployment drivers — Kubernetes manifests + active scaling
(port of ``flink_tpu/cluster/deployment.py``).

reference: flink-kubernetes (KubernetesResourceManagerDriver.java:1 —
the active RM requesting/releasing worker pods through the k8s API;
KubernetesClusterDescriptor deploying the JobManager Deployment +
Service + ConfigMap; taskmanager pod templates). The YARN driver plays
the same role on that stack; here Kubernetes is the container target.

GPU workers: a TaskExecutor pod is a GPU-host pod — the worker spec
requests ``nvidia.com/gpu`` device resources (``gpus_per_executor``) and
pins the card through the NVIDIA GPU operator's ``nvidia.com/gpu.product``
node label, so "give me a worker" means "give me cards". The control
plane stays the standalone entrypoints (``python3 -m flink_tpu_torch.cli
jobmanager`` / ``taskexecutor``): Kubernetes only *schedules* them,
exactly like the reference's native-k8s mode runs the same entrypoints
in pods.

Two layers:
- :class:`KubernetesDeployment` — renders the full manifest set and
  applies/scales/tears it down through a ``KubectlClient`` seam
  (subprocess ``kubectl`` in production; faked in tests — this
  environment has no cluster to talk to, so the seam IS the contract).
- :class:`ElasticScaler` — the ResourceManagerDriver role: watches
  unfulfilled slot demand and scales the TaskExecutor replica count,
  the reference's requestResource/releaseResource loop expressed as
  reconciliation (declarative replicas, like its
  KubernetesResourceManagerDriver requesting pods to match declared
  resources).
"""

from __future__ import annotations

import json
import shlex
import subprocess
from typing import Callable, Dict, List, Optional

from flink_tpu_torch.core.config import Configuration


class KubectlClient:
    """Thin seam over ``kubectl`` (the k8s API client role). Everything
    the drivers need: apply JSON manifests, patch replicas, delete."""

    def __init__(self, context: Optional[str] = None,
                 namespace: str = "default"):
        self.context = context
        self.namespace = namespace

    def _base(self) -> List[str]:
        cmd = ["kubectl", "-n", self.namespace]
        if self.context:
            cmd += ["--context", self.context]
        return cmd

    def apply(self, manifest: dict) -> None:
        subprocess.run(self._base() + ["apply", "-f", "-"],
                       input=json.dumps(manifest).encode(), check=True)

    def scale(self, deployment: str, replicas: int) -> None:
        subprocess.run(self._base() + [
            "scale", "deployment", deployment,
            f"--replicas={int(replicas)}"], check=True)

    def delete(self, kind: str, name: str) -> None:
        subprocess.run(self._base() + [
            "delete", kind, name, "--ignore-not-found=true"], check=True)


#: the container's entry point: the port's CLI
CLI_COMMAND = ["python3", "-m", "flink_tpu_torch.cli"]


def _config_args(config: Configuration) -> List[str]:
    return [f"-D{k}={v}" for k, v in sorted(config.to_dict().items())]


class KubernetesDeployment:
    """Render + drive the cluster's Kubernetes resources (reference:
    KubernetesClusterDescriptor.deploySessionCluster)."""

    def __init__(self, cluster_id: str, config: Optional[Configuration]
                 = None, image: str = "flink-tpu-torch:latest",
                 task_executors: int = 2, slots_per_executor: int = 1,
                 gpus_per_executor: int = 0,
                 gpu_product: str = "NVIDIA-H100-80GB-HBM3",
                 client: Optional[KubectlClient] = None):
        self.cluster_id = cluster_id
        self.config = config or Configuration({})
        self.image = image
        self.task_executors = int(task_executors)
        self.slots_per_executor = int(slots_per_executor)
        self.gpus_per_executor = int(gpus_per_executor)
        self.gpu_product = gpu_product
        self.client = client or KubectlClient()

    # ------------------------------------------------------- manifests

    @property
    def jm_name(self) -> str:
        return f"{self.cluster_id}-jobmanager"

    @property
    def te_name(self) -> str:
        return f"{self.cluster_id}-taskexecutor"

    def _labels(self, component: str) -> Dict[str, str]:
        return {"app": "flink-tpu", "cluster": self.cluster_id,
                "component": component}

    def jobmanager_manifests(self) -> List[dict]:
        """JM Deployment (replicas=1) + Service exposing RPC + REST
        (reference: the JM Deployment/rest-service the descriptor
        creates)."""
        labels = self._labels("jobmanager")
        container = {
            "name": "jobmanager",
            "image": self.image,
            "args": [*CLI_COMMAND, "jobmanager",
                     "--port", "6123", "--rest-port", "8081",
                     *_config_args(self.config)],
            "ports": [{"containerPort": 6123, "name": "rpc"},
                      {"containerPort": 8081, "name": "rest"}],
        }
        deployment = {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": self.jm_name, "labels": labels},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": labels},
                "template": {
                    "metadata": {"labels": labels},
                    "spec": {"containers": [container]},
                },
            },
        }
        service = {
            "apiVersion": "v1", "kind": "Service",
            "metadata": {"name": self.jm_name, "labels": labels},
            "spec": {
                "selector": labels,
                "ports": [
                    {"name": "rpc", "port": 6123, "targetPort": 6123},
                    {"name": "rest", "port": 8081, "targetPort": 8081},
                ],
            },
        }
        return [deployment, service]

    def taskexecutor_manifest(self) -> dict:
        """TE Deployment: each replica is one worker registering with the
        JM service; GPU workers request ``nvidia.com/gpu`` devices and
        pin the card type by the GPU operator's ``nvidia.com/gpu.product``
        node label (reference: the worker pod template
        KubernetesResourceManagerDriver requests; there ``google.com/tpu``
        and the GKE TPU selectors)."""
        labels = self._labels("taskexecutor")
        container: dict = {
            "name": "taskexecutor",
            "image": self.image,
            "args": [*CLI_COMMAND, "taskexecutor",
                     "--jobmanager", f"{self.jm_name}:6123",
                     "--slots", str(self.slots_per_executor),
                     *_config_args(self.config)],
        }
        pod_spec: dict = {"containers": [container]}
        if self.gpus_per_executor:
            container["resources"] = {
                "requests": {"nvidia.com/gpu": self.gpus_per_executor},
                "limits": {"nvidia.com/gpu": self.gpus_per_executor},
            }
            pod_spec["nodeSelector"] = {
                "nvidia.com/gpu.product": self.gpu_product,
            }
        return {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": self.te_name, "labels": labels},
            "spec": {
                "replicas": self.task_executors,
                "selector": {"matchLabels": labels},
                "template": {"metadata": {"labels": labels},
                             "spec": pod_spec},
            },
        }

    def manifests(self) -> List[dict]:
        return self.jobmanager_manifests() + [self.taskexecutor_manifest()]

    # --------------------------------------------------------- actions

    def deploy(self) -> None:
        for m in self.manifests():
            self.client.apply(m)

    def scale_task_executors(self, replicas: int) -> None:
        self.task_executors = int(replicas)
        self.client.scale(self.te_name, replicas)

    def teardown(self) -> None:
        self.client.delete("deployment", self.te_name)
        self.client.delete("deployment", self.jm_name)
        self.client.delete("service", self.jm_name)


class ElasticScaler:
    """The active ResourceManagerDriver role (reference:
    KubernetesResourceManagerDriver.requestResource): reconcile the
    worker replica count against observed slot demand.

    ``demand_fn`` returns (slots_required, slots_in_use) — e.g. pending
    slot requests and currently-allocated slots read over the RM's
    gateway. The scaler converts shortage or surplus into ONE
    declarative ``scale_task_executors`` call per reconcile, bounded by
    [min_workers, max_workers]. Scale-down never drops below the
    workers needed to hold the slots still IN USE — a bare
    ``kubectl scale`` kills arbitrary pods, so the floor is what keeps
    busy workers alive (the reference releases only idle-timed-out
    workers; declaratively that is the same floor)."""

    def __init__(self, deployment: KubernetesDeployment,
                 demand_fn: Callable[[], tuple],
                 slots_per_executor: Optional[int] = None,
                 min_workers: int = 1, max_workers: int = 64):
        self.deployment = deployment
        self.demand_fn = demand_fn
        self.slots_per = (slots_per_executor
                          or deployment.slots_per_executor or 1)
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)

    def reconcile(self) -> Optional[int]:
        """One reconcile step; returns the new replica count when a
        scale was issued, None when already converged."""
        required, in_use = self.demand_fn()

        def ceil_workers(slots: int) -> int:
            return -(-max(int(slots), 0) // self.slots_per)

        want = max(ceil_workers(required), ceil_workers(in_use))
        want = min(max(want, self.min_workers), self.max_workers)
        if want != self.deployment.task_executors:
            self.deployment.scale_task_executors(want)
            return want
        return None
