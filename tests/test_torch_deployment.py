"""The port's Kubernetes driver (``flink_tpu_torch/cluster/deployment.py``)
against the reference's: the manifests are the reference's with the
device fields and the command mapped — a worker requests ``nvidia.com/gpu``
and pins ``nvidia.com/gpu.product`` where the reference requests
``google.com/tpu`` and pins the GKE TPU selectors, and the containers run
``python3 -m flink_tpu_torch.cli`` where the reference runs
``flink-tpu``. Counterparts of every test in ``tests/test_deployment.py``.
"""

import copy
import os
import subprocess
import sys

import pytest

from flink_tpu.cluster import deployment as ref_dep
from flink_tpu.core.config import Configuration as RefConfiguration
from flink_tpu_torch.cluster import deployment as port_dep
from flink_tpu_torch.core.config import Configuration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = ["python3", "-m", "flink_tpu_torch.cli"]


class FakeKubectl:
    def __init__(self):
        self.applied = []
        self.scaled = []
        self.deleted = []

    def apply(self, manifest):
        self.applied.append(manifest)

    def scale(self, deployment, replicas):
        self.scaled.append((deployment, replicas))

    def delete(self, kind, name):
        self.deleted.append((kind, name))


CONF = {"state.checkpoints.dir": "gs://ck/bench"}


def mk_port(**kw):
    client = FakeKubectl()
    dep = port_dep.KubernetesDeployment(
        "bench", config=Configuration(dict(CONF)), task_executors=3,
        slots_per_executor=2, client=client, **kw)
    return dep, client


def mk_ref(**kw):
    client = FakeKubectl()
    dep = ref_dep.KubernetesDeployment(
        "bench", config=RefConfiguration(dict(CONF)), task_executors=3,
        slots_per_executor=2, client=client, **kw)
    return dep, client


def _mapped(ref_manifests, gpus=0, product="NVIDIA-H100-80GB-HBM3"):
    """The reference's manifests with the port's image, command and device
    fields."""
    out = copy.deepcopy(ref_manifests)
    for m in out:
        if m["kind"] != "Deployment":
            continue
        spec = m["spec"]["template"]["spec"]
        c = spec["containers"][0]
        c["image"] = "flink-tpu-torch:latest"
        assert c["args"][0] == "flink-tpu"
        c["args"] = PORT_CLI + c["args"][1:]
        if "resources" in c:
            n = c["resources"]["requests"].pop("google.com/tpu")
            c["resources"]["limits"].pop("google.com/tpu")
            assert n == gpus
            c["resources"]["requests"]["nvidia.com/gpu"] = gpus
            c["resources"]["limits"]["nvidia.com/gpu"] = gpus
            spec["nodeSelector"] = {"nvidia.com/gpu.product": product}
    return out


@pytest.mark.parametrize("devices", [0, 1, 4])
def test_manifests_are_the_references_mapped(devices):
    ref, _ = mk_ref(tpus_per_executor=devices)
    port, _ = mk_port(gpus_per_executor=devices)
    assert port.manifests() == _mapped(ref.manifests(), gpus=devices)


def test_deploy_applies_jm_service_and_te():
    dep, client = mk_port()
    dep.deploy()
    kinds = [(m["kind"], m["metadata"]["name"]) for m in client.applied]
    assert kinds == [("Deployment", "bench-jobmanager"),
                     ("Service", "bench-jobmanager"),
                     ("Deployment", "bench-taskexecutor")]
    te = client.applied[-1]
    assert te["spec"]["replicas"] == 3
    args = te["spec"]["template"]["spec"]["containers"][0]["args"]
    assert args[:4] == PORT_CLI + ["taskexecutor"]
    assert args[args.index("--jobmanager") + 1] == "bench-jobmanager:6123"
    assert args[args.index("--slots") + 1] == "2"
    assert "-Dstate.checkpoints.dir=gs://ck/bench" in args
    jm = client.applied[0]["spec"]["template"]["spec"]["containers"][0]
    assert jm["args"][:4] == PORT_CLI + ["jobmanager"]


def test_gpu_workers_request_devices_and_pin_the_product():
    dep, _ = mk_port(gpus_per_executor=4, gpu_product="NVIDIA-H100-SXM5")
    spec = dep.taskexecutor_manifest()["spec"]["template"]["spec"]
    res = spec["containers"][0]["resources"]
    assert res["requests"]["nvidia.com/gpu"] == 4
    assert res["limits"]["nvidia.com/gpu"] == 4
    assert spec["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-SXM5"}


def test_cpu_workers_carry_no_device_fields():
    dep, _ = mk_port()
    spec = dep.taskexecutor_manifest()["spec"]["template"]["spec"]
    assert "nodeSelector" not in spec
    assert "resources" not in spec["containers"][0]


def test_jm_service_exposes_rpc_and_rest():
    port, _ = mk_port()
    ref, _ = mk_ref()
    svc = port.jobmanager_manifests()[1]
    assert svc == ref.jobmanager_manifests()[1]
    assert {p["name"]: p["port"] for p in svc["spec"]["ports"]} == {
        "rpc": 6123, "rest": 8081}


def test_scale_and_teardown():
    results = []
    for dep, client in (mk_port(), mk_ref()):
        dep.scale_task_executors(7)
        dep.teardown()
        results.append((client.scaled, client.deleted, dep.task_executors))
    assert results[0] == results[1]
    assert results[0][0] == [("bench-taskexecutor", 7)]


SCALER_CASES = [
    ("meets-demand", [(10, 6), (10, 10)], {"max_workers": 8}),
    ("scales-down-to-minimum", [(0, 0)], {"min_workers": 1}),
    ("never-kills-busy-workers", [(0, 6), (0, 4)], {"min_workers": 1}),
    ("bounded-by-max", [(1000, 0)], {"max_workers": 8}),
]


@pytest.mark.parametrize("name,demands,kw", SCALER_CASES,
                         ids=[c[0] for c in SCALER_CASES])
def test_elastic_scaler_matches_the_reference(name, demands, kw):
    runs = []
    for mod, (dep, client) in ((port_dep, mk_port()), (ref_dep, mk_ref())):
        it = iter(demands)
        cur = [next(it)]
        scaler = mod.ElasticScaler(dep, lambda: cur[0], **kw)
        steps = [scaler.reconcile()]
        for d in it:
            cur[0] = d
            steps.append(scaler.reconcile())
        runs.append((steps, client.scaled))
    assert runs[0] == runs[1]
    expected = {"meets-demand": [5, None], "scales-down-to-minimum": [1],
                "never-kills-busy-workers": [None, 2],
                "bounded-by-max": [8]}[name]
    assert runs[0][0] == expected


def _cli(*args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "flink_tpu_torch.cli",
                           *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120)


def test_cli_scale_requires_explicit_count():
    out = _cli("deploy", "scale", "prod")
    assert out.returncode == 2
    assert "--task-executors" in out.stderr


def test_cli_dry_run_prints_manifests():
    out = _cli("deploy", "kubernetes", "demo", "--task-executors", "4",
               "--gpus-per-executor", "1", "--dry-run")
    assert out.returncode == 0, out.stderr
    assert '"nvidia.com/gpu": 1' in out.stdout
    assert '"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"' in out.stdout
    assert '"name": "demo-jobmanager"' in out.stdout
    assert '"replicas": 4' in out.stdout
    assert "google.com/tpu" not in out.stdout
