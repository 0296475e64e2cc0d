"""Package rules of the port: it stands apart from JAX and from the JAX
package, and its entry points run on the card unless asked otherwise."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "flink_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flink_tpu"}


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, flink_tpu_torch, flink_tpu_torch.cluster."
            "local_executor, flink_tpu_torch.benchmarks.nexmark, "
            "flink_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_file_imports_jax_or_the_reference():
    offenders = []
    for path in list(_py_files()) + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path}:{node.lineno}: {n}")
    assert not offenders, offenders


def test_default_device_is_cuda_and_raises_without_a_card():
    import torch

    from flink_tpu_torch.convert import from_jax_planes
    from flink_tpu_torch.core.config import Configuration, ExecutionOptions
    from flink_tpu_torch.core.device import resolve_device
    from flink_tpu_torch.parallel.mesh import make_mesh

    assert ExecutionOptions.DEVICE.default == "cuda"
    assert Configuration().get(ExecutionOptions.DEVICE) == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves")
    for call in (lambda: resolve_device(),
                 lambda: make_mesh(8),
                 lambda: from_jax_planes([np.zeros((8, 4), np.int32)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_job_on_default_device_raises_without_a_card():
    import torch

    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves")
    env = StreamExecutionEnvironment(Configuration(
        {"parallelism.default": 8}))
    build_q5(env, BidSource(total_records=1000)).sink_to(CollectSink())
    with pytest.raises(RuntimeError, match="cuda"):
        env.execute()

