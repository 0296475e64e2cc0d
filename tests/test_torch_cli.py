"""The port's CLI (``flink_tpu_torch/cli.py``) against the reference's
(``flink_tpu/cli.py``): the same commands on the same jobs print the same
things. Counterparts of the CLI half of ``tests/test_fs_and_cli.py``, plus
``query`` at a held end of stream and the device taken from
``-D execution.device``. Every wait is bounded."""

import json
import os
import subprocess
import sys
import time

import pytest

from flink_tpu.cli import main as ref_main
from flink_tpu_torch.cli import main as port_main
from test_torch_minicluster import (
    PKGS,
    _cluster,
    _count_job,
    _env,
    _ns,
    _task_running,
    _wait_for,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = {"reference": ref_main, "port": port_main}

PIPELINE = """
import sys
from {base} import Configuration, StreamExecutionEnvironment
from {base}.connectors.sources import DataGenSource
from {base}.connectors.sinks import JsonLinesFileSink
from {base}.runtime.watermarks import WatermarkStrategy
from {base}.windowing.assigners import TumblingEventTimeWindows

env = StreamExecutionEnvironment({conf})
(env.add_source(DataGenSource(total_records=2000, num_keys=5,
                              events_per_second_of_eventtime=2000),
                WatermarkStrategy.for_bounded_out_of_orderness(0))
 .key_by("key").window(TumblingEventTimeWindows.of(500)).count()
 .sink_to(JsonLinesFileSink(sys.argv[1])))
r = env.execute("cli-job")
print("BATCH", env.batch_size)
print("DEVICE", env._effective_config().get_raw("execution.device"))
"""


@pytest.mark.parametrize("pkg", PKGS)
def test_run_with_dynamic_props(pkg, tmp_path, capsys):
    script = tmp_path / "pipe.py"
    script.write_text(PIPELINE.format(
        base="flink_tpu" if pkg == "reference" else "flink_tpu_torch",
        conf="Configuration({'execution.device': 'cuda'})"))
    out = str(tmp_path / "out.jsonl")
    rc = MAIN[pkg](["run", str(script), out,
                    "-D", "execution.micro-batch.size=123",
                    "-D", "execution.device=cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "BATCH 123" in printed  # -D reached the environment
    # -D wins over the script's own configuration: the port runs on cpu
    assert "DEVICE cpu" in printed
    rows = [json.loads(line) for line in open(out) if line.strip()]
    assert sum(int(r["count"]) for r in rows) == 2000
    assert "FLINK_TPU_DYNAMIC_PROPS" not in os.environ


def test_malformed_define_exits_2(capsys):
    for main in MAIN.values():
        with pytest.raises(SystemExit) as e:
            main(["run", "x.py", "-D", "nokeyvalue"])
        assert e.value.code == 2
        assert "-D expects key=value" in capsys.readouterr().err


def test_rest_actions(tmp_path, capsys):
    """list, info, savepoint, cancel and inspect against a running job of
    each package's cluster; the outputs agree."""
    outputs = {}
    for pkg in PKGS:
        ns = _ns(pkg)
        main = MAIN[pkg]
        cluster = _cluster(ns, **{"rest.port": 0})
        try:
            env = _env(ns, {"execution.micro-batch.size": 256})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(
                str(tmp_path / f"{pkg}.jsonl")), 50_000, slow=True,
                window=1000)
            client = cluster.submit(env, "rest-job")
            rest = f"127.0.0.1:{cluster.rest_port}"
            assert _wait_for(lambda: client.status()["status"] == "RUNNING")
            assert main(["list", "--rest", rest]) == 0
            listed = capsys.readouterr().out
            assert client.job_id in listed
            assert main(["info", client.job_id, "--rest", rest]) == 0
            info = json.loads(capsys.readouterr().out)
            sp = str(tmp_path / f"sp-{pkg}")
            # RUNNING is set before the task reaches its TaskExecutor: the
            # savepoint is refused until it has (retry, as the
            # reference's test does)
            deadline = time.monotonic() + 20
            while True:
                try:
                    assert main(["savepoint", client.job_id, sp,
                                 "--rest", rest]) == 0
                    break
                except Exception:  # noqa: BLE001 - HTTP 500 until running
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            saved = json.loads(capsys.readouterr().out)
            assert main(["cancel", client.job_id, "--rest", rest]) == 0
            cancelled = json.loads(capsys.readouterr().out)
            st = client.wait(timeout=30)
            assert main(["inspect", sp]) == 0
            inspected = capsys.readouterr().out
        finally:
            cluster.shutdown()
        outputs[pkg] = (
            listed.replace(client.job_id, "<id>").split(),
            (info["status"], info["name"], info["attempt"],
             sorted(info)),
            saved == {"job_id": client.job_id, "savepoint": sp},
            cancelled == {"job_id": client.job_id, "status": "cancelling"},
            st["status"],
            [(line.strip().split(": ")[0],
              "keyed state" if "keyed state" in line
              else "source" if "source position" in line else "host")
             for line in inspected.splitlines() if line.startswith("  ")])
    assert outputs["port"] == outputs["reference"]
    assert outputs["port"][4] == "CANCELED"
    assert [k for _, k in outputs["port"][5]] == ["source", "keyed state"]


def test_query_fails_naming_item_12e(capsys, tmp_path):
    """``query`` (item 12e, served now) prints what the reference's prints
    for the same key of the same job at a held end of stream."""
    from flink_tpu_torch.benchmarks.held import release, settle, wait_held

    def run(pkg):
        ns = _ns(pkg)
        cluster = _cluster(ns, **{"rest.port": 0})
        hold = str(tmp_path / pkg)
        try:
            env = _env(ns, {"execution.micro-batch.size": 256})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 20_000, keys=40,
                       window=2000, hold_dir=hold)
            client = cluster.submit(env, "q")
            wait_held(hold)

            def query():
                capsys.readouterr()
                assert MAIN[pkg](["query", client.job_id,
                                  "window_agg(CountAggregate)", "3",
                                  "--rest",
                                  f"127.0.0.1:{cluster.rest_port}"]) == 0
                out = json.loads(capsys.readouterr().out)
                out.pop("job_id")
                return out

            out = settle(query)
            release(hold)
            client.wait(timeout=60)
            return out
        finally:
            cluster.shutdown()

    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["port"] == got["reference"]
    assert got["port"]["state"] and got["port"]["key"] == 3


def test_help_lists_every_command():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-m", "flink_tpu_torch.cli",
                          "--help"], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("run", "list", "info", "cancel", "savepoint", "query",
                "inspect", "jobmanager", "taskexecutor", "deploy"):
        assert cmd in out.stdout


def test_jobmanager_command_serves_rpc_and_rest(tmp_path):
    """``cli jobmanager`` in a process of its own announces its pinned RPC
    port and serves REST with no TaskExecutor and no job (the standalone
    tests join TaskExecutors and run jobs)."""
    import socket
    import urllib.request

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    rpc, rest = free_port(), free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    jm = subprocess.Popen(
        [sys.executable, "-m", "flink_tpu_torch.cli", "jobmanager",
         "--port", str(rpc), "--rest-port", str(rest)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = jm.stdout.readline()
        assert f"jobmanager rpc on 127.0.0.1:{rpc}" in line, \
            line + jm.stderr.read() if jm.poll() is not None else line

        def up():
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{rest}/overview", timeout=2)
                return True
            except OSError:
                return False

        assert _wait_for(up, timeout=30)
        ov = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{rest}/overview", timeout=5).read())
        assert ov["taskexecutors"] == 0 and ov["jobs"] == {}
    finally:
        jm.terminate()
        try:
            jm.wait(timeout=20)
        except subprocess.TimeoutExpired:
            jm.kill()
            jm.wait(timeout=10)
