"""Standalone deployment: the port's JobManager and remote TaskExecutors
(``flink_tpu_torch/cluster/standalone.py``) against the reference's on
the same jobs — counterparts of every test in ``tests/test_standalone.py``.
The first tests run JobManager and TaskExecutors in one test process on
separate RPC services (every interaction crosses a socket); the last boots
``python3 -m flink_tpu_torch.cli taskexecutor`` as a real process. Jobs
run with ``execution.device: cpu``; every wait is bounded."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from test_torch_minicluster import (
    PKGS,
    _both,
    _cluster,
    _counts,
    _env,
    _ns,
    _wait_for,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _standalone(ns):
    return __import__(
        ("flink_tpu" if ns.pkg == "reference" else "flink_tpu_torch")
        + ".cluster.standalone", fromlist=["x"])


def _pipeline(ns, env, out, total=20_000, slow=False):
    from test_torch_minicluster import _gen

    (env.add_source(
        _gen(ns, slow, total_records=total, num_keys=50,
             events_per_second_of_eventtime=10_000),
        ns.wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by("key").window(ns.win.TumblingEventTimeWindows.of(2000))
     .count().sink_to(ns.sinks.JsonLinesFileSink(str(out))))


def _wait(dispatcher, job_id, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = dispatcher.job_status(job_id)
        if st["status"] in ("FINISHED", "FAILED", "CANCELED"):
            return st
        time.sleep(0.05)
    raise TimeoutError(dispatcher.job_status(job_id))


def test_job_runs_on_remote_taskexecutor(tmp_path):
    def run(ns):
        sa = _standalone(ns)
        jm = _cluster(ns, **{"cluster.task-executors": 0})
        te = None
        try:
            empty = jm.rm_gateway().executor_registry() == {}
            te = sa.TaskExecutorRunner(jm.service.address, ns.cfg.Configuration(
                {"heartbeat.interval-ms": 100})).start()
            reg = jm.rm_gateway().executor_registry()
            registered = (te.executor_id in reg
                          and reg[te.executor_id]["address"] == te.address
                          and te.address != jm.service.address)
            env = _env(ns, {"execution.micro-batch.size": 2048})
            out = tmp_path / f"{ns.pkg}.jsonl"
            _pipeline(ns, env, out)
            job_id, dispatcher = sa.remote_submit(jm.service.address, env,
                                                  "standalone-job")
            st = _wait(dispatcher, job_id)
            time.sleep(0.3)
            age = jm.rm_gateway().executor_registry()[
                te.executor_id]["heartbeat_age_s"]
            return (empty, registered, st["status"], age < 5,
                    _counts(ns.sinks.JsonLinesFileSink.read_rows(str(out))))
        finally:
            if te is not None:
                te.stop()
            jm.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][:4] == (True, True, "FINISHED", True)
    assert sum(got["port"][4].values()) == 20_000


def test_rest_lists_remote_executor(tmp_path):
    def run(ns):
        sa = _standalone(ns)
        jm = _cluster(ns, **{"cluster.task-executors": 0, "rest.port": 0})
        te = None
        try:
            te = sa.TaskExecutorRunner(jm.service.address).start()
            body = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{jm.rest_port}/taskexecutors",
                timeout=10).read())
            entry = [e for e in body["executors"]
                     if e.get("executor_id") == te.executor_id]
            return (len(entry), entry[0]["address"] == te.address,
                    sorted(entry[0]))
        finally:
            if te is not None:
                te.stop()
            jm.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][:2] == (1, True)


def test_worker_death_detected_and_job_fails_over(tmp_path):
    def run(ns):
        sa = _standalone(ns)
        jm = _cluster(ns, **{"cluster.task-executors": 0,
                             "heartbeat.interval-ms": 100,
                             "heartbeat.timeout-ms": 1000})
        runners = []
        try:
            for _ in range(2):
                runners.append(sa.TaskExecutorRunner(
                    jm.service.address, ns.cfg.Configuration(
                        {"heartbeat.interval-ms": 100})).start())
            env = _env(ns, {
                "execution.micro-batch.size": 256,
                "execution.checkpointing.every-n-source-batches": 4,
                "state.checkpoints.dir": str(tmp_path / f"ck-{ns.pkg}"),
                "restart-strategy.max-attempts": 3,
                "restart-strategy.delay-ms": 100})
            out = tmp_path / f"{ns.pkg}.jsonl"
            _pipeline(ns, env, out, total=40_000, slow=True)
            job_id, dispatcher = sa.remote_submit(jm.service.address, env,
                                                  "failover-job")
            victim = []
            assert _wait_for(lambda: victim.extend(
                r for r in runners if r.endpoint._tasks) or victim,
                timeout=30), "job never deployed"
            t0 = time.monotonic()
            victim[0].service.stop()  # hard kill: no dead-mark courtesy
            runners.remove(victim[0])
            st = _wait(dispatcher, job_id, timeout=90)
            return (st["status"], st["attempt"] >= 1,
                    time.monotonic() - t0 < 60,
                    _counts(ns.sinks.JsonLinesFileSink.read_rows(str(out))))
        finally:
            for r in runners:
                try:
                    r.stop()
                except Exception:
                    pass
            jm.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][:3] == ("FINISHED", True, True)
    assert sum(got["port"][3].values()) == 40_000


def test_taskexecutor_process_from_the_cli(tmp_path):
    """``python3 -m flink_tpu_torch.cli taskexecutor`` in its own process
    joins the JobManager; a remote submit runs there on the CPU and the
    process reports its device. It is stopped whatever the outcome."""
    ns = _ns("port")
    sa = _standalone(ns)
    jm = _cluster(ns, **{"cluster.task-executors": 0,
                         "heartbeat.interval-ms": 100})
    env_vars = dict(os.environ)
    env_vars.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "flink_tpu_torch.cli", "taskexecutor",
         "--jobmanager", jm.service.address,
         "-D", "heartbeat.interval-ms=100"],
        cwd=ROOT, env=env_vars, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("taskexecutor "), (line, proc.poll())
        assert "device cpu (no CUDA card)" in line
        assert _wait_for(lambda: len(jm.rm_gateway().executor_registry())
                         == 1, timeout=30)
        env = _env(ns, {"execution.micro-batch.size": 2048})
        out = tmp_path / "out.jsonl"
        _pipeline(ns, env, out, total=10_000)
        job_id, dispatcher = sa.remote_submit(jm.service.address, env,
                                              "xproc-job")
        st = _wait(dispatcher, job_id, timeout=120)
        assert st["status"] == "FINISHED", st
        got = _counts(ns.sinks.JsonLinesFileSink.read_rows(str(out)))
        assert sum(got.values()) == 10_000
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        jm.shutdown()
