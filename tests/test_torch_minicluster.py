"""The port's MiniCluster (``flink_tpu_torch/cluster/minicluster.py``)
against the reference's on the same jobs: statuses, attempts, slot
accounting and the rows the jobs write, compared package to package.

Counterparts of the MiniCluster cases of ``tests/test_cluster.py``,
``test_multi_slot_cluster.py``, ``test_savepoints.py``,
``test_two_phase.py``, ``test_file_sink.py`` and ``test_pipelining.py``,
plus cancellation in both executor modes, the cold rescale, point queries
at a held end of stream and a reference savepoint resumed on the port's
cluster.
Port jobs run with ``execution.device: cpu``. The graph is shipped to the
TaskExecutor, so jobs write through files; a crash-once flag lives in a
file because each deployment attempt unpickles the graph anew. Every wait
has a timeout.
"""

import importlib
import json
import os
import time
import types

import pytest

PKGS = ("reference", "port")


def _ns(pkg):
    base = "flink_tpu" if pkg == "reference" else "flink_tpu_torch"

    def m(name):
        return importlib.import_module(f"{base}.{name}")

    return types.SimpleNamespace(
        pkg=pkg, mc=m("cluster.minicluster"), cfg=m("core.config"),
        env=m("datastream.environment"), sinks=m("connectors.sinks"),
        sources=m("connectors.sources"), wm=m("runtime.watermarks"),
        win=m("windowing.assigners"), two_phase=m("connectors.two_phase"),
        fs=m("connectors.filesystem"))


def _env(ns, conf):
    conf = dict(conf)
    if ns.pkg == "port":
        conf["execution.device"] = "cpu"
    return ns.env.StreamExecutionEnvironment(ns.cfg.Configuration(conf))


def _cluster(ns, **conf):
    return ns.mc.MiniCluster(ns.cfg.Configuration(
        {"rest.port": -1, **conf}))


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# The sources below are module level so both serializers ship them by
# reference (a slow source must be a class of an importable module).

from flink_tpu.connectors.sources import (  # noqa: E402
    DataGenSource as _RefGen,
)
from flink_tpu_torch.connectors.sources import (  # noqa: E402
    DataGenSource as _PortGen,
)


from flink_tpu_torch.benchmarks.held import (  # noqa: E402
    HeldDataGenSource as _PortHeld,
    _HoldEnd,
)


class Ref:
    class HeldDataGen(_HoldEnd, _RefGen):
        """The reference's DataGen holding its end of stream until
        released (``flink_tpu_torch/benchmarks/held.py``'s hold)."""

        def __init__(self, hold_dir, **kw):
            _RefGen.__init__(self, **kw)
            self._init_hold(hold_dir)

    class SlowDataGen(_RefGen):
        sleep_s = 0.01

        def poll_batch(self, n):
            b = super().poll_batch(n)
            if b is not None and self.sleep_s:
                time.sleep(self.sleep_s)
            return b


class Port:
    """The same class name as the reference's: a source's class name is
    part of its operator's stable id, so a savepoint moves between the
    packages only between equal names."""

    HeldDataGen = _PortHeld

    class SlowDataGen(_PortGen):
        sleep_s = 0.01

        def poll_batch(self, n):
            b = super().poll_batch(n)
            if b is not None and self.sleep_s:
                time.sleep(self.sleep_s)
            return b


def _gen(ns, slow=False, hold_dir=None, **kw):
    pkg = Ref if ns.pkg == "reference" else Port
    if hold_dir is not None:
        return pkg.HeldDataGen(hold_dir, **kw)
    if slow:
        return pkg.SlowDataGen(**kw)
    return ns.sources.DataGenSource(**kw)


def _count_job(ns, env, sink, total, slow=False, window=500, keys=5,
               rate=4000, mapper=None, hold_dir=None):
    ds = env.add_source(
        _gen(ns, slow, hold_dir, total_records=total, num_keys=keys,
             events_per_second_of_eventtime=rate),
        ns.wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
    if mapper is not None:
        ds = ds.map(mapper, name="poison")
    ds.key_by("key").window(ns.win.TumblingEventTimeWindows.of(window)) \
        .count().sink_to(sink)


def _task_running(cluster, client, attempt=0):
    """The job's task has reached a TaskExecutor and runs (the JobMaster
    reports RUNNING just before it deploys)."""
    eid = f"{client.job_id}-{attempt}"
    return any(te.task_status(eid)["status"] == "RUNNING"
               for te in cluster.executors)


def _counts(rows):
    """Last row per (key, window): an at-least-once file sink may hold an
    attempt's partial emissions before its restart."""
    out = {}
    for r in rows:
        out[(int(r["key"]), int(r["window_start"]))] = int(r["count"])
    return out


def _both(fn):
    return {pkg: fn(_ns(pkg)) for pkg in PKGS}


# ------------------------------------------------------ test_cluster.py


def _rows_pipeline(ns, env, sink, mapper=None):
    rows = [{"k": i % 5, "v": 1, "ts": i * 10} for i in range(5000)]
    ds = env.from_collection(rows, timestamp_field="ts")
    ds = ds.map(mapper if mapper is not None else (lambda b: b),
                name="failmap")
    ds.key_by("k").window(ns.win.TumblingEventTimeWindows.of(1000)) \
        .sum("v").sink_to(sink)


@pytest.fixture(scope="module")
def clusters():
    made = {pkg: _cluster(_ns(pkg), **{"cluster.task-executors": 2,
                                       "heartbeat.interval-ms": 100})
            for pkg in PKGS}
    yield made
    for c in made.values():
        c.shutdown()


def test_submit_and_finish(clusters):
    def run(ns):
        env = _env(ns, {"execution.micro-batch.size": 512})
        _rows_pipeline(ns, env, ns.sinks.CollectSink())
        client = clusters[ns.pkg].submit(env, "happy-job")
        st = client.wait(timeout=60)
        res = client.result()
        assert res.metric_snapshot  # the wire-safe registry snapshot
        return (st["status"], st["attempt"], st["name"],
                res.metrics["records_emitted_by_sources"], res.job_name)

    got = _both(run)
    assert got["port"] == got["reference"] == (
        "FINISHED", 0, "happy-job", 5000, "happy-job")


def test_udf_failure_exhausts_restarts(clusters):
    def run(ns):
        env = _env(ns, {"execution.micro-batch.size": 512,
                        "restart-strategy.max-attempts": 2,
                        "restart-strategy.delay-ms": 10})
        state = {"seen": 0}

        def poison(batch):
            state["seen"] += len(batch)
            if state["seen"] > 100:
                raise RuntimeError("injected fault")
            return batch

        _rows_pipeline(ns, env, ns.sinks.CollectSink(), mapper=poison)
        st = clusters[ns.pkg].submit(env, "doomed-job").wait(timeout=60)
        assert "injected fault" in st["error"]
        states = [h["state"] for h in st["state_history"]]
        return st["status"], st["attempt"], states

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][:2] == ("FAILED", 1)
    assert got["port"][2] == ["CREATED", "RUNNING", "RESTARTING",
                              "RUNNING", "FAILED"]


def test_failover_restores_from_checkpoint(clusters, tmp_path):
    def run(ns):
        d = tmp_path / ns.pkg
        d.mkdir()
        env = _env(ns, {"execution.micro-batch.size": 256,
                        "state.checkpoints.dir": str(d / "ckpt"),
                        "execution.checkpointing.every-n-source-batches": 2,
                        "restart-strategy.max-attempts": 3,
                        "restart-strategy.delay-ms": 10})
        out = str(d / "out.jsonl")
        flag = str(d / "crashed.flag")

        def poison_once(batch, flag=flag):
            import os

            if not os.path.exists(flag) and \
                    int(batch.timestamps.max()) > 15_000:
                with open(flag, "w") as f:
                    f.write("x")
                raise RuntimeError("crash once")
            return batch

        _rows_pipeline(ns, env, ns.sinks.JsonLinesFileSink(out),
                       mapper=poison_once)
        st = clusters[ns.pkg].submit(env, "phoenix-job").wait(timeout=60)
        seen = {}
        for r in ns.sinks.JsonLinesFileSink.read_rows(out):
            seen[(r["k"], r["window_start"])] = r["sum_v"]
        return st["status"], st["attempt"], seen

    got = _both(run)
    assert got["port"] == got["reference"]
    status, attempt, seen = got["port"]
    assert (status, attempt) == ("FINISHED", 1)
    assert sum(seen.values()) == 5000


@pytest.mark.parametrize("mode", ["single-slot", "stage"])
def test_kill_task_executor_fails_over(tmp_path, mode):
    def run(ns):
        cluster = _cluster(ns, **{"cluster.task-executors": 2,
                                  "taskmanager.numberOfTaskSlots": 2,
                                  "heartbeat.interval-ms": 100})
        try:
            out = str(tmp_path / f"{ns.pkg}.jsonl")
            conf = {"execution.micro-batch.size": 256,
                    "restart-strategy.max-attempts": 3,
                    "restart-strategy.delay-ms": 10,
                    "heartbeat.timeout-ms": 1000}
            if mode == "stage":
                conf["execution.stage-parallelism"] = 2
            env = _env(ns, conf)
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(out), 30_000,
                       slow=True)
            client = cluster.submit(env, "survivor-job")
            exec_id = f"{client.job_id}-0"
            victim = []

            def running():
                for te in cluster.executors:
                    if te.task_status(exec_id)["status"] == "RUNNING":
                        victim.append(te.endpoint_id)
                        return True
                return False

            assert _wait_for(running)
            cluster.kill_task_executor(victim[0])
            st = client.wait(timeout=60)
            master = cluster.dispatcher.master(client.job_id)
            return (st["status"], master.attempt >= 1,
                    "task executor lost" in repr(master.error)
                    or master.error is None,
                    _counts(ns.sinks.JsonLinesFileSink.read_rows(out)))
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"][:2] == got["reference"][:2] == ("FINISHED", True)
    # every record counted once over the windows of the last attempt
    assert got["port"][3] == got["reference"][3]
    assert sum(got["port"][3].values()) == 30_000


# ------------------------------------ restart-seeded slot accounting


def _rm(pkg):
    return _ns(pkg).mc.ResourceManagerEndpoint()


def _alloc(rm):
    return rm.executor_registry()["te-1"]["allocated"]


@pytest.mark.parametrize("pkg", PKGS)
def test_fresh_registration_seeds_occupied_slots(pkg):
    rm = _rm(pkg)
    rm.register_task_executor("te-1", "addr:1", 2, running_tasks=1)
    assert _alloc(rm) == 1
    assert rm.request_slot() is not None
    assert rm.request_slot() is None


@pytest.mark.parametrize("pkg", PKGS)
def test_keepalive_reregistration_does_not_reseed(pkg):
    rm = _rm(pkg)
    rm.register_task_executor("te-1", "addr:1", 2, running_tasks=1)
    assert rm.request_slot() is not None
    rm.register_task_executor("te-1", "addr:1", 2, running_tasks=2)
    assert _alloc(rm) == 2
    assert rm.request_slot() is None


@pytest.mark.parametrize("pkg", PKGS)
def test_seed_drains_as_orphans_finish(pkg):
    rm = _rm(pkg)
    rm.register_task_executor("te-1", "addr:1", 2, running_tasks=1)
    assert rm.request_slot() is not None
    rm.heartbeat_from("te-1", running_tasks=1)
    assert _alloc(rm) == 2
    rm._executors["te-1"]["alloc_times"] = []
    rm.heartbeat_from("te-1", running_tasks=1)
    assert _alloc(rm) == 1
    rm.release_slot("te-1")
    assert _alloc(rm) == 0
    assert rm.request_slot() is not None
    assert rm.request_slot() is not None
    assert rm.request_slot() is None


@pytest.mark.parametrize("pkg", PKGS)
def test_seed_drains_under_steady_allocation_churn(pkg):
    rm = _rm(pkg)
    rm.register_task_executor("te-1", "addr:1", 8, running_tasks=3)
    assert rm.request_slot() is not None
    assert rm.request_slot() is not None
    rm.heartbeat_from("te-1", running_tasks=2)
    assert _alloc(rm) == 4
    rm._executors["te-1"]["alloc_times"] = []
    rm.heartbeat_from("te-1", running_tasks=2)
    assert _alloc(rm) == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_seed_never_grows_from_heartbeat_and_blocklist(pkg):
    rm = _rm(pkg)
    rm.register_task_executor("te-1", "addr:1", 4, running_tasks=1)
    rm._executors["te-1"]["alloc_times"] = []
    rm.heartbeat_from("te-1", running_tasks=0)
    assert _alloc(rm) == 0
    rm.heartbeat_from("te-1", running_tasks=3)
    assert _alloc(rm) == 0
    rm.block_node("te-1")
    assert rm.request_slot() is None
    rm.mark_dead("te-1")
    assert rm.live_executors() == []


# ----------------------------------------- test_multi_slot_cluster.py


def _sum_job(ns, env, sink, total=30_000, slow=False, group=None):
    agg = (env.from_source(
        _gen(ns, slow, total_records=total, num_keys=200,
             events_per_second_of_eventtime=10_000, seed=9),
        ns.wm.WatermarkStrategy.for_bounded_out_of_orderness(0),
        name="gen")
        .key_by("key").window(ns.win.TumblingEventTimeWindows.of(1000))
        .sum("value"))
    if group is not None:
        agg = agg.slot_sharing_group(group)
    agg.sink_to(sink)


def _sums(rows):
    return {(r["key"], r["window_start"]): round(r["sum_value"], 3)
            for r in rows}


def _allocated(cluster):
    return {eid: info["allocated"]
            for eid, info in cluster.rm._executors.items()}


def test_job_spans_executors(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"cluster.task-executors": 2,
                                  "taskmanager.numberOfTaskSlots": 2})
        try:
            out = str(tmp_path / f"{ns.pkg}.jsonl")
            env = _env(ns, {"execution.micro-batch.size": 1000,
                            "execution.stage-parallelism": 3})
            _sum_job(ns, env, ns.sinks.JsonLinesFileSink(out), slow=True)
            client = cluster.submit(env, "spanning")
            held = {}

            def three():
                held.update(_allocated(cluster))
                return sum(held.values()) >= 3

            assert _wait_for(three)
            spans = sum(1 for v in held.values() if v > 0)
            st = client.wait(timeout=60)
            left = sum(_allocated(cluster).values())
            return (st["status"], spans, left,
                    client.result().metrics["stage_parallelism"],
                    _sums(ns.sinks.JsonLinesFileSink.read_rows(out)))
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"][:4] == got["reference"][:4] == ("FINISHED", 2, 0, 3)
    from tests.conftest import assert_windows_approx_equal

    assert_windows_approx_equal(got["port"][4], got["reference"][4])


def test_scales_to_available_slots(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"cluster.task-executors": 3})
        try:
            out = str(tmp_path / f"{ns.pkg}.jsonl")
            env = _env(ns, {"execution.micro-batch.size": 1000,
                            "execution.stage-parallelism": 5})
            _sum_job(ns, env, ns.sinks.JsonLinesFileSink(out))
            client = cluster.submit(env, "scaled")
            st = client.wait(timeout=60)
            return (st["status"],
                    client.result().metrics["stage_parallelism"],
                    _sums(ns.sinks.JsonLinesFileSink.read_rows(out)))
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"][:2] == got["reference"][:2] == ("FINISHED", 3)
    from tests.conftest import assert_windows_approx_equal

    assert_windows_approx_equal(got["port"][2], got["reference"][2])


def test_participating_executor_death_fails_over(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"cluster.task-executors": 3,
                                  "heartbeat.timeout-ms": 400})
        try:
            out = str(tmp_path / f"{ns.pkg}.jsonl")
            env = _env(ns, {
                "execution.micro-batch.size": 1000,
                "execution.stage-parallelism": 3,
                "state.checkpoints.dir": str(tmp_path / f"ck-{ns.pkg}"),
                "execution.checkpointing.every-n-source-batches": 4,
                "restart-strategy.max-attempts": 3,
                "restart-strategy.delay-ms": 50})
            _sum_job(ns, env, ns.sinks.JsonLinesFileSink(out), total=40_000,
                     slow=True)
            client = cluster.submit(env, "failover")
            master = cluster.dispatcher.master(client.job_id)
            assert _wait_for(lambda: sum(_allocated(cluster).values()) >= 3
                             and master.status == "RUNNING")
            primary = master._current_executor
            victim = next(e for e in cluster.rm._executors if e != primary)
            time.sleep(0.3)  # let a checkpoint land
            cluster.kill_task_executor(victim)
            st = client.wait(timeout=90)
            return (st["status"], master.attempt >= 1,
                    _sums(ns.sinks.JsonLinesFileSink.read_rows(out)))
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"][:2] == got["reference"][:2] == ("FINISHED", True)
    from tests.conftest import assert_windows_approx_equal

    assert_windows_approx_equal(got["port"][2], got["reference"][2])


def test_extra_slot_sharing_group_holds_an_extra_slot(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"taskmanager.numberOfTaskSlots": 2})
        try:
            env = _env(ns, {"execution.micro-batch.size": 500})
            _sum_job(ns, env, ns.sinks.JsonLinesFileSink(
                str(tmp_path / f"{ns.pkg}.jsonl")), slow=True,
                group="isolated")
            client = cluster.submit(env, "grouped")
            held = {}

            def two():
                held.update(_allocated(cluster))
                return sum(held.values()) >= 2

            assert _wait_for(two)
            st = client.wait(timeout=60)
            return st["status"], sum(_allocated(cluster).values())
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"] == ("FINISHED", 0)


# ------------------------------------------------- test_savepoints.py


def _retry_savepoint(call, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return call()
        except RuntimeError:
            time.sleep(0.02)
    raise TimeoutError("the job never accepted the savepoint")


def test_trigger_savepoint_while_running(tmp_path):
    def run(ns):
        sp_mod = importlib.import_module(
            ("flink_tpu" if ns.pkg == "reference" else "flink_tpu_torch")
            + ".checkpoint.savepoint")
        reader_mod = importlib.import_module(
            ("flink_tpu" if ns.pkg == "reference" else "flink_tpu_torch")
            + ".state_processor")
        cluster = _cluster(ns)
        try:
            env = _env(ns, {"execution.micro-batch.size": 512})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 20_000,
                       slow=True)
            client = cluster.submit(env, "sp-job")
            sp = str(tmp_path / f"sp-{ns.pkg}")
            path = _retry_savepoint(lambda: client.trigger_savepoint(sp))
            ops = reader_mod.SavepointReader.load(sp).operators()
            st = client.wait(timeout=30)
            return path == sp, sp_mod.is_savepoint(sp), len(ops), \
                st["status"]
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] and got["port"][1] and got["port"][2] > 0
    assert got["port"][3] == "FINISHED"


def _oracle(ns, total):
    env = _env(ns, {"execution.micro-batch.size": 512})
    sink = ns.sinks.CollectSink()
    _count_job(ns, env, sink, total)
    env.execute("oracle")
    return _counts(sink.rows())


def test_stop_with_savepoint_and_resume_is_exactly_once(tmp_path):
    total = 12_000

    def run(ns):
        oracle = _oracle(ns, total)
        cluster = _cluster(ns)
        sp = str(tmp_path / f"sp-{ns.pkg}")
        out1 = str(tmp_path / f"part1-{ns.pkg}.jsonl")
        try:
            env1 = _env(ns, {"execution.micro-batch.size": 512})
            _count_job(ns, env1, ns.sinks.JsonLinesFileSink(out1), total,
                       slow=True)
            client = cluster.submit(env1, "stop-job")
            _retry_savepoint(lambda: client.stop_with_savepoint(sp))
            assert client.wait(timeout=30)["status"] == "FINISHED"
        finally:
            cluster.shutdown()
        part1 = _counts(ns.sinks.JsonLinesFileSink.read_rows(out1))
        env2 = _env(ns, {"execution.micro-batch.size": 512})
        sink2 = ns.sinks.CollectSink()
        _count_job(ns, env2, sink2, total, slow=True)
        env2.execute("resume", restore_from=sp)
        part2 = _counts(sink2.rows())
        assert len(part1) < len(oracle)  # genuinely stopped mid-flight
        assert not (set(part1) & set(part2))
        return {**part1, **part2}, oracle

    got = _both(run)
    assert got["port"][0] == got["port"][1] == got["reference"][1]
    assert got["reference"][0] == got["reference"][1]


def test_stop_with_savepoint_drain_flushes_windows(tmp_path):
    total = 12_000

    def run(ns):
        cluster = _cluster(ns)
        sp = str(tmp_path / f"sp-{ns.pkg}")
        out = str(tmp_path / f"drained-{ns.pkg}.jsonl")
        try:
            env = _env(ns, {"execution.micro-batch.size": 128,
                            "execution.pipeline.in-flight-batches": 4})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(out), total,
                       slow=True)
            client = cluster.submit(env, "drain-job")
            _retry_savepoint(
                lambda: client.stop_with_savepoint(sp, drain=True))
            st = client.wait(timeout=30)
        finally:
            cluster.shutdown()
        emitted = sum(_counts(
            ns.sinks.JsonLinesFileSink.read_rows(out)).values())
        storage = importlib.import_module(
            ("flink_tpu" if ns.pkg == "reference" else "flink_tpu_torch")
            + ".checkpoint.storage")
        states = storage.read_snapshot_dir(sp)
        src = next(s for s in states.values() if "source" in s)
        return st["status"], emitted, src["source"]["emitted"]

    got = _both(run)
    for pkg in PKGS:
        status, emitted, position = got[pkg]
        assert status == "FINISHED"
        # drain: every record the source handed out up to the savepoint's
        # position is in the flushed output (prefetched batches included)
        assert 0 < emitted == position < total, (pkg, got[pkg])


def test_savepoint_never_overwrites_a_user_directory(tmp_path):
    def run(ns):
        victim = tmp_path / f"precious-{ns.pkg}"
        victim.mkdir()
        (victim / "data.txt").write_text("do not delete")
        cluster = _cluster(ns)
        try:
            env = _env(ns, {"execution.micro-batch.size": 512})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 12_000,
                       slow=True)
            client = cluster.submit(env, "safety-job")
            deadline = time.monotonic() + 20
            refused = False
            while time.monotonic() < deadline:
                try:
                    client.stop_with_savepoint(str(victim))
                    break
                except FileExistsError:
                    refused = True
                    break
                except RuntimeError:
                    time.sleep(0.02)
            st = client.wait(timeout=30)
            return (refused, (victim / "data.txt").read_text(),
                    st["status"])
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"] == (True, "do not delete",
                                               "FINISHED")


# ------------------------- test_two_phase.py, test_file_sink.py,
# ------------------------- test_pipelining.py (exactly once across a crash)


def _poison_once(flag):
    def poison_once(b, flag=flag):
        import os as _os

        ts = b.timestamps
        if len(ts) and ts.max() > 900 and not _os.path.exists(flag):
            open(flag, "w").write("x")
            raise RuntimeError("injected fault")
        return b

    return poison_once


@pytest.mark.parametrize("in_flight", [None, 4],
                         ids=["default-pumps", "four-in-flight"])
def test_two_phase_sink_commits_every_window_once(tmp_path, in_flight):
    total = 12_000

    def run(ns):
        d = tmp_path / ns.pkg
        d.mkdir()
        conf = {"execution.micro-batch.size": 256,
                "state.checkpoints.dir": str(d / "ck"),
                "execution.checkpointing.every-n-source-batches": 2,
                "restart-strategy.max-attempts": 3,
                "restart-strategy.delay-ms": 10}
        if in_flight is not None:
            conf["execution.pipeline.in-flight-batches"] = in_flight
            conf["execution.checkpointing.every-n-source-batches"] = 3
        env = _env(ns, conf)
        _count_job(ns, env, ns.two_phase.ExactlyOnceFileSink(str(d / "o")),
                   total, keys=10, rate=10_000,
                   mapper=_poison_once(str(d / "flag")))
        cluster = _cluster(ns)
        try:
            st = cluster.submit(env, "2pc-job").wait(timeout=60)
        finally:
            cluster.shutdown()
        per_window = {}
        for r in ns.two_phase.ExactlyOnceFileSink.read_committed_rows(
                str(d / "o")):
            k = (int(r["key"]), int(r["window_start"]))
            assert k not in per_window, f"window committed twice: {k}"
            per_window[k] = int(r["count"])
        return st["status"], st["attempt"] >= 1, per_window

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][:2] == ("FINISHED", True)
    assert sum(got["port"][2].values()) == total


def test_file_sink_commits_every_window_once(tmp_path):
    total = 12_000

    def run(ns):
        d = tmp_path / ns.pkg
        d.mkdir()
        env = _env(ns, {"execution.micro-batch.size": 256,
                        "state.checkpoints.dir": str(d / "ck"),
                        "execution.checkpointing.every-n-source-batches": 2,
                        "restart-strategy.max-attempts": 3,
                        "restart-strategy.delay-ms": 10})
        out = str(d / "out")
        sink = ns.fs.FileSink(out, ["key", "window_start", "sum_value"],
                              fmt="json",
                              bucket_assigner=ns.fs.ColumnBucketAssigner(
                                  "key"))
        (env.add_source(_gen(ns, total_records=total, num_keys=10,
                             events_per_second_of_eventtime=10_000),
                        ns.wm.WatermarkStrategy
                        .for_bounded_out_of_orderness(0))
            .map(_poison_once(str(d / "flag")), name="poison")
            .key_by("key").window(ns.win.TumblingEventTimeWindows.of(500))
            .sum("value").sink_to(sink))
        cluster = _cluster(ns)
        try:
            st = cluster.submit(env, "file-sink-failover").wait(timeout=60)
        finally:
            cluster.shutdown()
        seen = {}
        for raw in ns.fs.read_committed_rows(out):
            r = json.loads(raw)
            k = (r["key"], r["window_start"])
            assert k not in seen, f"window emitted twice: {k}"
            seen[k] = r["sum_value"]
        return st["status"], st["attempt"] >= 1, \
            sorted(os.listdir(out)), seen

    got = _both(run)
    assert got["port"][:3] == got["reference"][:3]
    assert got["port"][2] == [str(k) for k in range(10)]
    assert set(got["port"][3]) == set(got["reference"][3])
    assert len(got["port"][3]) == 10 * 3
    for k, v in got["reference"][3].items():
        assert got["port"][3][k] == pytest.approx(v, rel=1e-6), k


# ------------------------------------------------------ cancellation


@pytest.mark.parametrize("mode", ["single-slot", "stage"])
def test_cancelled_job_ends_canceled(tmp_path, mode):
    def run(ns):
        cluster = _cluster(ns, **{"taskmanager.numberOfTaskSlots": 2})
        try:
            conf = {"execution.micro-batch.size": 256}
            if mode == "stage":
                conf["execution.stage-parallelism"] = 2
            env = _env(ns, conf)
            _count_job(ns, env, ns.sinks.DiscardingSink(), 2_000_000,
                       slow=True)
            client = cluster.submit(env, "cancel-me")
            assert _wait_for(lambda: client.status()["status"] == "RUNNING")
            time.sleep(0.2)
            client.cancel()
            st = client.wait(timeout=30)
            master = cluster.dispatcher.master(client.job_id)
            te_status = [te.task_status(f"{client.job_id}-0")["status"]
                         for te in cluster.executors]
            return st["status"], master.attempt, "CANCELED" in te_status
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"] == ("CANCELED", 0, True)


def test_cancel_event_reaches_both_executors_directly():
    """``run(cancel_event=)`` of the port's two executors raises
    ``JobCancelledError`` once the event is set."""
    import threading

    from flink_tpu_torch.cluster.local_executor import (
        JobCancelledError,
        LocalExecutor,
    )
    from flink_tpu_torch.cluster.stage_executor import StageParallelExecutor

    ns = _ns("port")
    for executor, conf in ((LocalExecutor, {}),
                           (StageParallelExecutor,
                            {"execution.stage-parallelism": 2})):
        env = _env(ns, {"execution.micro-batch.size": 256, **conf})
        _count_job(ns, env, ns.sinks.DiscardingSink(), 2_000_000, slow=True)
        cancel = threading.Event()
        threading.Timer(0.3, cancel.set).start()
        t0 = time.monotonic()
        with pytest.raises(JobCancelledError):
            executor(env.config).run(env.get_stream_graph(), "c",
                                     cancel_event=cancel)
        assert time.monotonic() - t0 < 10


# ---------------------------------------- cold rescale, point queries


def test_request_rescale_redeploys_from_the_checkpoint(tmp_path):
    total = 30_000

    def run(ns):
        cluster = _cluster(ns, **{"taskmanager.numberOfTaskSlots": 4})
        try:
            out = str(tmp_path / f"{ns.pkg}.jsonl")
            env = _env(ns, {
                "execution.micro-batch.size": 500,
                "execution.stage-parallelism": 2,
                "state.checkpoints.dir": str(tmp_path / f"ck-{ns.pkg}"),
                "execution.checkpointing.every-n-source-batches": 2})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(out), total,
                       slow=True)
            client = cluster.submit(env, "rescale")
            master = cluster.dispatcher.master(client.job_id)
            assert _wait_for(lambda: master.status == "RUNNING")
            assert not master.request_rescale(2)  # already at 2
            time.sleep(0.3)
            accepted = master.request_rescale(3)
            st = client.wait(timeout=60)
            return (accepted, st["status"], master.attempt >= 1,
                    master.current_parallelism,
                    client.result().metrics["stage_parallelism"],
                    _counts(ns.sinks.JsonLinesFileSink.read_rows(out)))
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"][:5] == got["reference"][:5] == (
        True, "FINISHED", True, 3, 3)
    assert got["port"][5] == got["reference"][5]
    assert sum(got["port"][5].values()) == total


def test_point_queries_reach_the_executors_refusal(tmp_path):
    """Point queries (item 12e, served now) through the Dispatcher, the
    JobMaster and the TaskExecutor to the task's next batch boundary: at
    the held end of stream both packages answer the same dicts, as plain
    Python scalars after the RPC frame."""
    from flink_tpu_torch.benchmarks.held import release, settle, wait_held

    def run(ns):
        cluster = _cluster(ns)
        hold = str(tmp_path / ns.pkg)
        try:
            env = _env(ns, {"execution.micro-batch.size": 256})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 20_000, keys=40,
                       window=2000, hold_dir=hold)
            client = cluster.submit(env, "query-me")
            wait_held(hold)
            gw = cluster.dispatcher_gateway()
            op = "window_agg(CountAggregate)"
            batch = settle(lambda: gw.query_state_batch(
                client.job_id, op, list(range(45))))
            one = gw.query_state(client.job_id, op, 3)
            ns_one = gw.query_state_batch(client.job_id, op, [3, 4],
                                          max(one))
            with pytest.raises(KeyError, match="available"):
                gw.query_state_batch(client.job_id, "window", [1, 2])
            release(hold)
            assert client.wait(timeout=60)["status"] == "FINISHED"
            return batch, one, ns_one
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    batch, one, ns_one = got["port"]
    assert batch[3] == one and len(ns_one[0]) == 1
    assert sum(1 for a in batch if a) == 40
    assert all(type(c) is int for a in batch for w in a.values()
               for c in w.values())


# ----------------------- a reference savepoint resumed on the port


def test_reference_savepoint_resumes_on_the_port_cluster(tmp_path):
    """A stop-with-savepoint taken by the reference's ``JobClient``,
    carried through ``convert.from_jax_checkpoint_state`` into a port
    checkpoint root, resumes on the port's MiniCluster: the resumed
    windows equal the reference's own resume."""
    from flink_tpu.checkpoint.storage import read_snapshot_dir
    from flink_tpu_torch.checkpoint.storage import CheckpointStorage
    from flink_tpu_torch.convert import from_jax_checkpoint_state

    total = 12_000
    ref, port = _ns("reference"), _ns("port")
    sp = str(tmp_path / "ref-sp")
    cluster = _cluster(ref)
    try:
        env = _env(ref, {"execution.micro-batch.size": 512})
        _count_job(ref, env, ref.sinks.DiscardingSink(), total, slow=True)
        client = cluster.submit(env, "stop-job")
        _retry_savepoint(lambda: client.stop_with_savepoint(sp))
        assert client.wait(timeout=30)["status"] == "FINISHED"
    finally:
        cluster.shutdown()

    # the reference's own resume
    env = _env(ref, {"execution.micro-batch.size": 512})
    sink = ref.sinks.CollectSink()
    _count_job(ref, env, sink, total, slow=True)
    env.execute("resume", restore_from=sp)
    want = _counts(sink.rows())

    # the port's: the converted state as checkpoint 1 of the job's root
    root = str(tmp_path / "port-ck")
    CheckpointStorage(root).write_checkpoint(
        1, "stop-job", from_jax_checkpoint_state(read_snapshot_dir(sp)))
    out = str(tmp_path / "port.jsonl")
    env = _env(port, {"execution.micro-batch.size": 512,
                      "state.checkpoints.dir": root})
    _count_job(port, env, port.sinks.JsonLinesFileSink(out), total,
               slow=True)
    cluster = _cluster(port)
    try:
        st = cluster.submit(env, "resume").wait(timeout=60)
    finally:
        cluster.shutdown()
    assert st["status"] == "FINISHED"
    got = _counts(port.sinks.JsonLinesFileSink.read_rows(out))
    assert want and got == want
