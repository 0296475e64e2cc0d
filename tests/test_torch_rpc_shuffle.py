"""The port's RPC shuffle transport (``flink_tpu_torch/cluster/
rpc_shuffle.py``) against the reference's gRPC one: batches and events
between two RPC services, credit backpressure, the local route, and a
stage-parallel job whose keyed subtasks consume through two shuffle
servers — counterparts of every test in ``tests/test_rpc_shuffle.py``,
each run through both packages. Port jobs run with ``execution.device:
cpu``; every wait is bounded."""

import importlib
import threading

import numpy as np
import pytest

PKGS = ("reference", "port")


def _m(pkg, name):
    base = "flink_tpu" if pkg == "reference" else "flink_tpu_torch"
    return importlib.import_module(f"{base}.{name}")


@pytest.fixture(params=PKGS)
def two_services(request):
    rpc = _m(request.param, "cluster.rpc")
    a, b = rpc.RpcService(), rpc.RpcService()
    yield request.param, a, b
    a.stop()
    b.stop()


def test_cross_service_batches_and_events(two_services):
    pkg, rpc_a, rpc_b = two_services
    rs = _m(pkg, "cluster.rpc_shuffle")
    spi = _m(pkg, "runtime.shuffle_spi")
    rb = _m(pkg, "core.records").RecordBatch
    svc_b = rs.RpcShuffleService(rpc_b, route=lambda pid, sub: None)
    svc_a = rs.RpcShuffleService(rpc_a, route=lambda pid, sub: rpc_b.address)
    w = svc_a.create_partition("p", 2)
    gate0 = svc_b.create_gate(["p"], 0)
    gate1 = svc_b.create_gate(["p"], 1)
    w.emit(0, rb.from_pydict({"x": np.arange(3)}))
    w.emit(1, rb.from_pydict({"x": np.arange(5), "y": np.ones(5)}))
    w.broadcast_event(123)
    w.broadcast_event(spi.Barrier(7, savepoint="/sp"))
    w.close()
    assert gate0.poll(timeout=5)[1]["x"].tolist() == [0, 1, 2]
    assert gate0.poll(timeout=5)[1] == 123
    barrier = gate0.poll(timeout=5)[1]
    assert (barrier.checkpoint_id, barrier.savepoint) == (7, "/sp")
    assert gate0.poll(timeout=5)[1] is spi.END_OF_PARTITION
    b1 = gate1.poll(timeout=5)[1]
    assert b1["x"].tolist() == list(range(5))
    assert b1["y"].tolist() == [1.0] * 5
    if pkg == "port":
        assert svc_a.bytes_sent > 0 and svc_b.bytes_sent == 0


def test_backpressure_blocks_remote_producer(two_services):
    pkg, rpc_a, rpc_b = two_services
    rs = _m(pkg, "cluster.rpc_shuffle")
    rb = _m(pkg, "core.records").RecordBatch
    rs.RpcShuffleService(rpc_b, route=lambda pid, sub: None,
                         credits_per_channel=1)
    svc_a = rs.RpcShuffleService(rpc_a, route=lambda pid, sub: rpc_b.address)
    w = svc_a.create_partition("bp", 1)
    b = rb.from_pydict({"x": np.arange(2)})
    w.emit(0, b)  # fills the single credit
    done = threading.Event()

    def second():
        w.emit(0, b)
        done.set()

    threading.Thread(target=second, daemon=True).start()
    assert not done.wait(0.3), "push must block while the queue is full"
    svc_b = rs.RpcShuffleService(rpc_b, route=lambda pid, sub: None)
    gate = svc_b.create_gate(["bp"], 0)
    assert len(gate.poll(timeout=5)[1]) == 2
    assert done.wait(5)


@pytest.mark.parametrize("pkg", PKGS)
def test_local_route_skips_the_socket(pkg):
    rpc = _m(pkg, "cluster.rpc").RpcService()
    rs = _m(pkg, "cluster.rpc_shuffle")
    rb = _m(pkg, "core.records").RecordBatch
    try:
        svc = rs.RpcShuffleService(rpc, route=lambda pid, sub: None)
        w = svc.create_partition("loc", 1)
        gate = svc.create_gate(["loc"], 0)
        w.emit(0, rb.from_pydict({"x": np.arange(4)}))
        assert len(gate.poll(timeout=2)[1]) == 4
        if pkg == "port":
            assert svc.bytes_sent == 0
    finally:
        rpc.stop()


def test_unaligned_barriers_keep_their_flag_over_the_port_socket():
    rpc = _m("port", "cluster.rpc")
    rs = _m("port", "cluster.rpc_shuffle")
    spi = _m("port", "runtime.shuffle_spi")
    a, b = rpc.RpcService(), rpc.RpcService()
    try:
        svc_b = rs.RpcShuffleService(b, route=lambda pid, sub: None)
        svc_a = rs.RpcShuffleService(a, route=lambda pid, sub: b.address)
        w = svc_a.create_partition("u", 1)
        gate = svc_b.create_gate(["u"], 0)
        w.broadcast_event(spi.Barrier(3, unaligned=True))
        got = gate.poll(timeout=5)[1]
        assert got.checkpoint_id == 3 and got.unaligned
    finally:
        a.stop()
        b.stop()


def _split_job(pkg):
    """The reference test's job: keyed subtasks 0..1 consume through
    server A, 2..3 through server B — the data plane crosses real sockets
    mid-job. Returns ({(key, window): sum}, subtask records)."""
    rpc = _m(pkg, "cluster.rpc")
    rs = _m(pkg, "cluster.rpc_shuffle")
    cfg = _m(pkg, "core.config")
    env_mod = _m(pkg, "datastream.environment")
    se = _m(pkg, "cluster.stage_executor")
    rpc_a, rpc_b = rpc.RpcService(), rpc.RpcService()
    try:
        svc_b = rs.RpcShuffleService(rpc_b, route=lambda pid, sub: None)
        svc_a = rs.RpcShuffleService(
            rpc_a, route=lambda pid, sub: None if sub < 2 else rpc_b.address)

        class SplitGateService:
            def create_partition(self, pid, n, credits=2):
                return svc_a.create_partition(pid, n, credits)

            def create_gate(self, pids, sub):
                return (svc_a if sub < 2 else svc_b).create_gate(pids, sub)

            def close(self):
                pass

        conf = {"execution.micro-batch.size": 1000,
                "execution.stage-parallelism": 4,
                "state.slot-table.capacity": 8192}
        if pkg == "port":
            conf["execution.device"] = "cpu"
        env = env_mod.StreamExecutionEnvironment(cfg.Configuration(conf))
        sink = _m(pkg, "connectors.sinks").CollectSink()
        src = _m(pkg, "connectors.sources").DataGenSource(
            total_records=20_000, num_keys=200,
            events_per_second_of_eventtime=10_000, seed=3)
        env.from_source(
            src, _m(pkg, "runtime.watermarks").WatermarkStrategy
            .for_bounded_out_of_orderness(0), name="gen") \
            .key_by("key") \
            .window(_m(pkg, "windowing.assigners")
                    .TumblingEventTimeWindows.of(1000)) \
            .sum("value").sink_to(sink)
        result = se.StageParallelExecutor(
            env.config, shuffle_service=SplitGateService()).run(
            env.get_stream_graph(), "grpc-shuffle-job")
        rows = {(r["key"], r["window_start"]): r["sum_value"]
                for r in sink.result().to_rows()}
        return rows, result.metrics["subtask_records_in"], \
            getattr(svc_a, "bytes_sent", None)
    finally:
        rpc_a.stop()
        rpc_b.stop()


def test_stage_job_spans_two_shuffle_servers():
    from tests.conftest import assert_windows_approx_equal

    ref_rows, ref_in, _ = _split_job("reference")
    rows, subtask_in, sent = _split_job("port")
    assert all(c > 0 for c in subtask_in)
    assert subtask_in == ref_in
    assert sent > 0
    assert set(rows) == set(ref_rows)
    # the local combiner changes float32 summation order (as between the
    # reference's own stage and single-slot runs): held at its tolerance
    assert_windows_approx_equal(rows, ref_rows)


def test_shuffle_service_grpc_from_the_configuration():
    """A reference configuration with ``shuffle.service: grpc`` runs
    unchanged on the port and gives the local service's rows."""
    def run(service):
        cfg = _m("port", "core.config")
        env = _m("port", "datastream.environment").StreamExecutionEnvironment(
            cfg.Configuration({"execution.micro-batch.size": 1000,
                               "execution.stage-parallelism": 2,
                               "execution.local-agg": False,
                               "shuffle.service": service,
                               "execution.device": "cpu"}))
        sink = _m("port", "connectors.sinks").CollectSink()
        env.from_source(
            _m("port", "connectors.sources").DataGenSource(
                total_records=10_000, num_keys=50, seed=5),
            _m("port", "runtime.watermarks").WatermarkStrategy
            .for_bounded_out_of_orderness(0)) \
            .key_by("key").window(_m("port", "windowing.assigners")
                                  .TumblingEventTimeWindows.of(500)) \
            .count().sink_to(sink)
        env.execute("svc")
        return sorted((r["key"], r["window_start"], r["count"])
                      for r in sink.result().to_rows())

    assert run("grpc") == run("local")
