"""The flight recorder (``observe/``) against the reference's on the CPU:
the recorder's attribution, bounds and aggregates, the Chrome/Perfetto
export, the flight metric group, and the span kinds a Q5 job records at
parallelism 8, which are the reference's less ``xla.compile`` and
``d2h.transfer`` (JAX-only probes the port has no counterpart of).
Tolerance: none (kinds, names and counts compare exactly)."""

import json
import os
import subprocess
import sys
import time

import pytest

from flink_tpu_torch.observe import KNOWN_SPAN_KINDS
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.observe.export import (
    chrome_trace,
    register_flight_metrics,
    validate_trace_schema,
    write_chrome_trace,
)
from flink_tpu_torch.observe.flight_recorder import FlightRecorder

XLA_ONLY = {"xla.compile", "d2h.transfer"}


@pytest.fixture()
def rec():
    r = flight.recorder()
    r.clear()
    return r


def test_kinds_are_the_references_whole():
    from flink_tpu.observe import KNOWN_SPAN_KINDS as J_KINDS

    assert KNOWN_SPAN_KINDS == J_KINDS
    assert XLA_ONLY <= set(KNOWN_SPAN_KINDS)


def test_span_attribution_and_ambient_context(rec):
    flight.set_job("t-job")
    flight.set_batch(7)
    flight.set_watermark(1234)
    with flight.span("batch.ingest", batch=42):
        time.sleep(0.002)
    with flight.span("fire.dispatch"):
        flight.instant("watchdog.miss", shard=3)
    ingest = [r for r in rec.snapshot() if r.kind == "batch.ingest"][-1]
    assert (ingest.job, ingest.batch_id, ingest.instant) == \
        ("t-job", 42, False)
    assert ingest.duration_s >= 0.002
    miss = [r for r in rec.snapshot() if r.kind == "watchdog.miss"][-1]
    assert (miss.job, miss.batch_id, miss.watermark, miss.shard,
            miss.instant) == ("t-job", 7, 1234, 3, True)
    with pytest.raises(KeyError):
        rec.span("no.such.kind")


def test_disabled_region_and_bounded_ring(rec):
    before = len(rec.snapshot())
    with flight.disabled():
        with flight.span("batch.ingest"):
            pass
    assert len(rec.snapshot()) == before
    r = FlightRecorder(KNOWN_SPAN_KINDS)
    cap = r._ring().mask + 1
    for _ in range(cap + 100):
        r.instant("emit")
    assert r.dropped() == 100 and len(r.snapshot()) == cap


def test_chrome_export_and_flight_metrics(rec):
    with flight.span("batch.ingest", job="job-a", batch=1):
        pass
    with flight.span("fire.shard", job="job-b", shard=3):
        pass
    trace = chrome_trace([r for r in rec.snapshot()
                          if r.job in ("job-a", "job-b")], anchor=rec.anchor)
    assert validate_trace_schema(trace, KNOWN_SPAN_KINDS) == []
    evs = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    assert len({e["pid"] for e in evs}) == 2
    assert next(e for e in evs if e["name"] == "fire.shard")["tid"] == 4
    from flink_tpu_torch.metrics import MetricRegistry

    reg = MetricRegistry()
    register_flight_metrics(reg.root_group(), rec)
    snap = reg.snapshot()
    assert snap["flight.batch_ingest_count"] == 1
    assert "flight.xla_compile_count" in snap


def _q5(pkg, job, total=30_000):
    import importlib

    top = importlib.import_module(pkg)
    nx = importlib.import_module(f"{pkg}.benchmarks.nexmark")
    sinks = importlib.import_module(f"{pkg}.connectors.sinks")
    conf = {"parallelism.default": 8, "execution.micro-batch.size": 4096}
    if pkg == "flink_tpu_torch":
        conf["execution.device"] = "cpu"
    env = top.StreamExecutionEnvironment(top.Configuration(conf))
    sink = sinks.CollectSink()
    nx.build_q5(env, nx.BidSource(total_records=total,
                                  num_auctions=500)).sink_to(sink)
    return env.execute(job)


def test_q5_span_kinds_equal_the_references_less_the_xla_probes(
        rec, tmp_path):
    from flink_tpu.observe import flight_recorder as jflight

    jflight.recorder().clear()
    _q5("flink_tpu", "q5-kinds")
    want = {r.kind for r in jflight.recorder().snapshot()
            if r.job == "q5-kinds"}
    _q5("flink_tpu_torch", "q5-kinds")
    records = [r for r in rec.snapshot() if r.job == "q5-kinds"]
    got = {r.kind for r in records}
    assert got == want - XLA_ONLY
    assert {"batch.ingest", "fire.dispatch", "op.process"} <= got
    # the exported Perfetto JSON loads and holds the executor's and the
    # engine's kinds
    path = str(tmp_path / "q5.json")
    assert write_chrome_trace(path, rec) > len(records) > 0
    with open(path) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] != "M"}
    assert {"op.process", "batch.ingest"} <= names
    assert validate_trace_schema(trace, KNOWN_SPAN_KINDS) == []


def test_restore_records_a_checkpoint_restore_span(rec, tmp_path):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    ckpt = tmp_path / "ckpt"
    conf = {"execution.device": "cpu",
            "state.checkpoints.dir": str(ckpt),
            "execution.checkpointing.every-n-source-batches": 1}

    def run(name, **kw):
        env = StreamExecutionEnvironment(Configuration(conf))
        rows = [{"k": i % 3, "v": 1, "ts": i * 100} for i in range(100)]
        env.from_collection(rows, timestamp_field="ts") \
            .key_by("k").window(TumblingEventTimeWindows.of(1000)) \
            .sum("v").sink_to(CollectSink())
        return env.execute(name, **kw)

    first = run("restore-a")
    assert first.traces.spans("checkpoint")
    assert "checkpoint.write" in {r.kind for r in rec.snapshot()}
    rec.clear()
    chk = sorted(p for p in os.listdir(ckpt) if p.startswith("chk-"))[-1]
    second = run("restore-b", restore_from=str(ckpt / chk))
    assert [r for r in rec.snapshot() if r.kind == "checkpoint.restore"]
    assert second.traces.spans("recovery")


def test_sharded_checkpoint_spans(rec, tmp_path):
    import numpy as np

    from flink_tpu_torch.checkpoint.sharded import ShardedCheckpointStorage
    from flink_tpu_torch.metrics.traces import TraceCollector

    tc = TraceCollector()
    storage = ShardedCheckpointStorage(str(tmp_path), traces=tc)
    storage.write_checkpoint(
        1, "job", {(0, 63): {"table": {"key_id": np.arange(3)}},
                   (64, 127): {"table": {"key_id": np.arange(2)}}},
        {(0, 63): 10, (64, 127): 10})
    assert tc.spans("checkpoint")[-1].attributes["units"] == 2
    assert storage.latest_units_for_groups(range(0, 40))[0] == 1
    assert tc.spans("recovery")[-1].attributes["checkpointId"] == 1
    kinds = {r.kind for r in rec.snapshot()}
    assert {"checkpoint.write", "checkpoint.restore"} <= kinds


def test_the_recorder_is_off_under_the_variable():
    """``FLINK_TPU_FLIGHT_RECORDER=0`` is read at import: a job records
    nothing, and its results are the same."""
    code = (
        "from flink_tpu_torch import Configuration, "
        "StreamExecutionEnvironment\n"
        "from flink_tpu_torch.connectors.sinks import CollectSink\n"
        "from flink_tpu_torch.observe import flight_recorder as f\n"
        "from flink_tpu_torch.windowing.assigners import "
        "TumblingEventTimeWindows as T\n"
        "env = StreamExecutionEnvironment(Configuration("
        "{'execution.device': 'cpu', 'parallelism.default': 4}))\n"
        "s = CollectSink()\n"
        "env.from_collection([{'k': i % 3, 'v': 1.0, 'ts': 100 * i} "
        "for i in range(50)], timestamp_field='ts').key_by('k')"
        ".window(T.of(1000)).sum('v').sink_to(s)\n"
        "env.execute('off')\n"
        "print(f.enabled(), len(f.recorder().snapshot()), len(s.rows()))\n")
    env = {**os.environ, "FLINK_TPU_FLIGHT_RECORDER": "0"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "0", "15"]
