"""The flight recorder (``observe/``) against the reference's on the CPU:
the recorder's attribution, bounds and aggregates, the Chrome/Perfetto
export, the flight metric group, and the span kinds a Q5 job records at
parallelism 8: the reference's, less ``emit`` (read by nothing) and
``xla.compile`` and ``d2h.transfer`` (JAX-only probes the port has no
counterpart of), plus the port's ingest and fire splits, the task loop's
source wait and the two wait records. Then the port's own spans on that
job: where they nest, their operators, watermarks and CPU seconds.
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

#: the reference's kinds the port does not have
REMOVED = {"emit", "xla.compile", "d2h.transfer"}
#: the port's kinds the reference does not have
ADDED = {"prep.route", "prep.slots", "source.wait", "source.queue",
         "fire.pending"}
#: kinds the port records on Q5 at P=8 that the reference's run does not
#: (the flat path's staging and the fire's per-shard resolve included)
Q5_ADDED = ADDED | {"prep.stage", "fire.shard"}


@pytest.fixture()
def rec():
    r = flight.recorder()
    r.clear()
    return r


def test_kinds_are_the_references_whole():
    from flink_tpu.observe import KNOWN_SPAN_KINDS as J_KINDS

    assert len(set(KNOWN_SPAN_KINDS)) == len(KNOWN_SPAN_KINDS)
    assert set(KNOWN_SPAN_KINDS) == (set(J_KINDS) - REMOVED) | ADDED
    assert REMOVED <= set(J_KINDS) and not ADDED & set(J_KINDS)
    # the kinds both have keep the reference's order
    assert [k for k in KNOWN_SPAN_KINDS if k not in ADDED] == \
        [k for k in J_KINDS if k not in REMOVED]


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
        r.instant("watchdog.miss")
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
    assert {"flight.source_queue_p99_ms", "flight.fire_pending_p50_ms",
            "flight.prep_slots_total_s"} <= set(snap)
    assert not {k for k in snap if k.startswith(
        ("flight.emit_", "flight.xla_compile_", "flight.d2h_transfer_"))}


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
    """The kinds the port records on Q5 are the reference's less the
    removed kinds, plus the ones the port adds."""
    from flink_tpu.observe import flight_recorder as jflight

    jflight.recorder().clear()
    _q5("flink_tpu", "q5-kinds")
    want = {r.kind for r in jflight.recorder().snapshot()
            if r.job == "q5-kinds"}
    _q5("flink_tpu_torch", "q5-kinds")
    records = [r for r in rec.snapshot() if r.job == "q5-kinds"]
    got = {r.kind for r in records}
    assert "emit" in want and not Q5_ADDED & want
    assert got == (want - REMOVED) | Q5_ADDED
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


@pytest.fixture(scope="module")
def q5_records():
    """The port's Q5 at P=8 on the CPU over 15 s of event time (fires at
    several watermarks before the end of input), and its records."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    flight.recorder().clear()
    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8, "execution.micro-batch.size": 4096,
        "execution.device": "cpu"}))
    sink = CollectSink()
    build_q5(env, BidSource(total_records=30_000, num_auctions=500,
                            events_per_second_of_eventtime=2_000)
             ).sink_to(sink)
    env.execute("q5-spans")
    assert sink.rows()
    return [r for r in flight.recorder().snapshot() if r.job == "q5-spans"]


def test_q5_ingest_and_fire_children_nest_in_their_parents(q5_records):
    recs = q5_records
    kinds = {r.kind for r in recs}
    assert {"prep.route", "prep.slots", "prep.stage", "fire.shard",
            "source.queue", "source.wait"} <= kinds
    assert {r.shard for r in recs if r.kind == "prep.slots"} == \
        set(range(8))
    assert {r.shard for r in recs if r.kind == "fire.shard"} == \
        set(range(8))
    ingests = {r.batch_id: r for r in recs if r.kind == "batch.ingest"}
    children = [r for r in recs
                if r.kind in ("prep.route", "prep.slots", "prep.stage")]
    assert len(ingests) > 1 and children
    for c in children:
        parent = ingests[c.batch_id]
        assert parent.thread == c.thread
        assert parent.t0 <= c.t0 <= c.t1 <= parent.t1, (c, parent)
    # one route and one staging span per batch, a slot span per shard
    # with records
    for kind in ("prep.route", "prep.stage"):
        assert sorted(r.batch_id for r in recs if r.kind == kind) == \
            sorted(ingests)
    fires = [r for r in recs if r.kind == "fire.dispatch"]
    for c in (r for r in recs if r.kind == "fire.shard"):
        assert any(f.t0 <= c.t0 <= c.t1 <= f.t1
                   and f.watermark == c.watermark for f in fires), c


def test_q5_pending_fires_carry_their_own_watermark(q5_records):
    recs = q5_records
    fires = [r for r in recs if r.kind == "fire.dispatch"]
    pending = [r for r in recs if r.kind == "fire.pending"]
    harvests = [r for r in recs if r.kind == "fire.harvest"]
    assert len({r.watermark for r in pending}) > 1
    assert len(pending) == len(harvests)
    for p in pending:
        # dispatched inside the fire of its watermark, harvested after
        (f,) = [f for f in fires if f.t0 <= p.t0 <= f.t1]
        assert p.watermark == f.watermark and p.t1 >= p.t0
        (h,) = [h for h in harvests
                if h.t0 >= p.t1 and h.watermark == p.watermark
                and h.t0 - p.t1 < 1.0 and h.thread == p.thread
                and not [q for q in pending
                         if q is not p and p.t1 < q.t1 <= h.t0]]
        assert h.t1 >= h.t0


def test_pending_fire_harvest_after_a_later_fire_keeps_its_watermark(rec):
    """The ambient watermark at a harvest is the newest fire's; the
    harvest's records carry the fire's own."""
    import torch

    from flink_tpu_torch.runtime.pending import PendingFire

    with flight.fire_span(1_000):
        first = PendingFire([torch.arange(3)], lambda host: host[0])
    with flight.fire_span(2_000):
        second = PendingFire([torch.arange(2)], lambda host: host[0])
    assert first.harvest().tolist() == [0, 1, 2]
    assert second.harvest().tolist() == [0, 1]
    recs = rec.snapshot()
    # in start order: both dispatches, then both harvests
    assert [(r.kind, r.watermark) for r in recs
            if r.kind in ("fire.pending", "fire.harvest")] == [
        ("fire.pending", 1_000), ("fire.pending", 2_000),
        ("fire.harvest", 1_000), ("fire.harvest", 2_000)]
    (wait,) = [r for r in recs if r.kind == "fire.pending"
               and r.watermark == 1_000]
    # from the dispatch to the harvest, across the second fire
    disp = [r for r in recs if r.kind == "fire.dispatch"]
    assert wait.t0 < disp[1].t0 < wait.t1


def test_q5_operator_spans_name_their_operator(q5_records):
    ops = {}
    for r in q5_records:
        if r.kind in ("op.process", "op.watermark"):
            assert r.op is not None and "#" in r.op
            ops.setdefault(r.op.split("#")[0], set()).add(r.op)
    assert {"window_agg(CountAggregate)", "hot_items_argmax", "sink"} <= \
        set(ops)
    assert all(len(v) == 1 for v in ops.values())
    assert len({next(iter(v)) for v in ops.values()}) == len(ops)
    # no other record carries an operator
    assert not [r for r in q5_records
                if r.op is not None
                and r.kind not in ("op.process", "op.watermark")]


def test_q5_span_cpu_seconds_within_their_wall(q5_records):
    from flink_tpu_torch.observe import CPU_TIMED_KINDS

    assert CPU_TIMED_KINDS == {"batch.ingest"}
    read = [r for r in q5_records if r.cpu_s is not None and not r.instant]
    assert read and all(0.0 <= r.cpu_s <= r.duration_s for r in read)
    assert {r.kind for r in read} == {"batch.ingest"}
    assert sum(r.cpu_s for r in read) > 0
    # the other kinds do not read the thread CPU clock; instants and
    # waits spent none
    assert all(r.cpu_s is None for r in q5_records
               if not r.instant and r.kind not in CPU_TIMED_KINDS)
    assert all(r.cpu_s == 0.0 for r in q5_records if r.instant)


def test_cpu_seconds_split_work_from_waiting(rec, monkeypatch):
    monkeypatch.setattr(flight, "CPU_EVERY_S", 0.0)
    with flight.span("batch.ingest"):
        c = time.thread_time()
        while time.thread_time() - c < 0.02:
            pass
    with flight.span("batch.ingest"):
        time.sleep(0.02)
    with flight.span("op.process"):
        time.sleep(0.001)
    # a thread reads its CPU clock for one span a period
    monkeypatch.setattr(flight, "CPU_EVERY_S", 3600.0)
    for _ in range(2):
        with flight.span("batch.ingest"):
            pass
    busy, asleep, untimed, read, unread = [
        r for r in rec.snapshot() if r.kind in ("batch.ingest", "op.process")]
    rec.clear()
    assert 0.02 <= busy.cpu_s <= busy.duration_s
    assert asleep.cpu_s < 0.005 and asleep.duration_s >= 0.02
    assert untimed.cpu_s is None and untimed.duration_s >= 0.001
    assert read.cpu_s is not None and unread.cpu_s is None
    # a private recorder reads the CPU clock for the kinds it is given
    r = FlightRecorder(KNOWN_SPAN_KINDS, {"op.process"})
    with r.span("op.process"):
        c = time.thread_time()
        while time.thread_time() - c < 0.01:
            pass
    with r.span("batch.ingest"):
        pass
    timed, other = r.snapshot()
    assert timed.cpu_s >= 0.01 and other.cpu_s is None


def test_wait_records_read_as_instants_and_aggregate_as_spans(rec):
    put = flight.clock()
    time.sleep(0.003)
    flight.waited("source.queue", put, batch=5)
    flight.waited("fire.pending", put, put + 0.5, watermark=77)
    waits = [r for r in rec.snapshot() if r.waited]
    assert [(r.kind, r.instant, r.cpu_s) for r in waits] == [
        ("source.queue", True, 0.0), ("fire.pending", True, 0.0)]
    queue_wait, pending = waits
    assert queue_wait.t0 == put and queue_wait.duration_s >= 0.003
    assert queue_wait.batch_id == 5 and pending.watermark == 77
    assert pending.duration_s == pytest.approx(0.5)
    totals = rec.kind_totals()
    assert totals["fire.pending"]["count"] == 1
    assert totals["fire.pending"]["total_s"] == pytest.approx(0.5)
    assert totals["fire.pending"]["p99_ms"] == pytest.approx(500, rel=1e-6)
    # an instant still aggregates its count only
    flight.instant("watchdog.miss")
    assert rec.kind_totals()["watchdog.miss"]["total_s"] == 0.0
    # the export draws a wait as a duration on a track of its kind
    trace = chrome_trace(rec.snapshot(), anchor=rec.anchor)
    assert validate_trace_schema(trace, KNOWN_SPAN_KINDS) == []
    waits = [e for e in trace["traceEvents"] if e.get("name") ==
             "fire.pending" and e["ph"] != "M"]
    assert [e["ph"] for e in waits] == ["X"]
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["tid"] == waits[0]["tid"]}
    assert names == {"wait:fire.pending"}


def test_q5_source_queue_waits_follow_the_pump(q5_records):
    """Every batch the loop took waited in the pump's queue from a put
    stamped on the recorder's clock to the take: the wait ends before the
    batch's operator work starts."""
    waits = [r for r in q5_records if r.kind == "source.queue"]
    ingests = sorted((r for r in q5_records if r.kind == "batch.ingest"),
                     key=lambda r: r.t0)
    # the batches and the end-of-input entry
    assert len(waits) == len(ingests) + 1
    assert all(r.waited and r.instant and r.t1 >= r.t0 for r in waits)
    for w, ing in zip(waits, ingests):
        assert w.t1 <= ing.t0
