"""The metric tree (``metrics/``) and its wiring into the executor
against the reference's on the CPU: the types, groups, Prometheus
reporter (bound to port 0) and trace collector, the flame-graph sampler,
and a Q5 job's ``result.registry`` at parallelism 8, whose metric names
are the reference's but for two documented differences. Tolerance: none
(names and counts compare exactly)."""

import threading
import time
import urllib.request

import pytest

from flink_tpu_torch.metrics import (
    Counter,
    Histogram,
    Meter,
    MetricRegistry,
    PrometheusReporter,
    TraceCollector,
)


def test_types_and_groups_like_the_reference():
    from flink_tpu import metrics as jm

    out = []
    for m in (jm, __import__("flink_tpu_torch.metrics", fromlist=["x"])):
        c = m.Counter()
        c.inc()
        c.inc(5)
        c.dec()
        h = m.Histogram()
        for v in range(100):
            h.update(float(v))
        meter = m.Meter()
        for _ in range(10):
            meter.mark(100)
        reg = m.MetricRegistry()
        op = reg.root_group("job", "test").add_group("window_agg#3")
        op.counter("numRecordsIn").inc(42)
        op.gauge("currentWatermark", lambda: 123)
        reg.root_group("job", "b").counter("y").inc()
        reg.unregister_scope_prefix(("job", "b"))
        out.append((c.count, h.snapshot(), meter.count, reg.snapshot()))
    assert out[0] == out[1]
    assert out[1][0] == 5 and out[1][2] == 1000
    assert out[1][3] == {"job.test.window_agg#3.numRecordsIn": 42,
                         "job.test.window_agg#3.currentWatermark": 123}
    assert isinstance(Counter(), Counter) and Histogram and Meter


def test_prometheus_text_equals_the_references_and_serves_on_port_0():
    from flink_tpu import metrics as jm

    texts = []
    for m in (jm, __import__("flink_tpu_torch.metrics", fromlist=["x"])):
        reg = m.MetricRegistry()
        g = reg.root_group("job", "nexmark", "q5")
        g.counter("numRecordsIn").inc(7)
        h = g.histogram("fireLatency")
        h.update(1.0)
        h.update(2.0)
        rep = m.PrometheusReporter()
        rep.open(reg)
        texts.append(rep.render())
    assert texts[0] == texts[1]
    assert 'quantile="0.99"' in texts[1]
    reg = MetricRegistry()
    reg.root_group("job", "x").counter("served").inc(3)
    rep = PrometheusReporter(port=0)
    rep.open(reg)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{rep.port}/metrics", timeout=5).read()
        assert b"served" in body
    finally:
        rep.close()


def test_trace_spans():
    tc = TraceCollector()
    with tc.span("checkpoint", "checkpoint-1") as sp:
        sp.set_attribute("checkpointId", 1)
    spans = tc.spans("checkpoint")
    assert len(spans) == 1 and spans[0].attributes["checkpointId"] == 1
    assert spans[0].duration_ms >= 0


def test_flamegraph_samples_a_busy_thread():
    from flink_tpu_torch.metrics.flamegraph import sample_flame_graph

    stop = threading.Event()

    def busy_loop_for_the_sampler():
        while not stop.is_set():
            sum(range(1000))

    t = threading.Thread(target=busy_loop_for_the_sampler,
                         name="task-busy", daemon=True)
    t.start()
    try:
        graph = sample_flame_graph(duration_ms=100, interval_ms=5,
                                   thread_name_prefixes=["task-"])
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()
    assert graph["samples"] > 0
    (thread,) = graph["root"]["children"]
    assert thread["name"] == "task-busy"

    def names(node):
        yield node["name"]
        for c in node["children"]:
            yield from names(c)

    assert any(n.startswith("busy_loop_for_the_sampler")
               for n in names(thread))


def _q5(pkg, total=30_000):
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
    return env.execute("q5"), sink


def test_q5_registry_names_equal_the_references():
    """P=8 Q5: every metric name of the reference's tree, less the
    ``state.key_imbalance`` gauge (ROADMAP item 12g), plus the window
    operator's ``numLateRecordsDropped`` (the port's window operator
    exposes its engine's late-record count; the reference's registers the
    gauge only for operators that have the attribute, and its window
    operator has none)."""
    import re

    def names(result):
        # an operator's scope carries its transformation's uid, a
        # process-wide counter: compare the names without it
        return {re.sub(r"#\d+", "#", k) for k in result.registry.snapshot()}

    ref, _ = _q5("flink_tpu")
    port, sink = _q5("flink_tpu_torch")
    want, got = names(ref), names(port)
    win = next(k.rsplit(".state.", 1)[0] for k in want
               if k.endswith(".state.key_imbalance"))
    assert got == (want - {f"{win}.state.key_imbalance"}) | {
        f"{win}.numLateRecordsDropped"}
    snap = {re.sub(r"#\d+", "#", k): v
            for k, v in port.registry.snapshot().items()}
    assert snap[f"{win}.window.fireCount"] == len(sink.rows()) > 0
    assert snap[f"{win}.numLateRecordsDropped"] == 0
    assert snap[f"{win}.numRecordsIn"] == 30_000
    assert snap["flight.op_process_count"] > 0


def test_late_records_count_on_the_tree():
    """Late records dropped by the mesh engine are the gauge's, and the
    reference's engine count on the same stream."""
    import numpy as np

    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    rows = [{"k": i % 5, "v": 1.0, "ts": 100 * i} for i in range(60)]
    rows += [{"k": 1, "v": 1.0, "ts": 5}] * 4  # behind the watermark
    env = StreamExecutionEnvironment(Configuration({
        "execution.device": "cpu", "parallelism.default": 4,
        "execution.micro-batch.size": 16}))
    sink = CollectSink()
    env.from_collection(rows, timestamp_field="ts",
                        watermark_strategy=WatermarkStrategy
                        .for_bounded_out_of_orderness(0)) \
        .key_by("k").window(TumblingEventTimeWindows.of(1000)) \
        .sum("v").sink_to(sink)
    res = env.execute("late")
    snap = res.registry.snapshot()
    (late,) = [v for k, v in snap.items()
               if k.endswith("numLateRecordsDropped")]
    assert late == 4
    assert float(np.sum([r["sum_v"] for r in sink.rows()])) == 60.0


@pytest.mark.parametrize("kind", ["watchdog", "chaos"])
def test_job_groups_register_when_armed(kind):
    """``watchdog.enabled`` and an armed chaos plan put their groups on
    the job's tree (they raised for want of it before ROADMAP 12a)."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.chaos import injection as chaos
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    conf = {"execution.device": "cpu", "parallelism.default": 2}
    if kind == "watchdog":
        conf["watchdog.enabled"] = True
    env = StreamExecutionEnvironment(Configuration(conf))
    sink = CollectSink()
    rows = [{"k": i % 3, "v": 1.0, "ts": 100 * i} for i in range(50)]
    env.from_collection(rows, timestamp_field="ts") \
        .key_by("k").window(TumblingEventTimeWindows.of(1000)) \
        .sum("v").sink_to(sink)
    if kind == "chaos":
        plan = chaos.FaultPlan.from_spec([{"pattern": "never.hit",
                                           "nth": 1}])
        with chaos.chaos_active(plan, 0):
            res = env.execute("armed")
    else:
        res = env.execute("armed")
    names = [k for k in res.registry.snapshot()
             if k.startswith(f"job.armed.{kind}.")]
    assert names, kind
