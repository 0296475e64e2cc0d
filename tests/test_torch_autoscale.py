"""The port's autoscaler (``flink_tpu_torch/autoscale/``) against the
reference's (``flink_tpu/autoscale/``) on the CPU: the policy half of
``tests/test_autoscale.py`` driven through both packages with the same
inputs and fake clocks (decisions, reasons, refusal counters and gauges
equal), the controller on fake engines, the controller driving a real
mesh session engine live, and ``autoscale.enabled`` through both
executors (equal rows, equal ``autoscale`` metrics).

Exact comparisons throughout: decisions are pure arithmetic on the same
floats, and the jobs' rows are integer counts.
"""

import pytest

from flink_tpu.autoscale import controller as jcontroller
from flink_tpu.autoscale import policy as jpolicy
from flink_tpu_torch.autoscale import controller as tcontroller
from flink_tpu_torch.autoscale import policy as tpolicy

PKGS = {"port": (tpolicy, tcontroller), "ref": (jpolicy, jcontroller)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _inp(pol, cur=4, rate=1000.0, busy=0.7, backlog=0.0, growth=0.0,
         rows=(), p99=0.0):
    return pol.PolicyInput(current_shards=cur, processing_rate=rate,
                           busy_fraction=busy, backlog=backlog,
                           backlog_growth=growth, shard_resident_rows=rows,
                           fire_latency_p99_ms=p99)


#: (policy kwargs, [(clock advance, input kwargs, mark_rescaled?)]) —
#: the reference suite's scenarios, each a sequence of decisions
SCENARIOS = {
    "no_signal": ({}, [(0, dict(rate=0.0, busy=0.0), False)]),
    "steady": ({}, [(0, dict(cur=4, rate=1000.0, busy=0.7), False)]),
    "scale_up": ({"cooldown_s": 0},
                 [(0, dict(cur=4, rate=1000.0, busy=1.0), False)]),
    "backlog_growth": ({"cooldown_s": 0},
                       [(0, dict(cur=4, rate=1000.0, busy=0.7,
                                 growth=800.0), False)]),
    "backlog_drain": ({"cooldown_s": 0, "backlog_drain_s": 10.0},
                      [(0, dict(cur=4, rate=1000.0, busy=0.7,
                                backlog=20_000.0), False)]),
    "hysteresis": ({"hysteresis": 0.25},
                   [(0, dict(cur=8, rate=1000.0, busy=0.75), False)]),
    "cooldown": ({"cooldown_s": 30.0},
                 [(0, dict(cur=4, rate=1000.0, busy=1.0), True),
                  (10, dict(cur=6, rate=1000.0, busy=1.0), False),
                  (25, dict(cur=6, rate=1000.0, busy=1.0), False)]),
    "scale_down": ({"cooldown_s": 0},
                   [(0, dict(cur=8, rate=1000.0, busy=0.1), False)]),
    "imbalance": ({"cooldown_s": 0, "imbalance_limit": 2.0},
                  [(0, dict(cur=8, rate=1000.0, busy=0.2,
                            rows=(1000,) + (10,) * 7), False),
                   (0, dict(cur=8, rate=1000.0, busy=0.2,
                            rows=(100,) * 8), False)]),
    "bounds": ({"min_shards": 2, "max_shards": 6, "cooldown_s": 0},
               [(0, dict(cur=1), False), (0, dict(cur=9), False),
                (0, dict(cur=4, rate=1000.0, busy=1.0), False)]),
    "fire_latency": ({"cooldown_s": 0, "fire_deadline_ms": 50.0,
                      "fire_breach_ticks": 3},
                     [(1, dict(cur=4, p99=80.0), False),
                      (1, dict(cur=4, p99=80.0), False),
                      (1, dict(cur=4, p99=80.0, busy=0.1), False),
                      (1, dict(cur=6, p99=90.0, busy=0.1), False),
                      (1, dict(cur=6, p99=10.0, busy=0.1), False)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decides_like_the_reference(name):
    kwargs, seq = SCENARIOS[name]
    out = {}
    for pkg, (pol, _ctl) in PKGS.items():
        clk = FakeClock()
        p = pol.ScalingPolicy(clock=clk, **kwargs)
        trace = []
        for adv, ik, mark in seq:
            clk.advance(adv)
            d = p.decide(_inp(pol, **ik))
            trace.append((d.target, d.reason, d.rescale,
                          p.skew_guard_refusals, p.last_imbalance,
                          p.in_cooldown()))
            if mark:
                p.mark_rescaled()
        out[pkg] = trace
    assert out["port"] == out["ref"]


def test_policy_rejects_bad_config_like_the_reference():
    for kwargs in ({"utilization_target": 0.0},
                   {"utilization_target": 1.5},
                   {"min_shards": 4, "max_shards": 2}):
        for pol, _ in PKGS.values():
            with pytest.raises(ValueError):
                pol.ScalingPolicy(**kwargs)
    assert tpolicy.key_imbalance((1000, 10, 10, 10)) == \
        jpolicy.key_imbalance((1000, 10, 10, 10))
    assert tpolicy.key_imbalance(()) == 1.0


class _FakeEngine:
    def __init__(self, shards=2):
        self.P = shards
        self.calls = []

    def reshard(self, n):
        self.calls.append(n)
        old, self.P = self.P, n
        return {"from": old, "to": n, "rows_moved": 123, "seconds": 0.01}


def _controller_trace(pkg, samples, engine_shards, policy_kw):
    from flink_tpu.metrics.core import MetricRegistry as JRegistry
    from flink_tpu_torch.metrics.core import MetricRegistry

    pol, ctl_mod = PKGS[pkg]
    clk = FakeClock()
    eng = _FakeEngine(engine_shards)
    seen = []
    it = iter(samples(ctl_mod))
    ctl = ctl_mod.AutoscaleController(
        pol.ScalingPolicy(clock=clk, **policy_kw),
        sample_fn=lambda: next(it), engine=eng, interval_s=0.0, clock=clk,
        on_imbalance=lambda inp: seen.append(inp.current_shards))
    reg = (MetricRegistry if pkg == "port" else JRegistry)()
    ctl.register_metrics(reg.root_group("job"))
    events = [ctl.tick()]
    clk.advance(10.0)
    events.append(ctl.tick())
    ev = [(e.source, e.target, e.reason, e.mode, e.rows_moved)
          if e is not None else None for e in events]
    snap = {k: v for k, v in reg.snapshot().items()
            if not k.endswith("handoff_ms")}
    return ev, eng.calls, seen, snap


@pytest.mark.parametrize("case", ["scale_up", "skew_refusal"])
def test_controller_ticks_like_the_reference(case):
    if case == "scale_up":
        def samples(c):
            return [c.SignalSample(records_total=0, busy_ms_total=0),
                    c.SignalSample(records_total=10_000,
                                   busy_ms_total=10_000)]
        args = (samples, 2, dict(utilization_target=0.5, hysteresis=0.1,
                                 cooldown_s=0))
    else:
        def samples(c):
            return [c.SignalSample(records_total=0, busy_ms_total=0),
                    c.SignalSample(records_total=10_000,
                                   busy_ms_total=2_000,
                                   shard_resident_rows=(1000,) + (10,) * 7)]
        args = (samples, 8, dict(utilization_target=0.7, hysteresis=0.25,
                                 cooldown_s=0, imbalance_limit=2.0))
    got = _controller_trace("port", *args)
    want = _controller_trace("ref", *args)
    assert got == want
    if case == "scale_up":
        assert got[1] == [4]
    else:
        assert got[2] == [8] and got[3]["job.autoscale.skew_guard_refusals"] \
            == 1


def test_controller_requires_one_mechanism():
    pol, ctl = PKGS["port"]
    with pytest.raises(ValueError):
        ctl.AutoscaleController(pol.ScalingPolicy(), sample_fn=lambda: None)
    with pytest.raises(TypeError):
        ctl.AutoscaleController(pol.ScalingPolicy(), sample_fn=lambda: None,
                                engine=object())


def test_live_rescale_through_controller_equals_the_reference():
    """The controller's bounds convergence drives a REAL mesh session
    engine 4 -> 8 live, mid-stream, in both packages; every fire equal in
    order, bit for bit."""
    from tests.test_torch_skew import _batches, _stream, assert_batches_equal
    from tests.test_torch_skew import session_pair

    j, t = session_pair(max_device_slots=1024)
    ctls = []
    for pkg, eng in (("ref", j), ("port", t)):
        pol, ctl_mod = PKGS[pkg]
        clk = FakeClock()
        ctls.append((clk, ctl_mod.AutoscaleController(
            pol.ScalingPolicy(min_shards=8, max_shards=8, cooldown_s=0,
                              clock=clk),
            sample_fn=ctl_mod.SignalSample, engine=eng, interval_s=0.0,
            clock=clk)))
    for keys, vals, ts, wm in _stream(num_keys=4_000, per_step=1_500,
                                      n_steps=6):
        for clk, ctl in ctls:
            clk.advance(1.0)
            ctl.tick()
        jb, tb = _batches(keys, vals, ts)
        j.process_batch(jb)
        t.process_batch(tb)
        assert_batches_equal(t.on_watermark(wm), j.on_watermark(wm))
    assert_batches_equal(t.on_watermark(1 << 60), j.on_watermark(1 << 60))
    assert t.P == j.P == 8
    assert ctls[1][1].live_handoffs == ctls[0][1].live_handoffs == 1
    assert ctls[1][1].events[0].rows_moved == ctls[0][1].events[0].rows_moved


# ------------------------------------------------------------ executors


def _run_job(pkg, conf_extra, total=30_000):
    import importlib

    top = importlib.import_module("flink_tpu" if pkg == "ref"
                                  else "flink_tpu_torch")
    sinks = importlib.import_module(f"{top.__name__}.connectors.sinks")
    sources = importlib.import_module(f"{top.__name__}.connectors.sources")
    wms = importlib.import_module(f"{top.__name__}.runtime.watermarks")
    asg = importlib.import_module(f"{top.__name__}.windowing.assigners")
    conf = {"execution.micro-batch.size": 1024, "parallelism.default": 2,
            **conf_extra}
    if pkg == "port":
        conf["execution.device"] = "cpu"
    env = top.StreamExecutionEnvironment(top.Configuration(conf))
    sink = sinks.CollectSink()
    (env.add_source(
        sources.DataGenSource(total_records=total, num_keys=40,
                              events_per_second_of_eventtime=20_000),
        wms.WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by("key").window(asg.TumblingEventTimeWindows.of(1000))
     .count().sink_to(sink))
    result = env.execute("autoscale-job")
    return {(int(r["key"]), int(r["window_start"])): int(r["count"])
            for r in sink.rows()}, result


AUTO = {"autoscale.enabled": True, "autoscale.interval-ms": 0,
        "autoscale.cooldown-ms": 0, "autoscale.min-shards": 4,
        "autoscale.max-shards": 4}


def test_enabled_autoscale_converges_like_the_reference():
    """Parallelism 2 with min-shards pinned to 4: the first policy tick
    live-rescales 2 -> 4 in both executors; rows equal the reference's
    and the baseline, and the ``autoscale`` metrics' counts and path are
    the reference's (handoff times are measured, so only their count is
    compared)."""
    baseline, _ = _run_job("port", {})
    got, res = _run_job("port", AUTO)
    want, jres = _run_job("ref", AUTO)
    assert len(baseline) > 0 and got == want == baseline
    a, ja = res.metrics["autoscale"], jres.metrics["autoscale"]
    assert a["path"] == ja["path"] and a["path"][0] == (2, 4)
    assert a["rescales"] == ja["rescales"]
    assert a["live_handoffs"] == ja["live_handoffs"] >= 1
    assert len(a["handoff_ms"]) == len(ja["handoff_ms"])
    snap = res.registry.snapshot()
    key = next(k for k in snap if k.endswith("autoscale.live_handoffs"))
    assert snap[key] == a["live_handoffs"]


def test_disabled_autoscale_adds_no_metrics():
    _, res = _run_job("port", {}, total=5_000)
    assert "autoscale" not in res.metrics


def test_ceiling_is_logical_not_the_card_count():
    """``autoscale.max-shards`` far past any card count: the port's
    ceiling is logical, bounded by max_parallelism (128), so the policy
    goes to 64 shards (the reference clamps to its 8 virtual devices —
    the one place the packages differ by design); unset, the stated
    default 8 applies, as the reference's device count gives. Rows equal
    the baseline either way."""
    baseline, _ = _run_job("port", {}, total=10_000)
    wide = dict(AUTO, **{"autoscale.min-shards": 64,
                         "autoscale.max-shards": 64})
    got, res = _run_job("port", wide, total=10_000)
    assert res.metrics["autoscale"]["path"][0] == (2, 64)
    assert got == baseline
    dflt = dict(AUTO, **{"autoscale.min-shards": 64,
                         "autoscale.max-shards": 0})
    got, res = _run_job("port", dflt, total=10_000)
    want, jres = _run_job("ref", dflt, total=10_000)
    assert res.metrics["autoscale"]["path"][0] == \
        jres.metrics["autoscale"]["path"][0] == (2, 8)
    assert got == want == baseline
    from flink_tpu_torch.parallel import mesh

    class E:
        P, max_parallelism, key_group_range = 2, 128, (10, 13)

    assert mesh.logical_shard_ceiling(E()) == 4
    assert mesh.logical_shard_ceiling(E(), 3) == 3
    E.key_group_range = None
    assert mesh.logical_shard_ceiling(E()) == mesh.DEFAULT_MAX_LOGICAL_SHARDS
