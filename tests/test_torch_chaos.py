"""The port's chaos engine (``flink_tpu_torch/chaos``) against the
reference's, on the CPU.

- The injection core (``tests/test_chaos.py``'s injection tests): nth,
  every, ``where``, the seeded ``prob`` schedule, recoverable retries and
  their budget, rule validation — each run through both packages with the
  same ``(plan, seed)``, which must select the same hits.
- The fault points at their reference sites: the device exchange's drop
  and duplicate payloads (``stage_device_exchange``), its post-dispatch
  raise, the window fire, the pending-fire harvest and ``task.batch``.
- The crash-restore-verify harness: ``tools/chaos_smoke.py``'s ``main``
  scenario (the mesh session engine under forced paged eviction: a fence
  crash, a broken page reload, a post-dispatch exchange crash and a torn
  checkpoint) and ``tests/test_chaos.py``'s device-mode crash-restore and
  its negative control. The port's report ``signature()`` and its
  committed output equal the reference's run of the same
  ``(plan, seed, steps)``, every committed value bit for bit.

Inputs come from numpy seeds. Tolerance: none.
"""

import numpy as np
import pytest

from flink_tpu.chaos import KNOWN_FAULT_POINTS as J_POINTS
from flink_tpu.chaos import harness as jharness
from flink_tpu.chaos import injection as jchaos
from flink_tpu.parallel.shuffle import (
    stage_device_exchange as jstage,
)
from flink_tpu_torch.chaos import KNOWN_FAULT_POINTS as T_POINTS
from flink_tpu_torch.chaos import harness as tharness
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.parallel.shuffle import (
    stage_device_exchange as tstage,
)

PKGS = {"ref": jchaos, "port": tchaos}
GAP = 100


def test_fault_point_inventory_is_the_reference_tuple():
    assert T_POINTS == J_POINTS


# ------------------------------------------------------------- injection

def _run_core(mod, case):
    """One injection scenario on package ``mod``; returns what it
    observed (compared across the packages)."""
    F, R = mod.FaultPlan, mod.FaultRule
    if case == "nth":
        with mod.chaos_active(F(rules=[R(pattern="a.b", nth=3)]), 0) as c:
            raised = []
            for _ in range(4):
                try:
                    mod.fault_point("a.b")
                    raised.append(False)
                except mod.InjectedFault:
                    raised.append(True)
            return raised, dict(c.faults_injected), dict(c.points_hit)
    if case == "every":
        plan = F(rules=[R(pattern="p.*", every=2, kind="delay",
                          delay_ms=0, max_injections=0)])
        with mod.chaos_active(plan, 0) as c:
            for _ in range(6):
                mod.fault_point("p.q")
            return dict(c.faults_injected)
    if case == "where":
        plan = F(rules=[R(pattern="shuffle.device_exchange", nth=1,
                          where={"shard": 2})])
        with mod.chaos_active(plan, 0) as c:
            out = []
            for shard in range(4):
                try:
                    mod.fault_point("shuffle.device_exchange", shard=shard)
                    out.append(False)
                except mod.InjectedFault:
                    out.append(True)
            return out, dict(c.faults_injected)
    if case.startswith("prob"):
        seed = int(case[4:])
        plan = F(rules=[R(pattern="r.*", prob=0.3, kind="delay",
                          delay_ms=0, max_injections=0),
                        R(pattern="r.s", prob=0.5, kind="drop",
                          max_injections=0)])
        hits = []
        with mod.chaos_active(plan, seed) as c:
            for i in range(200):
                rule = mod.payload_action("r.s")
                hits.append(None if rule is None else rule.kind)
            return hits, dict(c.faults_injected)
    if case == "recover":
        plan = F(rules=[R(pattern="io.read", nth=1, recoverable=True)])
        with mod.chaos_active(plan, 0) as c:
            calls = []

            def attempt():
                calls.append(1)
                mod.fault_point("io.read")
                return "ok"

            return (mod.run_recoverable("io.read", attempt), len(calls),
                    c.retries, c.recoveries)
    if case == "budget":
        plan = F(rules=[R(pattern="io.read", every=1, recoverable=True,
                          max_injections=0)], retry_max_attempts=3)
        with mod.chaos_active(plan, 0) as c:
            with pytest.raises(mod.InjectedFault):
                mod.run_recoverable("io.read",
                                    lambda: mod.fault_point("io.read"))
            return c.retries, c.recoveries
    if case == "global_budget":
        plan = F(rules=[R(pattern="io.*", every=1, recoverable=True,
                          max_injections=0)], retry_max_attempts=10,
                 retry_budget_total=3)
        with mod.chaos_active(plan, 0) as c:
            with pytest.raises(mod.RetryBudgetExhaustedError):
                mod.run_recoverable("io.read",
                                    lambda: mod.fault_point("io.read"))
            return c.counters()
    if case == "nonrecoverable":
        plan = F(rules=[R(pattern="io.read", nth=1)])
        with mod.chaos_active(plan, 0) as c:
            with pytest.raises(mod.InjectedFault):
                mod.run_recoverable("io.read",
                                    lambda: mod.fault_point("io.read"))
            return c.retries
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "nth", "every", "where", "prob42", "prob43", "recover", "budget",
    "global_budget", "nonrecoverable"])
def test_injection_core_matches_reference(case):
    got = _run_core(tchaos, case)
    assert got == _run_core(jchaos, case)
    assert not tchaos.armed()
    if case == "prob42":
        hits = sum(h is not None for h in got[0])
        assert 20 < hits < 180


@pytest.mark.parametrize("pkg", list(PKGS))
def test_disarmed_is_noop_and_validation(pkg):
    mod = PKGS[pkg]
    assert not mod.armed()
    mod.fault_point("anything.at.all", shard=3)
    assert mod.payload_action("anything.at.all") is None
    assert mod.run_recoverable("x", lambda: 41) == 41
    with pytest.raises(ValueError, match="no schedule"):
        mod.FaultRule(pattern="task.batch")
    with pytest.raises(ValueError, match="unknown fault kind"):
        mod.FaultRule(pattern="task.batch", nth=1, kind="explode")
    plan = mod.FaultPlan(rules=[mod.FaultRule(pattern="task.batch", nth=1)])
    with mod.chaos_active(plan, seed=0):
        with pytest.raises(RuntimeError, match="already armed"):
            mod.arm(plan, 0)
    assert not mod.armed()
    spec = mod.FaultPlan.from_spec([{"pattern": "a.*", "nth": 2},
                                    {"pattern": "b", "prob": 0.5,
                                     "kind": "delay"}])
    assert spec.describe() == jchaos.FaultPlan.from_spec(
        [{"pattern": "a.*", "nth": 2},
         {"pattern": "b", "prob": 0.5, "kind": "delay"}]).describe()


def test_chaos_metrics_name_their_item():
    """``register_chaos_metrics`` (ROADMAP item 12a, once raising naming
    it): a no-op when disarmed, and under an armed plan the reference's
    gauges under ``<scope>.chaos``, reading the controller live."""
    from flink_tpu_torch.metrics import MetricRegistry

    reg = MetricRegistry()
    tchaos.register_chaos_metrics(reg.root_group("job", "j"))
    assert reg.snapshot() == {}
    plan = tchaos.FaultPlan.from_spec([{"pattern": "a", "nth": 2}])
    with tchaos.chaos_active(plan, 0):
        tchaos.register_chaos_metrics(reg.root_group("job", "j"))
        for _ in range(3):
            try:
                tchaos.fault_point("a")
            except tchaos.InjectedFault:
                pass
        snap = reg.snapshot()
    assert sorted(snap) == sorted(
        f"job.j.chaos.{n}" for n in (
            "faults_injected", "retries", "recoveries", "points_hit",
            "retry_budget_exhausted"))
    assert snap["job.j.chaos.faults_injected"] == 1
    assert snap["job.j.chaos.points_hit"] == 3


# ------------------------------------------------------- the fault sites

def _flat(n=64, shards=4):
    rng = np.random.default_rng(5)
    shard_of = rng.integers(0, shards, n)
    cols = [rng.integers(1, 100, n).astype(np.int32),
            rng.random(n).astype(np.float32)]
    return shard_of, cols


@pytest.mark.parametrize("kind,shard", [("drop", 2), ("duplicate", 1)])
def test_device_exchange_payload_matches_reference(kind, shard):
    """drop routes one shard's lanes to the padding destination, duplicate
    replays its records — the same staged columns as the reference."""
    shard_of, cols = _flat()
    outs = []
    for mod, stage in ((jchaos, jstage), (tchaos, tstage)):
        plan = mod.FaultPlan(rules=[mod.FaultRule(
            pattern="shuffle.device_exchange", nth=1, kind=kind,
            where={"shard": shard})])
        with mod.chaos_active(plan, seed=0) as c:
            dst, staged, width = stage(shard_of, 4, cols, fills=[0, 0.0])
            outs.append((dst, staged, width, dict(c.faults_injected)))
    (jd, js, jw, jf), (td, ts, tw, tf) = outs
    np.testing.assert_array_equal(td, jd)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)
    assert tw == jw and tf == jf == {"shuffle.device_exchange": 1}
    n = len(shard_of)
    if kind == "drop":
        assert ((td[:n] == 4) == (shard_of == shard)).all()
    else:
        assert (td[n:n + int((shard_of == shard).sum())] == shard).all()


def _mesh_engine(mod_pkg, eight_device_mesh, dispatch_ahead=2):
    if mod_pkg == "ref":
        from flink_tpu.parallel.sharded_sessions import MeshSessionEngine
        from flink_tpu.windowing.aggregates import SumAggregate

        mesh = eight_device_mesh
    else:
        from flink_tpu_torch.parallel.mesh import make_mesh
        from flink_tpu_torch.parallel.sharded_sessions import (
            MeshSessionEngine,
        )
        from flink_tpu_torch.windowing.aggregates import SumAggregate

        mesh = make_mesh(8, "cpu")
    return lambda: MeshSessionEngine(
        GAP, SumAggregate("v"), mesh, capacity_per_shard=1 << 14,
        max_device_slots=1024, max_dispatch_ahead=dispatch_ahead)


def _oracle(mod_pkg):
    if mod_pkg == "ref":
        from flink_tpu.windowing.aggregates import SumAggregate
        from flink_tpu.windowing.sessions import SessionWindower

        return lambda: SessionWindower(GAP, SumAggregate("v"),
                                       capacity=1 << 15)
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.sessions import SessionWindower

    return lambda: SessionWindower(GAP, SumAggregate("v"),
                                   capacity=1 << 15,
                                   spill={"device": "cpu"})


def test_exchange_raise_fires_after_the_fused_dispatch(eight_device_mesh):
    """The post-dispatch site: process_batch raises with the exchange and
    scatter already dispatched, in both packages, on the same hit."""
    for pkg, harness in (("ref", jharness), ("port", tharness)):
        mod = PKGS[pkg]
        eng = _mesh_engine(pkg, eight_device_mesh)()
        plan = mod.FaultPlan(rules=[
            mod.FaultRule(pattern="shuffle.device_exchange", nth=2)])
        with mod.chaos_active(plan, seed=0) as c:
            eng.process_batch(harness._keyed_batch([1, 2], [1.0, 2.0],
                                                   [0, 10]))
            with pytest.raises(mod.InjectedFault):
                eng.process_batch(harness._keyed_batch(
                    [1, 2, 3], [1.0, 2.0, 3.0], [0, 10, 20]))
            assert c.faults_injected == {"shuffle.device_exchange": 1}
            assert c.points_hit["mesh.dispatch_fence"] == 1


def test_window_fire_and_harvest_points():
    """``mesh.window_fire`` fires per window fired, ``harvest.pending_fire``
    per harvested fire, as in the reference."""
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    eng = MeshWindowEngine(TumblingEventTimeWindows.of(100),
                           SumAggregate("v"), make_mesh(8, "cpu"))
    plan = tchaos.FaultPlan(rules=[
        tchaos.FaultRule(pattern="mesh.window_fire", nth=2),
        tchaos.FaultRule(pattern="harvest.pending_fire", nth=1,
                         kind="delay", delay_ms=0)])
    keys = np.arange(50, dtype=np.int64)
    with tchaos.chaos_active(plan, seed=0) as c:
        eng.process_batch(tharness._keyed_batch(
            keys, np.ones(50, np.float32), np.arange(50) * 5))
        fired = eng.on_watermark(99, async_ok=True)
        fired[0].harvest()
        with pytest.raises(tchaos.InjectedFault):
            eng.on_watermark(199)
        assert c.faults_injected == {"mesh.window_fire": 1,
                                     "harvest.pending_fire": 1}


def test_task_batch_point_crashes_the_job():
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    env = StreamExecutionEnvironment(Configuration({
        "execution.device": "cpu", "execution.micro-batch.size": 100}))
    (env.from_source(DataGenSource(1000, 10)).key_by("key")
        .window(TumblingEventTimeWindows.of(50)).sum("value")
        .sink_to(CollectSink()))
    plan = tchaos.FaultPlan(rules=[tchaos.FaultRule(
        pattern="task.batch", nth=3, where={"job": "chaotic"})])
    with tchaos.chaos_active(plan, seed=0) as c:
        with pytest.raises(tchaos.InjectedFault):
            env.execute("chaotic")
        assert c.faults_injected == {"task.batch": 1}
        assert c.points_hit["task.batch"] >= 3


# ------------------------------------------------- crash-restore-verify

def _steps(num_keys=6000, n_steps=8, per_step=1500, seed=17):
    """``tools/chaos_smoke.py``'s stream."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        vals = rng.random(per_step).astype(np.float32)
        ts = rng.integers(s * 80, s * 80 + 60, per_step).astype(np.int64)
        out.append((keys, vals, ts, (s - 1) * 80))
    return out


def _smoke_plan(mod):
    return mod.FaultPlan(rules=[
        mod.FaultRule(pattern="mesh.dispatch_fence", nth=5, kind="raise"),
        mod.FaultRule(pattern="spill.page_reload", nth=3, kind="raise"),
        mod.FaultRule(pattern="shuffle.device_exchange", nth=10,
                      kind="raise"),
        mod.FaultRule(pattern="checkpoint.write.torn", nth=2, kind="drop"),
    ])


def _run_both(monkeypatch, tmp_path, eight_device_mesh, plan_of, steps,
              seed, check=True):
    """The same scenario through both harnesses; returns (port report,
    reference report, port committed, reference committed) — the committed
    output is captured where each harness diffs it."""
    out = {}
    for pkg, harness in (("ref", jharness), ("port", tharness)):
        captured = {}
        real = harness._diff

        def spy(expected, got, *a, _real=real, _c=captured, **k):
            _c["committed"] = dict(got)
            return _real(expected, got, *a, **k)

        monkeypatch.setattr(harness, "_diff", spy)
        report = harness.run_crash_restore_verify(
            _mesh_engine(pkg, eight_device_mesh), _oracle(pkg), steps,
            plan_of(PKGS[pkg]), seed=seed,
            ckpt_root=str(tmp_path / f"ckpt-{pkg}"), checkpoint_every=2,
            check=check)
        out[pkg] = (report, captured["committed"])
    return out["port"][0], out["ref"][0], out["port"][1], out["ref"][1]


def _committed_bits(committed):
    return {k: {n: np.float32(v).view(np.uint32) for n, v in f.items()}
            for k, f in committed.items()}


def test_chaos_smoke_scenario_matches_reference(monkeypatch, tmp_path,
                                                eight_device_mesh):
    """``tools/chaos_smoke.py`` ``main``: 3 crashes, 3 restores, the torn
    checkpoint skipped, every planned point injected; the same signature,
    points hit and committed output as the reference."""
    t, j, tc, jc = _run_both(monkeypatch, tmp_path, eight_device_mesh,
                             _smoke_plan, _steps(), seed=7)
    assert not t.diverged
    assert t.crashes == 3 and t.restores == 3
    assert t.corrupt_checkpoints_skipped >= 1
    assert set(t.faults_injected) == {
        "mesh.dispatch_fence", "spill.page_reload",
        "shuffle.device_exchange", "checkpoint.write.torn"}
    assert t.signature() == j.signature()
    assert t.points_hit == j.points_hit
    assert (t.corrupt_checkpoints_skipped, t.retries, t.recoveries) == (
        j.corrupt_checkpoints_skipped, j.retries, j.recoveries)
    assert _committed_bits(tc) == _committed_bits(jc)
    assert t.events_replayed > 0
    assert len(t.checkpoint_bytes) == t.checkpoints_written
    assert len(t.restore_ms) == t.restores


def test_device_mode_crash_restore_matches_reference(monkeypatch, tmp_path,
                                                     eight_device_mesh):
    """``tests/test_chaos.py``'s device-mode scenario: a crash mid-batch
    after the fused dispatch, restore, replay; oracle-identical, and
    seed-deterministic (a second port run gives the same signature)."""
    def plan_of(mod):
        return mod.FaultPlan(rules=[
            mod.FaultRule(pattern="shuffle.device_exchange", nth=5)])

    steps = _steps(seed=47)
    t, j, tc, jc = _run_both(monkeypatch, tmp_path, eight_device_mesh,
                             plan_of, steps, seed=9)
    assert not t.diverged and t.windows > 0
    assert t.crashes == 1 and t.restores == 1
    assert t.signature() == j.signature()
    assert _committed_bits(tc) == _committed_bits(jc)
    again = tharness.run_crash_restore_verify(
        _mesh_engine("port", eight_device_mesh), _oracle("port"), steps,
        plan_of(tchaos), seed=9, ckpt_root=str(tmp_path / "again"),
        checkpoint_every=2)
    assert again.signature() == t.signature()


def test_device_negative_control_drop_diverges(monkeypatch, tmp_path,
                                               eight_device_mesh):
    """A dropped shard on the device data plane diverges from the oracle:
    the harness catches the loss, as the reference's does."""
    def plan_of(mod):
        return mod.FaultPlan(rules=[
            mod.FaultRule(pattern="shuffle.device_exchange", nth=4,
                          kind="drop")])

    t, j, tc, jc = _run_both(monkeypatch, tmp_path, eight_device_mesh,
                             plan_of, _steps(seed=53), seed=5, check=False)
    assert t.diverged and t.crashes == 0
    assert t.faults_injected == {"shuffle.device_exchange": 1}
    assert t.signature() == j.signature()
    assert _committed_bits(tc) == _committed_bits(jc)
    with pytest.raises(tharness.ChaosDivergenceError):
        tharness.run_crash_restore_verify(
            _mesh_engine("port", eight_device_mesh), _oracle("port"),
            _steps(seed=53), plan_of(tchaos), seed=5,
            ckpt_root=str(tmp_path / "strict"), checkpoint_every=2)
