"""The port's multi-tenancy plane (``flink_tpu_torch/tenancy/``) against the
reference's (``flink_tpu/tenancy/``) on the CPU, mirroring
``tests/test_tenancy.py``:

- the program cache (a fresh job's steps all hit; the key is what a
  step computes, not who asks; builds run outside the lock, once per key);
- cross-job isolation: two jobs interleaved on one mesh fire what each
  fires alone, and what the reference fires on the same stream; a
  quota's backstop sheds only its own job's rows;
- ``DeficitRoundRobin`` and ``ShardArbiter.decide`` driven through the
  same sequences in both packages (seeded random demands included);
- ``SessionCluster``: two jobs' sinks equal the reference cluster's on
  the same pipelines; per-job spill and checkpoint trees; crash and
  failed-restart containment; lookups racing completion; ``_release``;
  the packed lookup path; the arbiter's refusal (ROADMAP item 12g);
- ``LocalExecutor.run_stepwise`` and ``JobHandle``;
- the two-job chaos cases through ``run_crash_restore_verify_multi``.

Tolerance: none. Fired sums are float32 values compared exactly (the
streams' values are ones, so every order gives the same bits, as the
reference's tests pin), sink rows with ``==``, arbiter allocations and
DRR deficits exactly.
"""

import os
import queue as _q
import threading
import time
import types

import numpy as np
import pytest

import flink_tpu.tenancy.arbiter as jarbiter
import flink_tpu.tenancy.fairness as jfairness
import flink_tpu.tenancy.program_cache as jcache
from flink_tpu.chaos import harness as jharness
from flink_tpu.chaos import injection as jchaos
from flink_tpu.connectors.sinks import CollectSink as JCollectSink
from flink_tpu.connectors.sources import DataGenSource as JDataGen
from flink_tpu.core.config import Configuration as JConfiguration
from flink_tpu.datastream.environment import (
    StreamExecutionEnvironment as JEnv,
)
from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_tpu.parallel.sharded_sessions import MeshSessionEngine as JSess
from flink_tpu.parallel.sharded_windower import MeshWindowEngine as JWin
from flink_tpu.runtime.watermarks import WatermarkStrategy as JWM
from flink_tpu.tenancy.session_cluster import SessionCluster as JCluster
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing.assigners import (
    TumblingEventTimeWindows as JTumbling,
)
from flink_tpu.windowing.sessions import SessionWindower as JSessW
from flink_tpu_torch import Configuration, StreamExecutionEnvironment
from flink_tpu_torch.chaos import harness
from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.chaos.injection import FaultPlan, FaultRule
from flink_tpu_torch.cluster.local_executor import (
    JobHandle,
    LocalExecutor,
    StateQueryBatchRequest,
)
from flink_tpu_torch.connectors.sinks import CollectSink, Sink
from flink_tpu_torch.connectors.sources import DataGenSource
from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
from flink_tpu_torch.tenancy.arbiter import JobDemand, ShardArbiter
from flink_tpu_torch.tenancy.fairness import DeficitRoundRobin
from flink_tpu_torch.tenancy.program_cache import (
    PROGRAM_CACHE,
    SharedProgramCache,
)
from flink_tpu_torch.tenancy.quotas import QuotaLedger, TenantQuota
from flink_tpu_torch.tenancy.session_cluster import SessionCluster
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from flink_tpu_torch.windowing.sessions import SessionWindower

GAP = 1_000
FINAL = 1 << 60
OP = "window_agg(SumAggregate)"


def _tbatch(keys, values, ts):
    return RecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(values, dtype=np.float32)}, timestamps=ts)


def _jbatch(keys, values, ts):
    from flink_tpu.core.records import RecordBatch as JRecordBatch

    return JRecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(values, dtype=np.float32)}, timestamps=ts)


def _fired_dict(batches):
    out = {}
    for b in batches:
        for r in b.to_rows():
            out[(int(r[KEY_ID_FIELD]), int(r["window_start"]),
                 int(r["window_end"]))] = float(r["sum_v"])
    return out


def _session_steps(seed, n_batches=12, batch=512, keys=300, adv=700):
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for _ in range(n_batches):
        ks = rng.integers(0, keys, batch)
        ts = t + np.sort(rng.integers(0, 400, batch))
        out.append((ks, np.ones(batch, np.float32), ts, t - 2 * GAP))
        t += adv
    return out


def _window_steps(seed, n_batches=10, batch=512, keys=200):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        ks = rng.integers(0, keys, batch)
        ts = i * 500 + np.sort(rng.integers(0, 500, batch))
        out.append((ks, np.ones(batch, np.float32), ts, i * 500 - 1000))
    return out


def _drive(engine, steps, mk=_tbatch):
    fired = {}
    for ks, vs, ts, wm in steps:
        engine.process_batch(mk(ks, vs, ts))
        fired.update(_fired_dict(engine.on_watermark(wm)))
    fired.update(_fired_dict(engine.on_watermark(FINAL)))
    return fired


# ------------------------------------------------------------ program cache


def test_second_job_zero_cache_misses():
    """Job B's engines on a warm cluster reuse job A's steps: zero
    misses attributed to B (the reference's gate; the port's steps are closures,
    so there is no compile count to hold)."""
    mesh = make_mesh(4, "cpu")

    def make():
        return MeshSessionEngine(GAP, tagg.SumAggregate("v"), mesh,
                                 capacity_per_shard=2048,
                                 max_device_slots=2048)

    with PROGRAM_CACHE.job_scope("warm-a"):
        _drive(make(), _session_steps(7))
    PROGRAM_CACHE.reset_stats()
    with PROGRAM_CACHE.job_scope("warm-b"):
        fired = _drive(make(), _session_steps(7))
    stats = PROGRAM_CACHE.stats_for("warm-b")
    assert stats["misses"] == 0 and stats["hits"] >= 3
    jmesh = jmake_mesh(4)
    want = _drive(JSess(GAP, jagg.SumAggregate("v"), jmesh,
                        capacity_per_shard=2048, max_device_slots=2048),
                  _session_steps(7), _jbatch)
    assert fired == want


def test_cache_key_is_what_not_who():
    from flink_tpu_torch.parallel.shuffle import build_exchange_scatter
    from flink_tpu_torch.parallel.sharded_windower import build_mesh_steps
    from flink_tpu_torch.tenancy.replica import build_replica_steps

    mesh = make_mesh(2, "cpu")
    PROGRAM_CACHE.reset_stats()
    with PROGRAM_CACHE.job_scope("k-a"):
        a = build_mesh_steps(mesh, tagg.SumAggregate("v"))
        xa = build_exchange_scatter(mesh, tagg.SumAggregate("v"))
        ra = build_replica_steps(mesh, ("float32",))
    with PROGRAM_CACHE.job_scope("k-b"):
        b = build_mesh_steps(mesh, tagg.SumAggregate("v"))
        c = build_mesh_steps(mesh, tagg.CountAggregate())
        xb = build_exchange_scatter(mesh, tagg.SumAggregate("v"))
        xv = build_exchange_scatter(mesh, tagg.SumAggregate("v"),
                                    valued=True)
        rb = build_replica_steps(mesh, ("float32",))
        d = build_mesh_steps(make_mesh(4, "cpu"), tagg.SumAggregate("v"))
    assert a is b and c is not a and d is not a
    assert xa is xb and xv is not xa and ra is rb
    # other tests of the process may have built the rest of k-b's keys
    assert PROGRAM_CACHE.stats_for("k-b")["hits"] >= 3


@pytest.mark.parametrize("cls", [SharedProgramCache,
                                 jcache.SharedProgramCache],
                         ids=["port", "reference"])
def test_build_does_not_stall_other_keys_and_retries_on_failure(cls):
    """Builds run OUTSIDE the cache lock behind a per-key latch: a hit on
    another key proceeds mid-build; two racers on one key cost one build;
    a failed build releases its latch. Both packages' caches behave the
    same."""
    cache = cls()
    in_build, release = threading.Event(), threading.Event()
    builds = []

    def slow_build():
        in_build.set()
        assert release.wait(10)
        builds.append(1)
        return "slow"

    cache.get_or_build("other", ("k2",), lambda: "fast")
    t = threading.Thread(target=cache.get_or_build,
                         args=("kind", ("k1",), slow_build))
    t.start()
    assert in_build.wait(10)
    assert cache.get_or_build("other", ("k2",), lambda: "never") == "fast"
    racer = []
    r = threading.Thread(target=lambda: racer.append(
        cache.get_or_build("kind", ("k1",), slow_build)))
    r.start()
    release.set()
    t.join(10)
    r.join(10)
    assert racer == ["slow"] and builds == [1]
    with pytest.raises(RuntimeError):
        cache.get_or_build("kind", ("boom",), lambda: (_ for _ in ()).throw(
            RuntimeError("build failed")))
    assert cache.get_or_build("kind", ("boom",),
                              lambda: "recovered") == "recovered"
    assert cache.stats() == {"programs": 3, "hits": 2, "misses": 4}


# ------------------------------------------------------- cross-job isolation


def test_two_session_jobs_interleaved_equal_solo_and_reference():
    """Sessions with the paged tier evicting: jobs A and B run the same key
    space interleaved on one mesh; each fires what it fires alone and what
    the reference fires on the same stream."""
    mesh = make_mesh(2, "cpu")
    steps = _session_steps(7, keys=50_000, batch=1024, adv=300)

    def make():
        return MeshSessionEngine(GAP, tagg.SumAggregate("v"), mesh,
                                 capacity_per_shard=1024,
                                 max_device_slots=1024)

    solo = _drive(make(), steps)
    a, b = make(), make()
    fired_a, fired_b = {}, {}
    for ks, vs, ts, wm in steps:
        for eng, fired in ((a, fired_a), (b, fired_b)):
            eng.process_batch(_tbatch(ks, vs, ts))
            fired.update(_fired_dict(eng.on_watermark(wm)))
    fired_a.update(_fired_dict(a.on_watermark(FINAL)))
    fired_b.update(_fired_dict(b.on_watermark(FINAL)))
    assert a.spill_counters()["rows_evicted"] > 0
    assert fired_a == solo and fired_b == solo
    want = _drive(JSess(GAP, jagg.SumAggregate("v"), jmake_mesh(2),
                        capacity_per_shard=1024, max_device_slots=1024),
                  steps, _jbatch)
    assert solo == want


def test_two_window_jobs_interleaved_equal_solo_and_reference():
    mesh = make_mesh(4, "cpu")

    def make():
        return MeshWindowEngine(TumblingEventTimeWindows.of(1_000),
                                tagg.SumAggregate("v"), mesh,
                                capacity_per_shard=1024,
                                max_device_slots=1024)

    steps = _window_steps(3)
    solo = _drive(make(), steps)
    a, b = make(), make()
    fired_a, fired_b = {}, {}
    for ks, vs, ts, wm in steps:
        for eng, fired in ((a, fired_a), (b, fired_b)):
            eng.process_batch(_tbatch(ks, vs, ts))
            fired.update(_fired_dict(eng.on_watermark(wm)))
    fired_a.update(_fired_dict(a.on_watermark(FINAL)))
    fired_b.update(_fired_dict(b.on_watermark(FINAL)))
    assert fired_a == solo and fired_b == solo
    want = _drive(JWin(JTumbling.of(1_000), jagg.SumAggregate("v"),
                       jmake_mesh(4), capacity_per_shard=1024,
                       max_device_slots=1024), steps, _jbatch)
    assert solo == want


@pytest.mark.parametrize("kind", ["sessions", "windows"])
def test_quota_exceeder_spills_own_rows_never_neighbors(kind):
    """Job B floods past its quota; the ledger's backstop
    (``enforce_resident_budget``) sheds B's rows into B's own tier, A's
    rows and spill traffic do not move, and B still fires exactly what the
    reference engine fires after the same shed."""
    def make(pkg):
        if kind == "sessions":
            cls, mesh, agg = ((MeshSessionEngine, make_mesh(2, "cpu"),
                               tagg) if pkg == "t" else
                              (JSess, jmake_mesh(2), jagg))
            return cls(GAP, agg.SumAggregate("v"), mesh,
                       capacity_per_shard=4096, max_device_slots=4096)
        cls, mesh, agg, asg = (
            (MeshWindowEngine, make_mesh(2, "cpu"), tagg,
             TumblingEventTimeWindows) if pkg == "t" else
            (JWin, jmake_mesh(2), jagg, JTumbling))
        return cls(asg.of(1000), agg.SumAggregate("v"), mesh,
                   capacity_per_shard=4096, max_device_slots=4096)

    a, b, jb = make("t"), make("t"), make("j")
    a.process_batch(_tbatch([1, 2, 3], [1.0] * 3, [0, 10, 20]))
    a_resident, a_spill = sum(a.shard_resident_rows()), dict(
        a.spill_counters())
    n = 6000
    ks = np.arange(n, dtype=np.int64)
    ts = (np.arange(n, dtype=np.int64) % 4) * 1000 if kind == "windows" \
        else np.zeros(n, np.int64)
    b.process_batch(_tbatch(ks, np.ones(n), ts))
    jb.process_batch(_jbatch(ks, np.ones(n), ts))
    ledger = QuotaLedger(job="b", quota=TenantQuota(max_resident_rows=2048))
    ledger.bind([b])
    from flink_tpu.tenancy.quotas import QuotaLedger as JLedger
    from flink_tpu.tenancy.quotas import TenantQuota as JQuota

    jl = JLedger(job="b", quota=JQuota(max_resident_rows=2048))
    jl.bind([jb])
    assert ledger.resident_rows() == jl.resident_rows() > 2048
    shed = ledger.enforce()
    assert shed > 0 and ledger.resident_rows() <= 2048
    assert ledger.quota_violations == 0
    jl.enforce()
    assert ledger.rows_shed == jl.rows_shed
    assert ledger.metrics() == jl.metrics()
    assert sum(a.shard_resident_rows()) == a_resident
    assert dict(a.spill_counters()) == a_spill
    fired = _fired_dict(b.on_watermark(FINAL))
    assert len(fired) == n and all(v == 1.0 for v in fired.values())
    assert fired == _fired_dict(jb.on_watermark(FINAL))


def test_quota_without_spill_tier_counts_violation():
    eng = MeshSessionEngine(GAP, tagg.SumAggregate("v"), make_mesh(2, "cpu"),
                            capacity_per_shard=4096)
    eng.process_batch(_tbatch(np.arange(3000), np.ones(3000),
                              np.zeros(3000, np.int64)))
    ledger = QuotaLedger(job="x", quota=TenantQuota(max_resident_rows=1024))
    ledger.bind([eng])
    assert ledger.enforce() == 0 and ledger.quota_violations >= 1
    with pytest.raises(RuntimeError, match="spill tier"):
        eng.enforce_resident_budget(1024)


def test_quota_counts_single_device_engines():
    """``bind`` keeps the OPERATOR of a single-device engine (whose
    ``shard_resident_rows`` walks the slot table), so the quota counts it
    and reports the violation it cannot shed."""
    from flink_tpu_torch.core.records import TIMESTAMP_FIELD
    from flink_tpu_torch.runtime.operators import (
        OperatorContext,
        WindowAggOperator,
    )
    from flink_tpu_torch.state.keygroups import hash_keys_to_i64

    op = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                           tagg.SumAggregate("v"), "key", capacity=4096)
    op.open(OperatorContext(max_parallelism=128, device="cpu"))
    n = 2000
    keys = np.arange(n, dtype=np.int64)
    op.process_batch(RecordBatch.from_pydict({
        "key": keys, KEY_ID_FIELD: hash_keys_to_i64(keys),
        "v": np.ones(n, np.float32),
        TIMESTAMP_FIELD: np.zeros(n, np.int64)}))
    ledger = QuotaLedger(job="sd", quota=TenantQuota(max_resident_rows=512))
    ledger.bind([op])
    assert ledger.resident_rows() >= n and ledger.pressure() > 1.0
    assert ledger.enforce() == 0 and ledger.quota_violations >= 1


def test_quota_per_shard_slots_equals_reference():
    from flink_tpu.tenancy.quotas import TenantQuota as JQuota

    for rows in (0, 100, 8192, 1 << 20):
        for shards in (1, 4, 8, 0):
            assert TenantQuota(rows).per_shard_slots(shards) == \
                JQuota(rows).per_shard_slots(shards)


# ------------------------------------------------------------------ fairness


@pytest.mark.parametrize("mod", [None, jfairness], ids=["port", "ref"])
def test_drr_quantum_shares_and_idle_reset(mod):
    cls = DeficitRoundRobin if mod is None else mod.DeficitRoundRobin
    drr = cls(quantum=100)
    drr.add("a")
    drr.add("b", weight=2.0)
    assert drr.begin_round() == ["a", "b"]
    assert drr.deficit("a") == 100 and drr.deficit("b") == 200
    drr.charge("a", 150)
    assert not drr.can_run("a")
    drr.begin_round()
    assert drr.deficit("a") == 50
    drr.reset_idle("b")
    assert drr.deficit("b") == 0.0
    drr.charge("a", 0)
    assert drr.deficit("a") == 49
    drr.remove("a")
    assert drr.deficit("a") is None and drr.begin_round() == ["b"]


def test_drr_random_schedule_equals_reference():
    """A seeded mix of adds, weights, charges, idle resets and removals
    gives the same deficits and service orders in both packages."""
    rng = np.random.default_rng(19)
    t, j = DeficitRoundRobin(quantum=64), jfairness.DeficitRoundRobin(64)
    names = [f"job{i}" for i in range(5)]
    for step in range(400):
        op = rng.integers(0, 6)
        name = names[int(rng.integers(0, 5))]
        if op == 0:
            w = float(rng.choice([0.5, 1.0, 2.0]))
            t.add(name, w)
            j.add(name, w)
        elif op == 1:
            assert t.begin_round() == j.begin_round()
        elif op in (2, 3):
            n = int(rng.integers(0, 200))
            t.charge(name, n)
            j.charge(name, n)
        elif op == 4:
            t.reset_idle(name)
            j.reset_idle(name)
        else:
            t.remove(name)
            j.remove(name)
        for n in names:
            assert t.deficit(n) == j.deficit(n)
            assert t.can_run(n) == j.can_run(n)


def test_hot_job_cannot_starve_sibling():
    drr = DeficitRoundRobin(quantum=10)
    drr.add("hot")
    drr.add("cold")
    served = {"hot": 0, "cold": 0}
    for _ in range(50):
        for name in drr.begin_round():
            while drr.can_run(name):
                served[name] += 1
                drr.charge(name, 10)
    assert served["hot"] == served["cold"] == 50


# ------------------------------------------------------------------ arbiter

_ARBITER_CASES = {
    "backlog": (dict(total_shards=8, cooldown_ticks=0, backlog_norm=1000.0),
                [dict(job="hungry", current_shards=2, backlog=7000.0),
                 dict(job="quiet", current_shards=2, backlog=0.0)]),
    "pressure": (dict(total_shards=8, cooldown_ticks=0),
                 [dict(job="a", current_shards=4, quota_pressure=3.0),
                  dict(job="b", current_shards=4)]),
    "clamps": (dict(total_shards=8, cooldown_ticks=0),
               [dict(job="a", current_shards=1, backlog=1e9, max_shards=3),
                dict(job="b", current_shards=1, min_shards=2)]),
    "hysteresis": (dict(total_shards=9, hysteresis=1, cooldown_ticks=0),
                   [dict(job="a", current_shards=4, backlog=100.0),
                    dict(job="b", current_shards=4)]),
    "min_clamps": (dict(total_shards=4, cooldown_ticks=0),
                   [dict(job="a", current_shards=2, backlog=1e9,
                         min_shards=2),
                    dict(job="b", current_shards=1),
                    dict(job="c", current_shards=1)]),
    "repin": (dict(total_shards=9, hysteresis=1, cooldown_ticks=0,
                   backlog_norm=100.0),
              [dict(job="a", current_shards=3, backlog=200.0),
               dict(job="b", current_shards=3),
               dict(job="c", current_shards=3)]),
    "floors_over_budget": (dict(total_shards=3, cooldown_ticks=0),
                           [dict(job="a", current_shards=1, min_shards=2),
                            dict(job="b", current_shards=1, min_shards=2)]),
}


@pytest.mark.parametrize("case", sorted(_ARBITER_CASES))
def test_arbiter_cases_equal_reference(case):
    kw, demands = _ARBITER_CASES[case]
    got = ShardArbiter(**kw).decide([JobDemand(**d) for d in demands])
    want = jarbiter.ShardArbiter(**kw).decide(
        [jarbiter.JobDemand(**d) for d in demands])
    assert got == want
    if case != "floors_over_budget":
        assert sum(got.values()) <= kw["total_shards"]
    if case == "backlog":
        assert got["hungry"] > got["quiet"] >= 1
    if case == "hysteresis":
        assert got == {"a": 4, "b": 4}


@pytest.mark.parametrize("seed", range(6))
def test_arbiter_seeded_demands_equal_reference(seed):
    """Ticks of seeded random demands (backlog, pressure, floors, ceilings,
    dead shards, hysteresis, cooldown): both packages' arbiters decide the
    same allocation at every tick."""
    rng = np.random.default_rng(seed)
    kw = dict(total_shards=int(rng.integers(2, 17)),
              hysteresis=int(rng.integers(0, 2)),
              cooldown_ticks=int(rng.integers(0, 3)),
              backlog_norm=float(rng.choice([100.0, 65536.0])))
    t, j = ShardArbiter(**kw), jarbiter.ShardArbiter(**kw)
    current = {f"j{i}": int(rng.integers(1, 5))
               for i in range(int(rng.integers(1, 5)))}
    for _ in range(25):
        demands = [dict(job=n, current_shards=c,
                        backlog=float(rng.integers(0, 200_000)),
                        quota_pressure=float(rng.random() * 3),
                        min_shards=int(rng.integers(1, 3)),
                        max_shards=int(rng.choice([0, 2, 4, 8])))
                   for n, c in current.items()]
        dead = int(rng.integers(0, 3))
        got = t.decide([JobDemand(**d) for d in demands], dead_shards=dead)
        want = j.decide([jarbiter.JobDemand(**d) for d in demands],
                        dead_shards=dead)
        assert got == want
        current = {n: max(int(v), 1) for n, v in got.items()}


@pytest.mark.parametrize("mod", [None, jarbiter], ids=["port", "ref"])
def test_arbiter_cooldown_suppresses_exactly_n_ticks(mod):
    cls = ShardArbiter if mod is None else mod.ShardArbiter
    dem = JobDemand if mod is None else mod.JobDemand
    arb = cls(total_shards=8, cooldown_ticks=2, backlog_norm=1.0)
    acted = []
    cur = {"a": 1, "b": 1}
    for i in range(8):
        back = 100.0 if i % 2 == 0 else 0.0
        alloc = arb.decide([dem(job="a", current_shards=cur["a"],
                                backlog=back),
                            dem(job="b", current_shards=cur["b"])])
        acted.append(alloc != cur)
        cur = alloc
    assert acted == [True, False, False, True, False, False, True, False]


# ------------------------------------------------------------------ cluster


def _pipeline(pkg, sink, n=30_000, keys=64, par=2, window=10_000, seed=5,
              extra=None):
    cfg = {"execution.micro-batch.size": 2048, "parallelism.default": par,
           **(extra or {})}
    if pkg == "t":
        cfg["execution.device"] = "cpu"
        env = StreamExecutionEnvironment(Configuration(cfg))
        src, wm, asg = DataGenSource, WatermarkStrategy, \
            TumblingEventTimeWindows
    else:
        env = JEnv(JConfiguration(cfg))
        src, wm, asg = JDataGen, JWM, JTumbling
    (env.add_source(src(total_records=n, num_keys=keys,
                        events_per_second_of_eventtime=5_000, seed=seed),
                    wm.for_bounded_out_of_orderness(0))
        .key_by("key").window(asg.of(window)).sum("value").sink_to(sink))
    return env


def _rows(sink):
    return sorted((r["key"], r["window_end"], r["sum_value"])
                  for r in sink.rows())


class _UpsertSink(Sink):
    def __init__(self):
        self.cells = {}

    def write(self, batch):
        for r in batch.to_rows():
            self.cells[(r["key"], int(r["window_end"]))] = \
                float(r["sum_value"])


@pytest.mark.parametrize("replica", [True, False])
def test_two_jobs_equal_reference_cluster(replica):
    """Two jobs on one port cluster and the same two on one reference
    cluster: every sink row equal; the fairness telemetry counts every
    record; the cluster's tenancy gauges read."""
    extra = {"serving.replica": replica}
    sinks = {n: CollectSink() for n in ("job-a", "job-b")}
    jsinks = {n: JCollectSink() for n in ("job-a", "job-b")}
    cluster = SessionCluster(quantum_records=4096)
    jcluster = JCluster(quantum_records=4096)
    for i, n in enumerate(sinks):
        cluster.submit(_pipeline("t", sinks[n], seed=5 + i, extra=extra), n)
        jcluster.submit(_pipeline("j", jsinks[n], seed=5 + i, extra=extra),
                        n)
    results = cluster.run(timeout_s=120)
    jcluster.run(timeout_s=120)
    for n in sinks:
        assert _rows(sinks[n]) == _rows(jsinks[n]) != []
        assert hasattr(results[n], "metrics")
        assert cluster.jobs[n].records_total == 30_000
        assert cluster.jobs[n].busy_ms >= 0.0
    snap = cluster.registry.snapshot()
    for g in ("jobs_live", "program_cache_programs", "queryable_lookups_total",
              "serving.replicaStalenessMs", "serving.hotRowHitRate"):
        assert any(k.endswith(f"tenancy.{g}") for k in snap), g


def test_per_job_spill_directories(tmp_path):
    base = str(tmp_path / "spill")
    cfg = {"state.slot-table.max-device-slots": 2048,
           "state.spill.dir": base}
    sa, sb = CollectSink(), CollectSink()
    cluster = SessionCluster(quantum_records=4096)
    cluster.submit(_pipeline("t", sa, extra=cfg), "iso-a")
    cluster.submit(_pipeline("t", sb, extra=cfg), "iso-b")
    for name in ("iso-a", "iso-b"):
        dirs = {getattr(e, "_spill_dir", None)
                for e in cluster.jobs[name].ledger.engines}
        assert dirs == {os.path.join(base, f"job-{name}")}, dirs
    cluster.run(timeout_s=120)
    assert _rows(sa) == _rows(sb) != []


def test_reused_quota_object_keeps_spill_dirs_private(tmp_path):
    base = str(tmp_path / "spill")
    cfg = {"state.slot-table.max-device-slots": 2048,
           "state.spill.dir": base}
    shared = TenantQuota(max_resident_rows=1 << 20)
    sa, sb = CollectSink(), CollectSink()
    cluster = SessionCluster(quantum_records=4096)
    cluster.submit(_pipeline("t", sa, extra=cfg), "share-a", quota=shared)
    cluster.submit(_pipeline("t", sb, extra=cfg), "share-b", quota=shared)
    assert shared.spill_dir is None
    for name in ("share-a", "share-b"):
        assert cluster.jobs[name].quota.spill_dir == \
            os.path.join(base, f"job-{name}")
        dirs = {getattr(e, "_spill_dir", None)
                for e in cluster.jobs[name].ledger.engines}
        assert dirs == {os.path.join(base, f"job-{name}")}, dirs
    cluster.run(timeout_s=120)
    assert _rows(sa) == _rows(sb) != []


def test_lookup_racing_job_completion_fails_fast():
    from flink_tpu_torch.tenancy.serving import ServingPlane

    plane = ServingPlane(timeout_s=5.0)

    class _TerminatingQueue(_q.Queue):
        def put(self, item, *a, **k):
            super().put(item, *a, **k)
            plane.unbind_job("gone")

    plane.bind_job("gone", _TerminatingQueue())
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="not serving"):
        plane._flush("gone", "op", [1, 2], None)
    assert time.perf_counter() - t0 < 1.0
    job = types.SimpleNamespace(control=_q.Queue(), name="dead")
    req = StateQueryBatchRequest("op", [1], None)
    job.control.put(req)
    SessionCluster._fail_stranded_lookups(job)
    with pytest.raises(RuntimeError, match="not serving"):
        req.wait(1.0)


def test_shared_checkpoint_dir_isolated_per_job(tmp_path):
    """Two jobs (different seeds) on one configured checkpoint dir: each
    checkpoints into its own tree, so the crashed one restores its own
    state; both end equal to their solo runs."""
    solo_a, solo_b = _UpsertSink(), _UpsertSink()
    _pipeline("t", solo_a, n=20_000).execute("solo-a")
    _pipeline("t", solo_b, n=20_000, seed=9).execute("solo-b")
    assert solo_a.cells != solo_b.cells
    ck = str(tmp_path / "ck")
    cfg = {"state.checkpoints.dir": ck,
           "execution.checkpointing.every-n-source-batches": 2}
    sa, sb = _UpsertSink(), _UpsertSink()
    cluster = SessionCluster(quantum_records=1024, max_restarts=2)
    cluster.submit(_pipeline("t", sa, n=20_000, extra=cfg), "steady")
    cluster.submit(_pipeline("t", sb, n=20_000, seed=9, extra=cfg), "crashy")
    plan = FaultPlan(rules=[FaultRule(pattern="task.batch", nth=5,
                                      where={"job": "crashy"})])
    with chaos.chaos_active(plan, seed=11):
        results = cluster.run(timeout_s=180)
    assert cluster.jobs["crashy"].restarts == 1
    assert cluster.jobs["steady"].restarts == 0
    assert not isinstance(results["crashy"], BaseException)
    assert sa.cells == solo_a.cells and sb.cells == solo_b.cells
    assert sorted(os.listdir(ck)) == ["job-crashy", "job-steady"]
    chks = os.listdir(os.path.join(ck, "job-crashy"))
    assert any(d.startswith("chk-") for d in chks), chks


def test_failed_restart_contained_sibling_survives():
    solo = CollectSink()
    _pipeline("t", solo, n=20_000).execute("solo")
    sa, sb = CollectSink(), CollectSink()
    cluster = SessionCluster(quantum_records=1024, max_restarts=2)
    cluster.submit(_pipeline("t", sa, n=20_000), "steady")
    cluster.submit(_pipeline("t", sb, n=20_000, seed=9), "doomed")
    real_start = cluster._start

    def start(job, restore_from=None):
        if job.name == "doomed" and job.restarts > 0:
            raise RuntimeError("operator open failed")
        return real_start(job, restore_from=restore_from)

    cluster._start = start
    plan = FaultPlan(rules=[FaultRule(pattern="task.batch", nth=3,
                                      where={"job": "doomed"})])
    with chaos.chaos_active(plan, seed=7):
        results = cluster.run(timeout_s=120)
    assert _rows(sa) == _rows(solo)
    assert isinstance(results["doomed"], BaseException)
    assert cluster.jobs["doomed"].restarts == 2
    assert not isinstance(results["steady"], BaseException)


def test_finished_jobs_release_execution_resources():
    sa, sb = CollectSink(), CollectSink()
    cluster = SessionCluster(quantum_records=4096)
    cluster.submit(_pipeline("t", sa, n=20_000), "gone-a")
    cluster.submit(_pipeline("t", sb, n=20_000, seed=9), "gone-b")
    cluster.run(timeout_s=120)
    for j in cluster.jobs.values():
        assert j.handle is None and j.gen is None
        assert len(j.ledger.engines) == 0
        assert j.records_total == 20_000
    snap = cluster.registry.snapshot()
    assert not any(".gone-a." in k or ".gone-b." in k for k in snap)
    assert any(k.endswith("tenancy.jobs_live") for k in snap)


def test_lookups_during_run_equal_the_live_query():
    """Client threads look keys up while the job runs (replica path);
    every non-empty answer is one the live engine gave at some boundary:
    at the end the last answers equal the reference's fired sums."""
    sink = CollectSink()
    env = _pipeline("t", sink, n=120_000, keys=16, window=1 << 40,
                    extra={"serving.replica.publish-interval-ms": 5})
    cluster = SessionCluster(quantum_records=2048)
    cluster.submit(env, "serve-job")
    errors, got = [], {}

    def client(tid):
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                out = cluster.lookup("serve-job", OP, tid % 16)
                if out:
                    got[tid] = out
                    return
                time.sleep(0.01)
            errors.append(f"client {tid}: no state observed")
        except RuntimeError:
            pass
        except BaseException as e:  # noqa: BLE001
            errors.append(f"client {tid}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    cluster.run(timeout_s=120)
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    m = cluster.serving.metrics()
    assert m["lookups_total"] >= len(got) > 0
    for out in got.values():
        (ns, cols), = out.items()
        assert cols["sum_value"] > 0


def test_packed_lookup_batch_matches_dict_path():
    from flink_tpu_torch.native import hotcache_available
    from flink_tpu_torch.tenancy.hot_cache import HotRowCache
    from flink_tpu_torch.tenancy.serving import PackedLookupResult

    sink = CollectSink()
    env = _pipeline("t", sink, n=120_000, keys=16, window=1 << 40,
                    extra={"serving.replica.publish-interval-ms": 5})
    cluster = SessionCluster(quantum_records=2048)
    cluster.submit(env, "packed-job")
    errors, checked, gens = [], [], []

    def client():
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                keys = list(range(16))
                packed = cluster.lookup_batch_packed("packed-job", OP, keys)
                assert isinstance(packed, PackedLookupResult)
                if any(packed.to_dicts()):
                    for _ in range(5):
                        dicts = cluster.lookup_batch("packed-job", OP, keys)
                        if packed == dicts:
                            gens.append(
                                cluster.serving.replica_generations())
                            checked.append(True)
                            return
                        packed = cluster.lookup_batch_packed(
                            "packed-job", OP, keys)
                    errors.append("packed != dict results")
                    return
                time.sleep(0.01)
        except RuntimeError:
            pass
        except BaseException as e:  # noqa: BLE001
            errors.append(f"packed client: {e!r}")

    t = threading.Thread(target=client)
    t.start()
    cluster.run(timeout_s=120)
    t.join(timeout=30)
    assert not errors, errors
    assert checked
    assert max(gens) >= 1  # the answers came off a sealed generation
    if hotcache_available():
        assert not isinstance(cluster.serving.hot_cache, HotRowCache)


def _held_pipeline(pkg, sink, hold, n=40_000, keys=64):
    cfg = {"execution.micro-batch.size": 2048, "parallelism.default": 4}
    if pkg == "t":
        from flink_tpu_torch.benchmarks.held import HeldDataGenSource

        cfg["execution.device"] = "cpu"
        env = StreamExecutionEnvironment(Configuration(cfg))
        src = HeldDataGenSource(hold, total_records=n, num_keys=keys,
                                events_per_second_of_eventtime=5_000,
                                seed=5)
        wm, asg = WatermarkStrategy, TumblingEventTimeWindows
    else:
        from tests.test_torch_minicluster import Ref

        env = JEnv(JConfiguration(cfg))
        src = Ref.HeldDataGen(hold, total_records=n, num_keys=keys,
                              events_per_second_of_eventtime=5_000, seed=5)
        wm, asg = JWM, JTumbling
    (env.add_source(src, wm.for_bounded_out_of_orderness(0))
        .key_by("key").window(asg.of(3_000)).sum("value").sink_to(sink))
    return env


def _at_cut(cluster_cls, pkg, sink, hold):
    from flink_tpu_torch.benchmarks.held import release, settle, wait_held

    cluster = cluster_cls(quantum_records=2048)
    cluster.submit(_held_pipeline(pkg, sink, hold), "cut")
    out = {}
    th = threading.Thread(target=lambda: out.update(
        r=cluster.run(timeout_s=120)))
    th.start()
    try:
        wait_held(hold, timeout_s=120)
        req_cls = (StateQueryBatchRequest if pkg == "t" else
                   __import__("flink_tpu.cluster.local_executor",
                              fromlist=["x"]).StateQueryBatchRequest)
        control = cluster.jobs["cut"].control

        def ask(keys):
            req = req_cls(OP, keys)
            control.put(req)
            return req.wait(60)

        keys = list(range(64))
        live = settle(lambda: ask(keys))
        replica = cluster.lookup_batch("cut", OP, keys)
    finally:
        release(hold)
        th.join(timeout=120)
    return live, replica


def test_replica_answers_at_held_cut_equal_live_and_reference(tmp_path):
    """A held end of stream: after the cut every key's replica answer
    through the cluster equals the live engine's ``query_state_batch``
    (the job's control queue) and the reference cluster's at the same
    cut."""
    from tests.test_torch_queries import same_answers

    live, replica = _at_cut(SessionCluster, "t", CollectSink(),
                            str(tmp_path / "t"))
    jlive, jreplica = _at_cut(JCluster, "j", JCollectSink(),
                              str(tmp_path / "j"))
    assert any(live)
    same_answers(replica, live)
    same_answers(replica, jreplica)
    same_answers(live, jlive)


def test_arbiter_rejected_at_construction_naming_12g():
    """Item 12g is ported: ``arbiter=`` with ``arbitrate_every_s > 0`` is
    built (it used to raise naming 12g), and two jobs run under a live
    arbitration tick — the arbiter grows the backlogged job's logical
    shards, every served rescale succeeds (``rescale_errors`` 0), and
    each job's rows equal its solo run (exact: integer sums)."""
    solos, sinks = [], []
    cluster = SessionCluster(quantum_records=1024,
                             arbiter=ShardArbiter(8),
                             arbitrate_every_s=0.001)
    for name, seed in (("a", 5), ("b", 9)):
        solo = CollectSink()
        _pipeline("t", solo, n=40_000, seed=seed).execute("solo")
        solos.append(solo)
        sinks.append(CollectSink())
        cluster.submit(_pipeline("t", sinks[-1], n=40_000, seed=seed), name)
    cluster.run(timeout_s=180)
    for sink, solo in zip(sinks, solos):
        assert _rows(sink) == _rows(solo)
    assert all(j.rescale_errors == 0 for j in cluster.jobs.values())
    assert sum(j.rescales_served for j in cluster.jobs.values()) >= 1
    # without a tick the arbiter is held, never consulted
    SessionCluster(arbiter=ShardArbiter(8))


def test_arbitrate_tick_posts_rescale_and_harvests_refusal():
    """One ``_arbitrate`` tick on running jobs in both packages: the
    job's shard ceiling is LOGICAL (the stated default 8, as the
    reference's 8 virtual devices give), the decision posts a
    ``RescaleRequest`` on the job's control queue, the executor SERVES it
    at the next batch boundary (2 -> 1 shards, the same rows moved as the
    reference's), the next tick harvests it with ``rescale_errors`` 0,
    and the job finishes equal to its solo run."""
    class Fixed:
        def __init__(self):
            self.calls = []

        def decide(self, demands, dead_shards=0):
            self.calls.append([(d.job, d.current_shards, d.max_shards)
                               for d in demands])
            return {d.job: 1 for d in demands}

    solo = CollectSink()
    _pipeline("t", solo, n=60_000).execute("solo")
    reports = []
    for pkg, make, sink_cls in (("t", SessionCluster, CollectSink),
                                ("j", JCluster, JCollectSink)):
        sink = sink_cls()
        cluster = make(quantum_records=1024)
        cluster.submit(_pipeline(pkg, sink, n=60_000), "grow")
        cluster.arbiter = Fixed()
        cluster.step_round()
        cluster._arbitrate()
        assert cluster.arbiter.calls[0] == [("grow", 2, 8)]
        req = cluster.jobs["grow"]._pending_rescale
        assert req is not None and req.new_shards == 1
        for _ in range(50):  # a round may leave the job no DRR credit
            cluster.step_round()
            if req._done.is_set():
                break
        reports.append(req.wait(5))
        cluster._arbitrate()
        assert cluster.jobs["grow"].rescale_errors == 0
        if pkg == "t":
            assert cluster.jobs["grow"].rescales_served == 1
        cluster.run(timeout_s=120)
        assert _rows(sink) == _rows(solo)
    got, want = reports
    assert (got["from"], got["to"]) == (want["from"], want["to"]) == (2, 1)
    assert got["rows_moved"] == want["rows_moved"]


# ------------------------------------------------- run_stepwise / JobHandle


def test_run_stepwise_yields_handle_then_records():
    sink, sink2 = CollectSink(), CollectSink()
    env = _pipeline("t", sink, n=20_000)
    gen = LocalExecutor(env.config).run_stepwise(
        env.get_stream_graph(), "step", cooperative=True)
    handle = next(gen)
    assert isinstance(handle, JobHandle)
    ops = handle.stateful_operators()
    assert len(ops) == 1 and handle.busy_ms() >= 0.0
    total, steps = 0, 0
    try:
        while True:
            n = next(gen)
            assert isinstance(n, int) and n >= 0
            total += n
            steps += 1
            if total and steps % 3 == 0:
                assert handle.resident_rows() >= 0
                assert handle.backlog_records() >= 0
    except StopIteration as done:
        result = done.value
    assert total == 20_000 == result.metrics["records_emitted_by_sources"]
    _pipeline("t", sink2, n=20_000).execute("ref")
    assert _rows(sink) == _rows(sink2)


def test_closing_stepwise_run_releases_like_a_failure():
    """``close()`` mid-run takes the failure path: pumps stop, operators
    are disposed, queued control requests fail."""
    sink = CollectSink()
    env = _pipeline("t", sink, n=60_000)
    control = _q.Queue()
    gen = LocalExecutor(env.config).run_stepwise(
        env.get_stream_graph(), "closed", control_queue=control,
        cooperative=True)
    handle = next(gen)
    next(gen)
    req = StateQueryBatchRequest(OP, [1])
    control.put(req)
    gen.close()
    with pytest.raises(RuntimeError, match="terminated abnormally"):
        req.wait(5)
    assert all(not p._thread.is_alive() for p in handle.pumps.values())
    with pytest.raises(StopIteration):
        next(gen)


# ------------------------------------------------------------- two-job chaos


def _chaos_steps(seed, n_steps=8, batch=256, keys=120):
    rng = np.random.default_rng(seed)
    steps, t = [], 0
    for _ in range(n_steps):
        ks = rng.integers(0, keys, batch)
        ts = t + np.sort(rng.integers(0, 400, batch))
        t += 700
        steps.append((ks, np.ones(batch, dtype=np.float32), ts, t - 2 * GAP))
    return steps


def _makers(pkg):
    if pkg == "t":
        mesh = make_mesh(2, "cpu")
        return (lambda: MeshSessionEngine(
                    GAP, tagg.SumAggregate("v"), mesh,
                    capacity_per_shard=1024, max_device_slots=1024),
                lambda: SessionWindower(GAP, tagg.SumAggregate("v"),
                                        capacity=1 << 15,
                                        spill={"device": "cpu"}))
    mesh = jmake_mesh(2)
    return (lambda: JSess(GAP, jagg.SumAggregate("v"), mesh,
                          capacity_per_shard=1024, max_device_slots=1024),
            lambda: JSessW(GAP, jagg.SumAggregate("v"), capacity=1 << 15))


def _multi(pkg, rules, seed, tmp, steps_seeds, serve, every=2):
    mk, mo = _makers(pkg)
    h, c = (harness, chaos) if pkg == "t" else (jharness, jchaos)
    plan = c.FaultPlan(rules=[c.FaultRule(**r) for r in rules])
    return h.run_crash_restore_verify_multi(
        make_engines={"a": mk, "b": mk}, make_oracles={"a": mo, "b": mo},
        steps_by_job={"a": _chaos_steps(steps_seeds[0]),
                      "b": _chaos_steps(steps_seeds[1])},
        plan=plan, seed=seed, ckpt_root=os.path.join(tmp, pkg),
        checkpoint_every=every, serve_keys=serve)


def _same_reports(got, want):
    for j in ("a", "b"):
        g, w = got[j], want[j]
        for f in ("crashes", "restores", "cold_restarts",
                  "corrupt_checkpoints_skipped", "checkpoints_written",
                  "windows", "retries", "recoveries", "faults_injected"):
            assert getattr(g, f) == getattr(w, f), (j, f)
        assert not g.diverged


def test_crash_mid_serving_burst_restores_jobs_independently(tmp_path):
    rules = [dict(pattern="mesh.session_fire", nth=6)]
    serve = {"a": [1, 2, 3], "b": [4, 5, 6]}
    got = _multi("t", rules, 5, str(tmp_path), (1, 2), serve)
    want = _multi("j", rules, 5, str(tmp_path), (1, 2), serve)
    _same_reports(got, want)
    crashed = sorted(j for j, r in got.items() if r.crashes)
    assert len(crashed) == 1
    other = "a" if crashed == ["b"] else "b"
    assert got[crashed[0]].restores >= 1 and got[other].restores == 0


def test_serving_lookup_fault_retries_without_corruption(tmp_path):
    rules = [dict(pattern="serving.lookup", nth=2, recoverable=True)]
    serve = {"a": [1, 2], "b": [3, 4]}
    got = _multi("t", rules, 9, str(tmp_path), (3, 4), serve)
    want = _multi("j", rules, 9, str(tmp_path), (3, 4), serve)
    _same_reports(got, want)
    carrying = [j for j, r in got.items()
                if r.faults_injected.get("serving.lookup", 0)]
    assert len(carrying) == 1
    assert sum(r.recoveries for r in got.values()) >= 1
    for r in got.values():
        assert r.crashes == 0


def test_torn_checkpoint_skip_counted_per_job(tmp_path):
    rules = [dict(pattern="checkpoint.write.torn", nth=1, kind="drop"),
             dict(pattern="serving.lookup", nth=3, where={"job": "a"})]
    serve = {"a": [1, 2], "b": [3, 4]}
    got = _multi("t", rules, 13, str(tmp_path), (5, 6), serve)
    want = _multi("j", rules, 13, str(tmp_path), (5, 6), serve)
    _same_reports(got, want)
    ra, rb = got["a"], got["b"]
    assert ra.crashes == 1 and ra.corrupt_checkpoints_skipped >= 1
    assert ra.cold_restarts == 1
    assert rb.crashes == 0 and rb.corrupt_checkpoints_skipped == 0
    assert ra.points_hit.get("checkpoint.write", 0) > \
        rb.points_hit.get("checkpoint.write", 0)


def test_serving_lookup_fault_via_executor_control_plane():
    sink = CollectSink()
    env = _pipeline("t", sink, n=60_000, keys=8, window=1 << 40,
                    extra={"serving.replica": False})
    cluster = SessionCluster(quantum_records=1024)
    cluster.submit(env, "qs")
    plan = FaultPlan(rules=[FaultRule(pattern="serving.lookup", nth=1,
                                      recoverable=True,
                                      where={"job": "qs"})])
    got = {}

    def client():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                out = cluster.lookup_batch("qs", OP, [3, 5])
            except RuntimeError:
                return
            if all(out):
                got["out"] = out
                return
            time.sleep(0.01)

    with chaos.chaos_active(plan, seed=1) as ctl:
        t = threading.Thread(target=client)
        t.start()
        cluster.run(timeout_s=120)
        t.join(timeout=30)
        assert ctl.faults_injected.get("serving.lookup", 0) >= 1
        assert ctl.retries >= 1
    assert "out" in got
    for per_key in got["out"]:
        (ns, cols), = per_key.items()
        assert cols["sum_value"] > 0


# ----------------------------------------------------------------- package


def test_every_tenancy_name_resolves_lookup_router_names_12h():
    import flink_tpu_torch.tenancy as ten

    for name in ten._LAZY:
        assert getattr(ten, name) is not None, name
    # item 12h is ported: LookupRouter resolves like the other names
    from flink_tpu_torch.tenancy.frontend import LookupRouter

    assert ten.LookupRouter is LookupRouter
    with pytest.raises(AttributeError):
        ten.NoSuchName
