"""The pod data plane of the port (``flink_tpu_torch/parallel/mesh.py``
``HostTopology``, ``parallel/exchange2.py``, ``parallel/pod.py``) against
the reference's (``tests/test_pod_exchange.py``), on the CPU.

The reference runs on the 8 virtual devices of ``tests/conftest.py`` with
a virtual 2x4 (or 2x2) topology; the port on a logical mesh of as many
shards, where the hosts axis is a second transpose on one device. Pinned:

- topology validation, the ``(hosts, local)`` view, and the stable host ->
  key-group-range map (``host_key_group_ranges``) equal to the
  reference's;
- two-level staging (layout, per-level tiers, traffic split and the
  ``exchange.dcn_send`` faults) equal to the reference's array by array;
- the two stages' programs: stage 1's intermediate columns and stage 2's
  folded planes equal to the reference's programs' bit for bit (float32
  Sum of random values: the stream-order fold);
- window, valued-window and session fires through the two-level
  exchange, the flat exchange and host bucketing, the port against the
  reference's two-level run, bit for bit;
- the join's two-level path against the flat one and the reference's,
  and the refusal of a host-backend join under a topology;
- ``shuffle.hosts`` through ``OperatorContext`` and ``env.execute()``;
- ``PodDataPlane`` in one process: exact rows in global stream order,
  64-bit columns bit-exact, equal to the reference plane's arrivals; the
  rank at D = H equal to the reference's one-hot cumsum.

Tolerance: none; floats are compared on their bits.
"""

import numpy as np
import pytest
import torch

import flink_tpu.parallel.mesh as jmesh
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.parallel import exchange2 as tx2
from flink_tpu_torch.parallel.mesh import (
    HostTopology,
    make_mesh,
    pod_mesh_view,
    process_topology,
)
from flink_tpu_torch.state import keygroups as tkg
from flink_tpu_torch.windowing import aggregates as tagg

GAP = 100
_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def _batch(cls, keys, vals, ts):
    return cls.from_pydict({KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
                            "v": np.asarray(vals, dtype=np.float32)},
                           timestamps=np.asarray(ts, dtype=np.int64))


def _fired(batches, field="sum_v"):
    """{(key, start, end): value bits}: fires compared bit for bit."""
    out = {}
    for b in batches:
        keys = np.asarray(b[KEY_ID_FIELD])
        vals = _bits(np.asarray(b[field]))
        for k, s, e, v in zip(keys.tolist(), b["window_start"].tolist(),
                              b["window_end"].tolist(), vals.tolist()):
            out[(k, s, e)] = v
    return out


def _stream(num_keys=20_000, n_steps=5, per_step=4000, seed=11):
    """Beyond a 1024-row budget a shard: the session engine evicts. Float
    values, so only the same fold order gives the same bits."""
    rng = np.random.default_rng(seed)
    steps = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        vals = rng.random(per_step).astype(np.float32)
        ts = rng.integers(s * 80, s * 80 + 60, per_step).astype(np.int64)
        steps.append((keys, vals, ts, (s - 1) * 80))
    steps.append((np.array([0], dtype=np.int64),
                  np.array([0.0], dtype=np.float32),
                  np.array([n_steps * 80 + 10_000], dtype=np.int64),
                  10 ** 9))
    return steps


def _run(engine, steps, cls):
    fired = []
    for keys, vals, ts, wm in steps:
        engine.process_batch(_batch(cls, keys, vals, ts))
        fired.extend(engine.on_watermark(wm))
    return fired


def _session_engine(pkg, **kw):
    if pkg == "ref":
        from flink_tpu.parallel.sharded_sessions import MeshSessionEngine

        if "host_topology" in kw:
            kw["host_topology"] = jmesh.HostTopology(*kw["host_topology"])
        return MeshSessionEngine(GAP, jagg.SumAggregate("v"),
                                 jmesh.make_mesh(8),
                                 capacity_per_shard=1 << 14,
                                 max_device_slots=1024, **kw)
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine

    if "host_topology" in kw:
        kw["host_topology"] = HostTopology(*kw["host_topology"])
    return MeshSessionEngine(GAP, tagg.SumAggregate("v"),
                             make_mesh(8, "cpu"),
                             capacity_per_shard=1 << 14,
                             max_device_slots=1024, **kw)


def _window_engine(pkg, **kw):
    if pkg == "ref":
        from flink_tpu.parallel.sharded_windower import MeshWindowEngine
        from flink_tpu.windowing.assigners import TumblingEventTimeWindows

        if "host_topology" in kw:
            kw["host_topology"] = jmesh.HostTopology(*kw["host_topology"])
        return MeshWindowEngine(TumblingEventTimeWindows.of(50),
                                jagg.SumAggregate("v"), jmesh.make_mesh(8),
                                capacity_per_shard=1 << 14, **kw)
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    if "host_topology" in kw:
        kw["host_topology"] = HostTopology(*kw["host_topology"])
    return MeshWindowEngine(TumblingEventTimeWindows.of(50),
                            tagg.SumAggregate("v"), make_mesh(8, "cpu"),
                            capacity_per_shard=1 << 14, **kw)


# ------------------------------------------------------------------ mesh


def test_topology_validation_matches_the_reference():
    for cls in (HostTopology, jmesh.HostTopology):
        with pytest.raises(ValueError):
            cls(0, 4)
        t = cls(2, 4)
        assert t.num_shards == 8
        assert t.host_of_shard(0) == 0 and t.host_of_shard(7) == 1
        assert list(t.shards_of_host(1)) == [4, 5, 6, 7]
        with pytest.raises(ValueError):
            t.shards_of_host(2)
        t.check_covers(8)
        with pytest.raises(ValueError, match="does not cover"):
            t.check_covers(6)


def test_pod_mesh_view_and_process_topology():
    assert pod_mesh_view(make_mesh(8, "cpu"), HostTopology(2, 4)) == (2, 4)
    with pytest.raises(ValueError, match="does not cover"):
        pod_mesh_view(make_mesh(8, "cpu"), HostTopology(2, 3))
    # no process group: one host, the local count the caller's (logical
    # shards, never the card count)
    assert process_topology(4) == HostTopology(1, 4)


@pytest.mark.parametrize("make", [_session_engine, _window_engine],
                         ids=["sessions", "windows"])
def test_engine_rejects_a_noncovering_topology(make):
    for pkg in ("ref", "port"):
        with pytest.raises(ValueError, match="does not cover"):
            make(pkg, host_topology=(2, 3))


# ------------------------------------------------------- key-group ranges


def test_host_key_group_ranges_equal_the_references():
    from flink_tpu.state import keygroups as jkg

    for mp in (128, 100, 11):
        for h, l in ((2, 4), (4, 2), (3, 2)):
            if h * l > mp:
                continue
            ranges = tkg.host_key_group_ranges(h, l, mp)
            assert ranges == jkg.host_key_group_ranges(h, l, mp)
            assert ranges[0][0] == 0 and ranges[-1][1] == mp - 1
            for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
                assert b0 == a1 + 1
            sub = (10, mp - 1)
            assert tkg.host_key_group_ranges(h, l, mp, sub) == \
                jkg.host_key_group_ranges(h, l, mp, sub)
    sr = tkg.shard_key_group_ranges(8, 128)
    assert tkg.host_key_group_ranges(2, 4, 128) == [
        (sr[0][0], sr[3][1]), (sr[4][0], sr[7][1])]
    groups = np.arange(100, dtype=np.int64)
    owners = tkg.host_of_key_group(groups, 2, 4, 100)
    for h, (g0, g1) in enumerate(tkg.host_key_group_ranges(2, 4, 100)):
        assert (owners[g0:g1 + 1] == h).all()


def test_range_helpers_equal_the_references():
    from flink_tpu.state import keygroups as jkg

    for mp, par in ((128, 8), (100, 3), (7, 7)):
        got = tkg.all_ranges(mp, par)
        want = jkg.all_ranges(mp, par)
        assert [(r.start, r.end) for r in got] == \
            [(r.start, r.end) for r in want]
        a, b = got[0], got[-1]
        ja, jb = want[0], want[-1]
        assert (a.intersect(b).start, a.intersect(b).end,
                a.intersect(b).empty) == \
            (ja.intersect(jb).start, ja.intersect(jb).end,
             ja.intersect(jb).empty)
    for bad in (0, 1 << 16):
        for fn in (tkg.validate_max_parallelism,
                   jkg.validate_max_parallelism):
            with pytest.raises(ValueError, match="32768"):
                fn(bad)
    tkg.validate_max_parallelism(128)


# --------------------------------------------------------------- staging


def _staging_case(seed=3, n=900, P=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, P, n).astype(np.int64),
            rng.integers(1, 64, n).astype(np.int32),
            rng.random(n).astype(np.float32))


@pytest.mark.parametrize("hosts,local", [(2, 2), (2, 4), (4, 2)])
def test_staging_equals_the_references(hosts, local):
    from flink_tpu.parallel import exchange2 as jx2

    shards, slots, vals = _staging_case(P=hosts * local, n=3000)
    got_tr, want_tr = tx2.ExchangeTraffic(), jx2.ExchangeTraffic()
    got = tx2.stage_two_level_exchange(
        shards, HostTopology(hosts, local), columns=[slots, vals],
        fills=[0, 0.0], traffic=got_tr)
    want = jx2.stage_two_level_exchange(
        shards, jmesh.HostTopology(hosts, local), columns=[slots, vals],
        fills=[0, 0.0], traffic=want_tr)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert got[2:] == want[2:]
    assert got_tr.as_dict() == want_tr.as_dict()
    w1, w2 = got[2], got[3]
    assert w1 & (w1 - 1) == 0 and w2 & (w2 - 1) == 0
    assert w2 <= local * w1


def test_traffic_split_accounting():
    tr = tx2.ExchangeTraffic()
    # C = 256: records 0..3 are chunk 0 (host 0); 3 stay, 1 crosses
    tx2.stage_two_level_exchange(np.array([0, 1, 0, 2], dtype=np.int64),
                                 HostTopology(2, 2),
                                 columns=[np.ones(4, np.int32)], fills=[0],
                                 traffic=tr)
    assert tr.as_dict() == {"rows_intra_host": 3, "rows_cross_host": 1,
                            "exchange2_batches": 1}
    assert tx2.ExchangeTraffic.dict_of(None) == {
        "rows_intra_host": 0, "rows_cross_host": 0, "exchange2_batches": 0}
    assert tx2.two_level_active(HostTopology(2, 2), "device")
    assert not tx2.two_level_active(HostTopology(2, 2), "host")
    assert not tx2.two_level_active(HostTopology(1, 4), "device")


@pytest.mark.parametrize("kind", ["drop", "duplicate"])
def test_dcn_send_faults_equal_the_references(kind):
    from flink_tpu.chaos import injection as jchaos
    from flink_tpu.parallel import exchange2 as jx2

    shards, slots, vals = _staging_case(seed=5, P=8, n=4000)
    out = {}
    for pkg, chaos, x2, topo in (
            ("port", tchaos, tx2, HostTopology(2, 4)),
            ("ref", jchaos, jx2, jmesh.HostTopology(2, 4))):
        plan = chaos.FaultPlan(rules=[chaos.FaultRule(
            pattern="exchange.dcn_send", kind=kind, nth=1,
            where={"src_host": 0, "dst_host": 1})])
        with chaos.chaos_active(plan, seed=3) as ctl:
            out[pkg] = x2.stage_two_level_exchange(
                shards, topo, columns=[slots, vals], fills=[0, 0.0])
            out[pkg + "_hits"] = dict(ctl.points_hit)
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    for g, w in zip(out["port"][1], out["ref"][1]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert out["port"][2:] == out["ref"][2:]
    assert out["port_hits"] == out["ref_hits"]
    clean = tx2.stage_two_level_exchange(
        shards, HostTopology(2, 4), columns=[slots, vals], fills=[0, 0.0])
    assert not np.array_equal(out["port"][0], clean[0])


# ---------------------------------------------------- the stage programs


@pytest.mark.parametrize("hosts,local", [(2, 4), (4, 2)])
def test_stage_programs_equal_the_references(hosts, local):
    """Stage 1's intermediate columns and stage 2's folded planes (float32
    Sum and Count of random values, random slots with collisions) equal
    the reference's programs bit for bit."""
    import jax

    from flink_tpu.parallel import exchange2 as jx2
    from flink_tpu.parallel.mesh import KEY_AXIS
    from jax.sharding import NamedSharding, PartitionSpec

    P, cap = hosts * local, 64
    rng = np.random.default_rng(7)
    n = 5000
    shards = rng.integers(0, P, n).astype(np.int64)
    slots = rng.integers(1, cap, n).astype(np.int32)
    vals = (rng.random(n) * 100).astype(np.float32)
    out = {}
    for pkg in ("port", "ref"):
        agg = (tagg if pkg == "port" else jagg).MultiAggregate(
            [(tagg if pkg == "port" else jagg).SumAggregate("v"),
             (tagg if pkg == "port" else jagg).CountAggregate()])
        x2 = tx2 if pkg == "port" else jx2
        topo = (HostTopology if pkg == "port"
                else jmesh.HostTopology)(hosts, local)
        dst, staged, w1, w2 = x2.stage_two_level_exchange(
            shards, topo, columns=[slots, vals],
            fills=[0, agg.leaves[0].identity])
        accs0 = [np.full((P, cap), l.identity, dtype=l.dtype)
                 for l in agg.leaves]
        if pkg == "port":
            mesh = make_mesh(P, "cpu")
            s1, s2 = tx2.build_exchange2_steps(mesh, topo, agg)
            t = [torch.from_numpy(c) for c in (dst, *staged)]
            inter = s1(t[0], t[1], tuple(t[2:]), w1)
            accs = s2(tuple(torch.from_numpy(a.copy()) for a in accs0),
                      inter[0], inter[1], tuple(inter[2:]), w2)
            out[pkg] = ([np.asarray(x) for x in inter],
                        [np.asarray(a) for a in accs])
        else:
            mesh = jmesh.make_mesh(P)
            sh = NamedSharding(mesh, PartitionSpec(KEY_AXIS))
            s1, s2 = jx2.build_exchange2_steps(mesh, topo, agg)
            put = jax.device_put((dst, *staged), sh)
            inter = s1(put[0], put[1], tuple(put[2:]), w1)
            inter_h = [np.asarray(x).reshape(P, -1) for x in inter]
            accs = s2(tuple(jax.device_put(a, sh) for a in accs0),
                      inter[0], inter[1], tuple(inter[2:]), w2)
            out[pkg] = (inter_h, [np.asarray(a) for a in accs])
    for g, w in zip(out["port"][0], out["ref"][0]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for g, w in zip(out["port"][1], out["ref"][1]):
        np.testing.assert_array_equal(_bits(g), _bits(w))


# ------------------------------------------------- engine bit-identity


def test_sessions_two_level_vs_flat_vs_host_vs_reference():
    steps = _stream()
    want_eng = _session_engine("ref", host_topology=(2, 4))
    want = _fired(_run(want_eng, steps, JRecordBatch))
    for name, kw in (("flat", {}), ("two", {"host_topology": (2, 4)}),
                     ("host", {"shuffle_mode": "host"})):
        eng = _session_engine("port", **kw)
        assert _fired(_run(eng, steps, RecordBatch)) == want, name
        if name == "two":
            tr = eng.exchange2_traffic()
            assert tr == want_eng.exchange2_traffic()
            assert tr["rows_cross_host"] > 0 and tr["rows_intra_host"] > 0
            assert eng.spill_counters()["rows_evicted"] > 0
    assert len(want) > 1000


def test_windows_two_level_vs_flat_vs_host_vs_reference():
    steps = _stream()
    want = _fired(_run(_window_engine("ref", host_topology=(2, 4)), steps,
                       JRecordBatch))
    for name, kw in (("flat", {}), ("two", {"host_topology": (2, 4)}),
                     ("host", {"shuffle_mode": "host"})):
        got = _fired(_run(_window_engine("port", **kw), steps, RecordBatch))
        assert got == want, name


def test_windows_valued_two_level_path():
    """Two-phase partial batches (the valued exchange) through the
    two-level program, the flat one and host bucketing == the
    reference's two-level run."""
    from flink_tpu.runtime.local_agg import PARTIAL_LEAF_PREFIX as JPRE
    from flink_tpu_torch.runtime.local_agg import PARTIAL_LEAF_PREFIX

    steps = _stream(per_step=3000, n_steps=4)

    def run(pkg, **kw):
        eng = _window_engine(pkg, **kw)
        cls, pre = ((RecordBatch, PARTIAL_LEAF_PREFIX) if pkg == "port"
                    else (JRecordBatch, JPRE))
        fired = []
        for keys, vals, ts, wm in steps:
            eng.process_batch(_batch(cls, keys, vals, ts)
                              .with_column(pre + "0", vals))
            fired.extend(eng.on_watermark(wm))
        return _fired(fired)

    want = run("ref", host_topology=(2, 4))
    assert run("port", host_topology=(2, 4)) == want
    assert run("port") == want
    assert run("port", shuffle_mode="host") == want


def test_single_host_topology_keeps_the_flat_path():
    eng = _session_engine("port", host_topology=(1, 8))
    assert not eng._two_level_active()
    steps = _stream(per_step=1000, n_steps=3)
    assert _fired(_run(eng, steps, RecordBatch)) == \
        _fired(_run(_session_engine("port"), steps, RecordBatch))
    assert eng.exchange2_traffic()["exchange2_batches"] == 0


def test_reshard_drops_the_stale_topology():
    eng = _session_engine("port", host_topology=(2, 4))
    steps = _stream(per_step=1000, n_steps=3)
    oracle = _fired(_run(_session_engine("port"), steps, RecordBatch))
    fired = []
    for i, (keys, vals, ts, wm) in enumerate(steps):
        if i == 2:
            eng.reshard(4)
            assert eng.host_topology is None
        eng.process_batch(_batch(RecordBatch, keys, vals, ts))
        fired.extend(eng.on_watermark(wm))
    assert _fired(fired) == oracle


def test_the_two_level_programs_are_shared():
    a = _session_engine("port", host_topology=(2, 4))
    b = _session_engine("port", host_topology=(2, 4))
    assert a._exchange2_steps[0] is b._exchange2_steps[0]
    assert a._exchange2_steps[1] is b._exchange2_steps[1]


# ------------------------------------------------------------------ joins


def _join_steps(cls, n_steps=5, per_step=600, seed=5):
    rng = np.random.default_rng(seed)
    steps = []
    for s in range(n_steps):
        keys = rng.integers(0, 500, per_step).astype(np.int64)
        ts = rng.integers(s * 50, s * 50 + 45, per_step).astype(np.int64)
        vals = rng.random(per_step).astype(np.float32)
        steps.append((cls({KEY_ID_FIELD: keys, "v": vals,
                           TIMESTAMP_FIELD: ts}), (s - 1) * 50))
    return steps


def _run_join(pkg, topology):
    if pkg == "ref":
        from flink_tpu.joins import MeshIntervalJoinEngine

        eng = MeshIntervalJoinEngine(
            -40, 40, mesh=jmesh.make_mesh(8), capacity_per_shard=4096,
            host_topology=(jmesh.HostTopology(*topology) if topology
                           else None))
        cls = JRecordBatch
    else:
        from flink_tpu_torch.joins import MeshIntervalJoinEngine

        eng = MeshIntervalJoinEngine(
            -40, 40, num_shards=8, device="cpu", capacity_per_shard=4096,
            host_topology=HostTopology(*topology) if topology else None)
        cls = RecordBatch
    rows = []
    for b, wm in _join_steps(cls):
        left = np.arange(len(b)) % 2 == 0
        eng.process_batch(b.filter(left), 0)
        eng.process_batch(b.filter(~left), 1)
        for ob in eng.on_watermark(wm):
            rows.extend(tuple(sorted((k, _bits(np.asarray(v)).item())
                                     for k, v in r.items()))
                        for r in ob.to_rows())
    return eng, rows


def test_interval_join_two_level_equals_flat_and_the_reference():
    _, flat = _run_join("port", None)
    eng, two = _run_join("port", (2, 4))
    want_eng, want = _run_join("ref", (2, 4))
    assert two == flat == want  # values AND emission order
    assert eng.exchange2_traffic() == want_eng.exchange2_traffic()
    assert eng.exchange2_traffic()["rows_cross_host"] > 0


def test_join_rejects_a_host_backend_topology():
    from flink_tpu.joins import MeshIntervalJoinEngine as JEngine
    from flink_tpu_torch.joins import MeshIntervalJoinEngine

    with pytest.raises(ValueError, match="device backend"):
        MeshIntervalJoinEngine(-40, 40, backend="host", num_shards=8,
                               host_topology=HostTopology(2, 4))
    with pytest.raises(ValueError, match="device backend"):
        JEngine(-40, 40, backend="host", num_shards=8,
                host_topology=jmesh.HostTopology(2, 4))


# ---------------------------------------------------------------- wiring


def test_ctx_host_topology_reaches_the_engine():
    """``shuffle.hosts`` (an int through ``OperatorContext``) factors the
    engine's shard count; a count that cannot factor it keeps the flat
    exchange, as the reference's ``_ctx_topology`` does."""
    from flink_tpu_torch.runtime.operators import (
        OperatorContext,
        SessionWindowAggOperator,
    )

    op = SessionWindowAggOperator(gap=GAP, agg=tagg.SumAggregate("v"),
                                  key_field="k")
    op.open(OperatorContext(parallelism=8, device="cpu", host_topology=2))
    t = op.windower.host_topology
    assert t == HostTopology(2, 4) and t.num_shards == op.windower.P
    op2 = SessionWindowAggOperator(gap=GAP, agg=tagg.SumAggregate("v"),
                                   key_field="k")
    op2.open(OperatorContext(parallelism=8, device="cpu", host_topology=5))
    assert op2.windower.host_topology is None


@pytest.mark.parametrize("stage", [0, 2], ids=["local", "stage"])
def test_executor_config_arms_the_two_level_exchange(stage):
    """A job with ``shuffle.hosts=2`` at parallelism 8 gives the flat
    run's rows and the reference's, through the single-slot executor and
    through the stage executor (a 4-shard engine a subtask: 2x2)."""
    import flink_tpu
    import flink_tpu_torch

    rng = np.random.default_rng(3)
    n = 4000
    rows = [{"k": int(k), "v": float(v), "t": int(t)}
            for k, v, t in zip(rng.integers(0, 500, n),
                               rng.random(n).astype(np.float32),
                               rng.integers(0, 400, n))]

    def run(top, hosts):
        conf = {"parallelism.default": 8}
        if stage:
            conf.update({"execution.stage-parallelism": stage,
                         "execution.stage-mesh-devices": 4,
                         "execution.local-agg": False})
        if hosts:
            conf["shuffle.hosts"] = hosts
        if top is flink_tpu_torch:
            conf["execution.device"] = "cpu"
        env = top.StreamExecutionEnvironment(top.Configuration(conf))
        asg = __import__(f"{top.__name__}.windowing.assigners",
                         fromlist=["x"])
        agg = __import__(f"{top.__name__}.windowing.aggregates",
                         fromlist=["x"])
        sink = __import__(f"{top.__name__}.connectors.sinks",
                          fromlist=["x"]).CollectSink()
        (env.from_collection(rows, timestamp_field="t").key_by("k")
         .window(asg.TumblingEventTimeWindows.of(100))
         .aggregate(agg.SumAggregate("v")).sink_to(sink))
        env.execute("hosts")
        return sorted((r["k"], r["window_start"],
                       _bits(np.float32(r["sum_v"])).item())
                      for r in sink.rows())

    got = run(flink_tpu_torch, 2)
    assert got == run(flink_tpu_torch, 0) == run(flink_tpu, 2)
    assert len(got) > 100


# -------------------------------------------------------------- pod plane


def test_pod_plane_routes_to_the_owner_in_stream_order():
    from flink_tpu.parallel.pod import PodDataPlane as JPlane
    from flink_tpu_torch.parallel.pod import PodDataPlane

    plane = PodDataPlane(HostTopology(2, 4),
                         dtypes=[np.int64, np.int64, np.float32],
                         device="cpu")
    jplane = JPlane(jmesh.HostTopology(2, 4),
                    dtypes=[np.int64, np.int64, np.float32],
                    mesh=jmesh.make_mesh(8))
    rng = np.random.default_rng(0)
    n = 3000
    keys = rng.integers(0, 1 << 62, n)           # full-width identities
    ts = rng.integers(0, 1000, n)
    vals = rng.normal(size=n).astype(np.float32)
    owners = tkg.host_of_key_group(tkg.assign_key_groups(keys, 128),
                                   2, 4, 128)
    got = plane.exchange(owners, [keys, ts, vals])
    want = jplane.exchange(owners, [keys, ts, vals])
    total = 0
    for h in (0, 1):
        sel = owners == h
        for g, w, src in zip(got[h], want[h], (keys, ts, vals)):
            np.testing.assert_array_equal(_bits(g), _bits(src[sel]))
            np.testing.assert_array_equal(_bits(g), _bits(w))
        total += len(got[h][0])
    assert total == n
    assert (plane.rows_cross_host, plane.rows_intra_host) == \
        (jplane.rows_cross_host, jplane.rows_intra_host)
    assert plane.rows_cross_host > 0 and plane.rows_intra_host > 0


def test_pod_plane_chunk_bound_skips_the_agree_step():
    from flink_tpu_torch.parallel.pod import PodDataPlane

    plane = PodDataPlane(HostTopology(2, 2), dtypes=[np.int64],
                         device="cpu")
    out = plane.exchange(np.array([0, 1, 1, 0]),
                         [np.arange(4, dtype=np.int64)], chunk_bound=1)
    np.testing.assert_array_equal(out[0][0], [0, 3])
    np.testing.assert_array_equal(out[1][0], [1, 2])


def test_pod_route_rank_is_the_references_one_hot_cumsum():
    """The reference's route ranks with a one-hot cumsum; the port's with
    ``exchange_rank_flat`` at D = H (the rank kernel on the card). The
    bucket offsets are equal, padding and overflow lanes included."""
    from flink_tpu_torch.parallel.pod import build_pod_route

    H, W = 3, 16
    rng = np.random.default_rng(4)
    d = rng.integers(0, H + 1, (4, 40)).astype(np.int32)  # H = padding
    oh = (d[..., None] == np.arange(H)).astype(np.int32)
    rank = np.cumsum(oh, axis=1) - oh
    rank_d = np.take_along_axis(rank, np.clip(d, 0, H - 1)[..., None],
                                axis=2)[..., 0]
    flat = np.where((d < H) & (rank_d < W), d * W + rank_d, H * W)
    route = build_pod_route(HostTopology(H, 2))
    vals = torch.arange(d.size, dtype=torch.int64).view(d.shape)
    dst_b, val_b = route(torch.from_numpy(d), [vals], W)
    want = np.full((4, H * W + 1), -1, dtype=np.int64)
    np.put_along_axis(want, flat, vals.numpy(), axis=1)
    got = val_b.reshape(4, H * W).numpy()
    keep = want[:, :H * W] >= 0
    np.testing.assert_array_equal(got[keep], want[:, :H * W][keep])
    assert (dst_b.reshape(4, H * W).numpy()[~keep] == H).all()
