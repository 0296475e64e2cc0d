"""Scale-out and skew (ROADMAP item 12g) of the port against the
reference on the CPU: the key-group assignment, the load accountant, the
rebalance policy and skew responder, live rebalance of the mesh window
and session engines, and hot-key splitting.

The reference's engines run on the 8 virtual devices of
``tests/conftest.py`` (meshes of 4 or 8), the port's on logical meshes of
the same size with ``device="cpu"``. Every engine case drives both
packages with the same numpy-seeded batches and watermarks and holds the
fired batches equal IN ORDER, every column bit for bit (no tolerance:
the values are integer-valued float32, so even a salted float Sum folds
exactly, and both packages salt and fold in the same order). Query
answers compare as equal dicts; routing tables, plans, candidates and
rates compare exactly.
"""

import numpy as np
import pytest

from flink_tpu.autoscale import (
    RebalancePolicy as JRebalancePolicy,
    SkewResponder as JSkewResponder,
)
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.parallel.load import ShardLoadAccountant as JAccountant
from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_tpu.parallel.sharded_sessions import (
    MeshSessionEngine as JSessionEngine,
)
from flink_tpu.parallel.sharded_windower import (
    MeshWindowEngine as JWindowEngine,
)
from flink_tpu.parallel.shuffle import shard_records as jshard_records
from flink_tpu.state.keygroups import (
    KeyGroupAssignment as JAssignment,
    host_of_key_group as jhost_of_key_group,
)
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing.assigners import (
    TumblingEventTimeWindows as JTumbling,
)
from flink_tpu_torch.autoscale import RebalancePolicy, SkewResponder
from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
from flink_tpu_torch.parallel.load import ShardLoadAccountant
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import (
    MAX_SALTS,
    MeshSessionEngine,
)
from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
from flink_tpu_torch.parallel.shuffle import shard_records
from flink_tpu_torch.state.keygroups import (
    KeyGroupAssignment,
    host_of_key_group,
)
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

GAP = 100
HOT = 7
_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def assert_batches_equal(got, want):
    """Fired batches equal in order, every column bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g.names()) == sorted(w.names())
        for name in w.names():
            a, b = np.asarray(g[name]), np.asarray(w[name])
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _stream(num_keys=6_000, n_steps=8, per_step=2_500, seed=31,
            hot_frac=0.0, hot_key=HOT):
    """The reference's ``tests/test_rebalance_engines.py`` stream:
    integer-valued float32 values, optionally ``hot_frac`` of each step
    on one key."""
    rng = np.random.default_rng(seed)
    steps = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        if hot_frac:
            keys[rng.random(per_step) < hot_frac] = hot_key
        vals = rng.integers(1, 6, per_step).astype(np.float32)
        ts = rng.integers(s * 80, s * 80 + 60, per_step).astype(np.int64)
        steps.append((keys, vals, ts, (s - 1) * 80))
    return steps


def _batches(keys, vals, ts):
    cols = {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
            "v": np.asarray(vals, dtype=np.float32)}
    ts = np.asarray(ts, dtype=np.int64)
    return (JRecordBatch.from_pydict(cols, timestamps=ts),
            RecordBatch.from_pydict(cols, timestamps=ts))


def _aggs(kind):
    return {"sum": (jagg.SumAggregate("v"), tagg.SumAggregate("v")),
            "max": (jagg.MaxAggregate("v"), tagg.MaxAggregate("v")),
            "multi": (jagg.MultiAggregate([jagg.SumAggregate("v"),
                                           jagg.MaxAggregate("v"),
                                           jagg.CountAggregate()]),
                      tagg.MultiAggregate([tagg.SumAggregate("v"),
                                           tagg.MaxAggregate("v"),
                                           tagg.CountAggregate()]))}[kind]


def session_pair(P=4, agg="sum", **kw):
    ja, ta = _aggs(agg)
    kw.setdefault("capacity_per_shard", 1 << 14)
    return (JSessionEngine(GAP, ja, jmake_mesh(P), **kw),
            MeshSessionEngine(GAP, ta, make_mesh(P, "cpu"), **kw))


def window_pair(P=4, **kw):
    kw.setdefault("capacity_per_shard", 1 << 14)
    return (JWindowEngine(JTumbling.of(100), jagg.SumAggregate("v"),
                          jmake_mesh(P), **kw),
            MeshWindowEngine(TumblingEventTimeWindows.of(100),
                             tagg.SumAggregate("v"), make_mesh(P, "cpu"),
                             **kw))


def _move_half(src, dst):
    """fn(engine) -> (reference assignment, port assignment) moving half
    of ``src``'s groups to ``dst``, from the engine's CURRENT table."""
    def fn(j, t):
        cur_j, cur_t = j.key_group_assignment, t.key_group_assignment
        np.testing.assert_array_equal(cur_t.table, cur_j.table)
        groups = cur_j.groups_of_shard(src)
        assert len(groups) > 1
        half = groups[: len(groups) // 2]
        return cur_j.move(half, dst), cur_t.move(half, dst)
    return fn


def drive(j, t, steps, rebalances=None, on_step=None, end=True):
    """Both engines through ``steps``; ``rebalances`` = {step -> fn}
    applied before that step. Fires compared in order, bit for bit."""
    for i, (keys, vals, ts, wm) in enumerate(steps):
        if rebalances and i in rebalances:
            aj, at = rebalances[i](j, t)
            rj = j.reassign_key_groups(aj)
            rt = t.reassign_key_groups(at)
            for k in ("groups_moved", "rows_moved", "resident_rows",
                      "spilled_rows"):
                assert rt[k] == rj[k], k
            assert rt["groups_moved"] > 0 and rt["rows_moved"] > 0
        jb, tb = _batches(keys, vals, ts)
        j.process_batch(jb)
        t.process_batch(tb)
        assert_batches_equal(t.on_watermark(wm), j.on_watermark(wm))
        if on_step is not None:
            on_step(i, keys)
    if end:
        assert_batches_equal(t.on_watermark(1 << 60),
                             j.on_watermark(1 << 60))


# ------------------------------------------------------------ assignment


def test_contiguous_assignment_routes_like_the_formula_in_both():
    rng = np.random.default_rng(3)
    keys = rng.integers(-(1 << 62), 1 << 62, 20_000).astype(np.int64)
    for P, maxp, rng_kg in ((4, 128, None), (8, 128, None), (3, 256, None),
                            (4, 128, (32, 95)), (7, 1024, (100, 611))):
        a = KeyGroupAssignment.contiguous(P, maxp, rng_kg)
        ja = JAssignment.contiguous(P, maxp, rng_kg)
        np.testing.assert_array_equal(a.table, ja.table)
        assert a.is_contiguous and a.first == ja.first and a.span == ja.span
        if rng_kg is None:
            want = jshard_records(keys, P, maxp)
            np.testing.assert_array_equal(shard_records(keys, P, maxp), want)
            np.testing.assert_array_equal(
                shard_records(keys, P, maxp, assignment=a), want)
        assert a.runs() == ja.runs()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_moves_route_alike(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 40, 10_000).astype(np.int64)
    a = KeyGroupAssignment.contiguous(8, 128)
    ja = JAssignment.contiguous(8, 128)
    for _ in range(5):
        groups = rng.choice(128, rng.integers(1, 20), replace=False)
        dst = int(rng.integers(0, 8))
        a, ja = a.move(groups, dst), ja.move(groups, dst)
        np.testing.assert_array_equal(a.table, ja.table)
        np.testing.assert_array_equal(
            shard_records(keys, 8, 128, assignment=a),
            jshard_records(keys, 8, 128, assignment=ja))
        np.testing.assert_array_equal(a.shard_of_keys(keys, 128),
                                      ja.shard_of_keys(keys, 128))
        for s in range(8):
            np.testing.assert_array_equal(a.groups_of_shard(s),
                                          ja.groups_of_shard(s))
        assert a.runs() == ja.runs()
        assert a.is_contiguous == ja.is_contiguous
        kg = np.arange(128)
        np.testing.assert_array_equal(
            host_of_key_group(kg, 2, 4, 128, assignment=a),
            jhost_of_key_group(kg, 2, 4, 128, assignment=ja))
    np.testing.assert_array_equal(host_of_key_group(np.arange(128), 2, 4,
                                                    128),
                                  jhost_of_key_group(np.arange(128), 2, 4,
                                                     128))
    with pytest.raises(ValueError):
        a.move([500], 1)
    with pytest.raises(ValueError):
        KeyGroupAssignment(0, 4, np.array([0, 4]))


# ------------------------------------------------------- load and policy


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_accountant_and_policy_equal_the_reference_on_a_fake_clock():
    """The reference's ``tests/test_skew_plane.py`` shape: a skewed
    stream through both accountants and policies; rates, imbalance,
    sketch candidates and plans equal at every tick."""
    clk, jclk = Clock(), Clock()
    acc = ShardLoadAccountant(8, 128, ewma_alpha=0.4, top_k=8, clock=clk)
    jacc = JAccountant(8, 128, ewma_alpha=0.4, top_k=8, clock=jclk)
    pol = RebalancePolicy(imbalance_trigger=1.2, hysteresis=0.05,
                          cooldown_s=2.0, max_moves=6, clock=clk)
    jpol = JRebalancePolicy(imbalance_trigger=1.2, hysteresis=0.05,
                            cooldown_s=2.0, max_moves=6, clock=jclk)
    cur = KeyGroupAssignment.contiguous(8, 128)
    jcur = JAssignment.contiguous(8, 128)
    rng = np.random.default_rng(11)
    plans = 0
    for step in range(12):
        keys = rng.zipf(1.3, 4_000).astype(np.int64) % 50_000
        keys[rng.random(4_000) < 0.3] = HOT
        acc.note_batch(keys)
        jacc.note_batch(keys)
        clk.t = jclk.t = step * 1.0
        res = rng.integers(0, 1000, 8).tolist()
        busy = rng.random(8).tolist()
        acc.tick(shard_resident_rows=res, shard_busy_s=busy)
        jacc.tick(shard_resident_rows=res, shard_busy_s=busy)
        np.testing.assert_array_equal(acc.group_load(), jacc.group_load())
        np.testing.assert_array_equal(acc.shard_load(cur),
                                      jacc.shard_load(jcur))
        assert acc.imbalance(cur) == jacc.imbalance(jcur)
        assert acc.hot_key_candidates() == jacc.hot_key_candidates()
        assert acc.hottest_group() == jacc.hottest_group()
        plan = pol.plan(acc, cur)
        jplan = jpol.plan(jacc, jcur)
        assert plan.moves == jplan.moves and plan.reason == jplan.reason
        assert plan.imbalance_before == jplan.imbalance_before
        assert plan.imbalance_after == jplan.imbalance_after
        assert plan.split_candidates == jplan.split_candidates
        if plan.assignment is not None:
            np.testing.assert_array_equal(plan.assignment.table,
                                          jplan.assignment.table)
            cur, jcur = plan.assignment, jplan.assignment
            pol.mark_rebalanced()
            jpol.mark_rebalanced()
            plans += 1
    assert plans >= 1
    assert HOT in [k for k, _g, _s in acc.hot_key_candidates()]


def test_skew_metrics_group_reads_like_the_reference():
    from flink_tpu.metrics.core import MetricRegistry as JRegistry
    from flink_tpu_torch.metrics.core import MetricRegistry

    acc, jacc = ShardLoadAccountant(4, 128), JAccountant(4, 128)
    keys = np.random.default_rng(5).integers(0, 999, 3000)
    acc.note_batch(keys)
    jacc.note_batch(keys)
    reg, jreg = MetricRegistry(), JRegistry()
    acc.register_metrics(reg.root_group("job"))
    jacc.register_metrics(jreg.root_group("job"))
    got, want = reg.snapshot(), jreg.snapshot()
    assert got == want and any("skew" in k for k in got)


# ------------------------------------------------- rebalanced engines


class TestRebalance:
    def test_session_engine_two_moves_paged(self):
        """Two composed mid-stream moves under forced paged eviction
        (1024 device slots against ~6k live sessions)."""
        j, t = session_pair(max_device_slots=1024)
        drive(j, t, _stream(), rebalances={3: _move_half(0, 2),
                                           6: _move_half(1, 3)})
        assert t.rebalances_completed == j.rebalances_completed == 2
        assert not t.key_group_assignment.is_contiguous
        assert t.shard_key_group_runs() == j.shard_key_group_runs()
        assert len(t.shard_key_group_runs()) > t.P
        assert t.spill_counters() == j.spill_counters()
        assert t.spill_counters()["pages_reloaded"] > 0

    def test_window_engine_two_moves(self):
        j, t = window_pair(max_device_slots=1024)
        drive(j, t, _stream(seed=43), rebalances={2: _move_half(0, 3),
                                                  5: _move_half(2, 1)})
        assert t.rebalances_completed == 2
        np.testing.assert_array_equal(t.key_group_assignment.table,
                                      j.key_group_assignment.table)
        assert t.key_imbalance() == j.key_imbalance()

    def test_reshard_after_rebalance_resets_to_contiguous(self):
        j, t = session_pair(max_device_slots=1024)
        steps = _stream(seed=57)
        drive(j, t, steps[:5], rebalances={2: _move_half(0, 2)}, end=False)
        assert not t.key_group_assignment.is_contiguous
        rj, rt = j.reshard(8), t.reshard(8)
        assert rt["rows_moved"] == rj["rows_moved"]
        assert t.key_group_assignment.is_contiguous and t.P == 8
        drive(j, t, steps[5:])

    def test_queries_after_moves_equal_the_reference(self):
        j, t = window_pair(max_device_slots=1024)
        steps = _stream(seed=61, n_steps=5)
        drive(j, t, steps, rebalances={2: _move_half(1, 0)}, end=False)
        keys = np.unique(steps[-1][0])[:300]
        assert t.query_batch(keys) == j.query_batch(keys)

    def test_noop_and_validation(self):
        j, t = session_pair()
        rep = t.reassign_key_groups(t.key_group_assignment)
        assert rep["groups_moved"] == 0 and rep["noop"]
        assert t.rebalances_completed == 0
        with pytest.raises(TypeError):
            t.reassign_key_groups("not-an-assignment")
        with pytest.raises(TypeError):
            j.reassign_key_groups("not-an-assignment")
        with pytest.raises(ValueError):
            t.reassign_key_groups(KeyGroupAssignment.contiguous(8, 128))

    def test_partial_failover_refused_under_live_assignment(self):
        j, t = session_pair(max_device_slots=1024)
        drive(j, t, _stream(n_steps=2), rebalances={1: _move_half(0, 2)},
              end=False)
        for e in (j, t):
            with pytest.raises(ValueError, match="rebalanced"):
                e.lose_shard(1)
            with pytest.raises(ValueError, match="non-contiguous"):
                e.shard_key_groups()

    def test_unit_checkpoints_follow_runs_and_restore_contiguous(self):
        """Rebalance, snapshot per unit (one per same-shard run), merge,
        restore into FRESH engines (contiguous again): the units, the
        merged snapshot and the rest of the stream equal the
        reference's."""
        j, t = session_pair(max_device_slots=1024)
        steps = _stream(seed=71)
        drive(j, t, steps[:5], rebalances={3: _move_half(1, 3)}, end=False)
        tu = t.snapshot_sharded(mode="savepoint")
        ju = j.snapshot_sharded(mode="savepoint")
        assert list(tu) == list(ju) and len(tu) > t.P
        tm = t.merge_unit_snapshots(list(tu.values()))
        jm = j.merge_unit_snapshots(list(ju.values()))
        order_t = np.lexsort((tm["table"]["namespace"],
                              tm["table"]["key_id"]))
        order_j = np.lexsort((jm["table"]["namespace"],
                              jm["table"]["key_id"]))
        for col in ("key_id", "namespace", "leaf_0"):
            np.testing.assert_array_equal(
                _bits(np.asarray(tm["table"][col])[order_t]),
                _bits(np.asarray(jm["table"][col])[order_j]))
        fj, ft = session_pair(max_device_slots=1024)
        fj.restore(jm)
        ft.restore(tm)
        assert ft.key_group_assignment.is_contiguous
        drive(fj, ft, steps[5:])
        drive(j, t, steps[5:])


# ---------------------------------------------------------- the responder


def test_skew_responder_closes_the_loop_like_the_reference():
    """40 % of the records on one key: both responders detect, move
    groups and split the key at the same steps; fires stay bit-identical."""
    clk, jclk = Clock(), Clock()
    j, t = session_pair(max_device_slots=1024)
    acc = ShardLoadAccountant(t.P, t.max_parallelism, ewma_alpha=0.5,
                              clock=clk)
    jacc = JAccountant(j.P, j.max_parallelism, ewma_alpha=0.5, clock=jclk)
    resp = SkewResponder(t, acc, policy=RebalancePolicy(
        imbalance_trigger=1.3, hysteresis=0.02, cooldown_s=0.0, clock=clk),
        salts=8, hot_key_share=0.5, allow_inexact=True)
    jresp = JSkewResponder(j, jacc, policy=JRebalancePolicy(
        imbalance_trigger=1.3, hysteresis=0.02, cooldown_s=0.0, clock=jclk),
        salts=8, hot_key_share=0.5, allow_inexact=True)

    def on_step(_i, keys):
        clk.t += 1.0
        jclk.t += 1.0
        for r, a in ((resp, acc), (jresp, jacc)):
            r.note_batch(keys)
            a.tick()
        rt, rj = resp.maybe_respond(now=clk.t), jresp.maybe_respond(
            now=jclk.t)
        assert (rt is None) == (rj is None)
        assert resp.last_plan.moves == jresp.last_plan.moves

    drive(j, t, _stream(seed=83, hot_frac=0.4), on_step=on_step)
    assert resp.rebalances == jresp.rebalances >= 1
    assert resp.groups_moved == jresp.groups_moved >= 1
    assert resp.keys_split == jresp.keys_split >= 1
    assert t.hot_key_stats() == j.hot_key_stats()
    assert t.hot_key_stats()["salted_fires"] > 0


# ----------------------------------------------------- hot-key splitting


def _split_run(agg="sum", seed=13, split_at=2, salts=8, n_steps=8,
               **kw):
    j, t = session_pair(agg=agg, max_device_slots=1024, **kw)
    steps = _stream(num_keys=4_000, n_steps=n_steps, per_step=2_000,
                    seed=seed, hot_frac=0.5)

    def split(_j, _t):
        pass

    for i, (keys, vals, ts, wm) in enumerate(steps):
        if i == split_at:
            inexact = agg != "max"
            assert t.register_hot_key(HOT, salts=salts,
                                      allow_inexact=inexact) == \
                j.register_hot_key(HOT, salts=salts, allow_inexact=inexact)
        jb, tb = _batches(keys, vals, ts)
        j.process_batch(jb)
        t.process_batch(tb)
        assert_batches_equal(t.on_watermark(wm), j.on_watermark(wm))
    return j, t, steps


@pytest.mark.parametrize("agg", ["sum", "max", "multi"])
def test_mid_stream_split_equals_the_reference(agg):
    j, t, _ = _split_run(agg=agg)
    assert_batches_equal(t.on_watermark(1 << 60), j.on_watermark(1 << 60))
    assert t.hot_key_stats() == j.hot_key_stats()
    assert t.hot_key_stats()["salted_records"] > 0
    assert t.hot_key_stats()["salted_fires"] > 0


def test_split_queries_fold_salts_like_the_reference():
    j, t, steps = _split_run(n_steps=5)
    keys = np.concatenate(([HOT], np.unique(steps[-1][0])[:200]))
    got = t.query_batch(keys)
    assert got == j.query_batch(keys)
    assert got[0]  # the split key has live sessions


def test_snapshot_restore_with_live_salted_rows():
    j, t, steps = _split_run(n_steps=5)
    ts_, js_ = t.snapshot(), j.snapshot()
    assert ts_["hot_keys"] == js_["hot_keys"] == {HOT: 8}
    assert (np.asarray(ts_["table"]["namespace"]) < 0).any()
    fj, ft = session_pair(max_device_slots=1024)
    fj.restore(js_)
    ft.restore(ts_)
    assert ft.hot_key_stats()["keys"] == {HOT: 8}
    more = _stream(num_keys=4_000, n_steps=8, per_step=2_000, seed=13,
                   hot_frac=0.5)[5:]
    drive(fj, ft, more)


def test_unit_snapshots_carry_the_registry():
    j, t, _ = _split_run(n_steps=3, split_at=1, salts=3)
    tu = t.snapshot_sharded(mode="savepoint")
    for u in tu.values():
        assert u.get("hot_keys") == {HOT: 3}
    merged = t.merge_unit_snapshots(list(tu.values()))
    jm = j.merge_unit_snapshots(list(j.snapshot_sharded(
        mode="savepoint").values()))
    assert merged["hot_keys"] == jm["hot_keys"] == {HOT: 3}


def test_replica_answers_split_key_in_one_lookup():
    """The split key's salted rows never reach the replica's index; its
    main row serves cold, through the live combined fold — one
    lookup_batch call answers it, equal to the live query and to the
    reference's replica."""
    from flink_tpu.tenancy.replica import (
        SessionReplicaAdapter as JAdapter,
    )
    from flink_tpu_torch.tenancy.replica import SessionReplicaAdapter

    j, t = session_pair(max_device_slots=1024)
    jp, tp = j.arm_replica(), t.arm_replica()
    steps = _stream(num_keys=4_000, n_steps=5, per_step=2_000, seed=91,
                    hot_frac=0.5)
    for i, (keys, vals, ts, wm) in enumerate(steps):
        if i == 1:
            j.register_hot_key(HOT, salts=8, allow_inexact=True)
            t.register_hot_key(HOT, salts=8, allow_inexact=True)
        jb, tb = _batches(keys, vals, ts)
        j.process_batch(jb)
        t.process_batch(tb)
        assert_batches_equal(t.on_watermark(wm), j.on_watermark(wm))
    ad, jad = SessionReplicaAdapter(tp, t.agg), JAdapter(jp, j.agg)
    ad.cold_fetch = lambda ks: t.query_batch(np.asarray(ks, dtype=np.int64))
    jad.cold_fetch = lambda ks: j.query_batch(np.asarray(ks,
                                                         dtype=np.int64))
    qk = [HOT, 0, 1, 2, 3]
    got, _ = ad.lookup_batch(qk)
    want, _ = jad.lookup_batch(qk)
    assert got == want == t.query_batch(np.asarray(qk, dtype=np.int64))
    assert tp.cold_rows_served > 0


class TestSplitGuards:
    def test_float_sum_requires_allow_inexact(self):
        _, t = session_pair(max_device_slots=1024)
        with pytest.raises(ValueError, match="allow_inexact"):
            t.register_hot_key(HOT, salts=8)
        assert t.hot_key_stats()["keys"] == {}

    def test_requires_paged_layout(self):
        _, t = session_pair()
        with pytest.raises(ValueError, match="paged"):
            t.register_hot_key(HOT, salts=8, allow_inexact=True)

    def test_salt_count_clamped(self):
        _, t = session_pair(agg="max", max_device_slots=1024)
        assert t.register_hot_key(HOT, salts=1) == 2
        assert t.register_hot_key(HOT, salts=10 ** 6) == MAX_SALTS == 64


def test_salt_functions_are_the_references_bit_for_bit():
    from flink_tpu.parallel import sharded_sessions as jss
    from flink_tpu_torch.parallel import sharded_sessions as tss

    rng = np.random.default_rng(2)
    k = rng.integers(-(1 << 62), 1 << 62, 5000).astype(np.int64)
    s = rng.integers(0, MAX_SALTS, 5000).astype(np.int64)
    np.testing.assert_array_equal(tss._salted_keys(k, s),
                                  jss._salted_keys(k, s))
    np.testing.assert_array_equal(tss._salted_ns(k % 10_000, s),
                                  jss._salted_ns(k % 10_000, s))
