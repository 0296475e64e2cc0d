"""The port's budgeted mesh engines (the namespace spill layout of
``MeshSpillSupport`` in ``flink_tpu_torch/parallel/sharded_windower.py``)
against the reference's on the CPU: the reference on the 8 virtual devices
of ``tests/conftest.py``, the port on an 8-shard logical mesh. Modelled on
``tests/test_mesh_spill.py`` and on
``test_explicit_namespaces_layout_still_works`` of
``tests/test_mesh_paged_spill.py``.

Both engines get the same batches and watermarks (numpy seeds; a live
(key, slice) set far beyond a 1024-row budget per shard, so namespaces
leave, reload, and windows fire hybrid). Tolerance: none — every fired
batch is equal in order and bit for bit (float32 Sum with NaN payloads
and +-inf, Count, ``MultiAggregate``), the spill counters are equal after
every call, and snapshots and deltas are equal array by array.
"""

import numpy as np
import pytest

from flink_tpu.parallel.sharded_sessions import MeshSessionEngine as JSessions
from flink_tpu.parallel.sharded_windower import MeshWindowEngine as JEngine
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing import assigners as jasg
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import (
    MeshSessionEngine as TSessions,
)
from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine as TEngine
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing import assigners as tasg

from tests.test_torch_mesh_sessions import (
    _SPECIAL,
    _bits,
    _jbatch,
    _tbatch,
    assert_batches_equal,
)

P = 8
BUDGET = 1024


def _steps(num_keys=4000, per_step=5000, n_steps=6, seed=11, span=6000,
           specials=True):
    """``tests/test_mesh_spill.py``'s stream at the size of its eviction
    test, larger (4000 keys over six open slices: ~2.5k live rows a shard,
    and batches whose slices are ingested in groups), with float32 specials — NaN payloads, +-inf, signed zeros —
    on 2 % of the values, and a final record that flushes every window."""
    rng = np.random.default_rng(seed)
    steps = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        vals = rng.random(per_step).astype(np.float32)
        if specials:
            sp = rng.random(per_step) < 0.02
            vals[sp] = rng.choice(_SPECIAL[np.float32],
                                  int(sp.sum())).view(np.float32)
        ts = rng.integers(s * 1000, s * 1000 + span, per_step).astype(
            np.int64)
        steps.append((keys, vals, ts, s * 1000))
    steps.append((np.array([0], dtype=np.int64),
                  np.array([0.0], dtype=np.float32),
                  np.array([n_steps * 1000 + span + 5000], dtype=np.int64),
                  10 ** 9))
    return steps


AGGS = {
    "sum": lambda m: m.SumAggregate("v"),
    "count": lambda m: m.CountAggregate(),
    "multi": lambda m: m.MultiAggregate([m.CountAggregate(),
                                         m.SumAggregate("v")]),
}
ASSIGNERS = {
    "tumbling": lambda m: m.TumblingEventTimeWindows.of(1000),
    "sliding": lambda m: m.SlidingEventTimeWindows.of(2000, 1000),
}


def _pair(eight_device_mesh, agg, assigner, budget=BUDGET, **kw):
    j = JEngine(ASSIGNERS[assigner](jasg), AGGS[agg](jagg),
                eight_device_mesh, capacity_per_shard=1 << 14,
                max_device_slots=budget, **kw)
    t = TEngine(ASSIGNERS[assigner](tasg), AGGS[agg](tagg),
                make_mesh(P, "cpu"), capacity_per_shard=1 << 14,
                max_device_slots=budget, **kw)
    return j, t


def _drive(j, t, steps):
    fired = []
    for keys, vals, ts, wm in steps:
        j.process_batch(_jbatch(keys, vals, ts))
        t.process_batch(_tbatch(keys, vals, ts))
        assert t.spill_counters() == j.spill_counters()
        want, got = j.on_watermark(wm), t.on_watermark(wm)
        assert_batches_equal(got, want)
        assert t.spill_counters() == j.spill_counters()
        fired.extend(got)
    return fired


def assert_tables_equal(got, want):
    """Snapshot tables equal array by array, bit for bit."""
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("agg", sorted(AGGS))
@pytest.mark.parametrize("assigner", sorted(ASSIGNERS))
def test_fired_rows_and_counters_equal_reference(eight_device_mesh, agg,
                                                 assigner):
    j, t = _pair(eight_device_mesh, agg, assigner)
    fired = _drive(j, t, _steps(seed=len(agg) + len(assigner)))
    assert len(fired) > 3
    c = t.spill_counters()
    assert c["rows_evicted"] > 0 and c["rows_reloaded"] > 0, c
    assert t.hybrid_fires > 0
    for idx in t.indexes:
        assert idx.capacity <= BUDGET


def test_spill_to_files_equals_reference(eight_device_mesh, tmp_path):
    """With ``spill_host_max_bytes`` the spilled namespaces go to files
    (``state.spill.dir``); rows and counters stay the reference's."""
    t2 = TEngine(ASSIGNERS["sliding"](tasg), AGGS["sum"](tagg),
                 make_mesh(P, "cpu"), capacity_per_shard=1 << 14,
                 max_device_slots=BUDGET, spill_dir=str(tmp_path / "t"),
                 spill_host_max_bytes=1 << 12)
    j2 = JEngine(ASSIGNERS["sliding"](jasg), AGGS["sum"](jagg),
                 eight_device_mesh, capacity_per_shard=1 << 14,
                 max_device_slots=BUDGET, spill_dir=str(tmp_path / "j"),
                 spill_host_max_bytes=1 << 12)
    steps = _steps(seed=3)
    _drive(j2, t2, steps[:3])
    assert any(sp._fs for sp in t2.spills)
    assert any(f.suffix == ".npz" for f in (tmp_path / "t").rglob("*"))
    _drive(j2, t2, steps[3:])
    assert t2.spill_counters()["rows_reloaded"] > 0


def test_batch_split_by_namespace_groups(eight_device_mesh):
    """One batch whose slices need more rows than half the budget is
    ingested group by group (``_ns_group_plan``), as in the reference."""
    j, t = _pair(eight_device_mesh, "sum", "tumbling")
    rng = np.random.default_rng(8)
    n = 20_000
    keys = rng.integers(0, 10_000, n).astype(np.int64)
    vals = rng.random(n).astype(np.float32)
    ts = rng.integers(0, 8000, n).astype(np.int64)
    steps = [(keys, vals, ts, 3999), (keys[:10], vals[:10],
                                      ts[:10] + 20_000, 10 ** 9)]
    assert t._ns_group_plan(keys, t.assigner.assign_slice_ends(ts)) \
        is not None
    _drive(j, t, steps)
    assert t.spill_counters()["rows_evicted"] > 0


def test_snapshot_and_delta_with_spilled_namespaces(eight_device_mesh):
    """Full snapshot, then a delta, both taken with spilled namespaces:
    equal array by array to the reference's, and each package restores
    the other's and goes on to the same rows."""
    steps = _steps(seed=5)
    j, t = _pair(eight_device_mesh, "sum", "sliding")
    _drive(j, t, steps[:3])
    assert sum(len(sp) for sp in t.spills) > 0
    full_t, full_j = t.snapshot(), j.snapshot()
    assert_tables_equal(full_t["table"], full_j["table"])
    _drive(j, t, steps[3:4])
    delta_t, delta_j = t.snapshot("delta"), j.snapshot("delta")
    assert_tables_equal(delta_t["table"], delta_j["table"])
    assert len(delta_t["table"]["key_id"]) > 0
    # cross-package restores of the full snapshot, then the same stream
    j2, t2 = _pair(eight_device_mesh, "sum", "sliding")
    t2.restore(full_j)
    j2.restore(full_t)
    assert t2.spill_counters() == j2.spill_counters()
    _drive(j2, t2, steps[3:])


def test_budgeted_snapshot_restores_unbudgeted(eight_device_mesh):
    """A snapshot with spilled namespaces restores into an engine without
    a budget (every row onto the planes), in both packages alike."""
    steps = _steps(seed=9)
    j, t = _pair(eight_device_mesh, "multi", "sliding")
    _drive(j, t, steps[:3])
    assert sum(len(sp) for sp in t.spills) > 0
    snap = t.snapshot()
    assert_tables_equal(snap["table"], j.snapshot()["table"])
    ju = JEngine(ASSIGNERS["sliding"](jasg), AGGS["multi"](jagg),
                 eight_device_mesh, capacity_per_shard=1 << 14)
    tu = TEngine(ASSIGNERS["sliding"](tasg), AGGS["multi"](tagg),
                 make_mesh(P, "cpu"), capacity_per_shard=1 << 14)
    ju.restore(snap)
    tu.restore(snap)
    fired = _drive(ju, tu, steps[3:])
    assert len(fired) > 0


# ------------------------------------------- the session engine's layout

GAP = 100


def _session_stream(num_keys=24_000, n_steps=8, per_step=6000, seed=17):
    """``tests/test_mesh_paged_spill.py``'s stream: keys recur within the
    gap and the watermark lags a step, so >1.3k sessions a shard stay
    live against 1024 rows."""
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


def _session_pair(eight_device_mesh, agg="sum", **kw):
    j = JSessions(GAP, AGGS[agg](jagg), eight_device_mesh,
                  capacity_per_shard=1 << 14, max_device_slots=BUDGET,
                  spill_layout="namespaces", **kw)
    t = TSessions(GAP, AGGS[agg](tagg), make_mesh(P, "cpu"),
                  capacity_per_shard=1 << 14, max_device_slots=BUDGET,
                  spill_layout="namespaces", **kw)
    return j, t


def test_session_namespaces_layout_equals_reference(eight_device_mesh):
    j, t = _session_pair(eight_device_mesh)
    fired = _drive(j, t, _session_stream())
    assert sum(len(b) for b in fired) > 10_000
    c = t.spill_counters()
    assert c["rows_evicted"] > 0 and c["rows_reloaded"] > 0, c
    assert not t._paged


def test_session_namespaces_merges_equal_reference(eight_device_mesh):
    """Out-of-order records whose sessions merge (float32 Max): merges of
    spilled sessions reload both sides first, as in the reference."""
    rng = np.random.default_rng(23)
    steps = []
    for s in range(6):
        n = 5000
        keys = rng.integers(0, 8000, n).astype(np.int64)
        vals = rng.standard_normal(n).astype(np.float32)
        ts = rng.integers(s * 150, s * 150 + 400, n).astype(np.int64)
        steps.append((keys, vals, ts, s * 150 - 300))
    steps.append((np.array([1], np.int64), np.array([0.0], np.float32),
                  np.array([50_000], np.int64), 10 ** 9))
    j = JSessions(GAP, jagg.MaxAggregate("v"), eight_device_mesh,
                  capacity_per_shard=1 << 14, max_device_slots=BUDGET,
                  spill_layout="namespaces")
    t = TSessions(GAP, tagg.MaxAggregate("v"), make_mesh(P, "cpu"),
                  capacity_per_shard=1 << 14, max_device_slots=BUDGET,
                  spill_layout="namespaces")
    _drive(j, t, steps)
    assert t.merge_groups > 0
    assert t.spill_counters()["rows_evicted"] > 0


def test_session_namespaces_snapshot_restores_across_packages(
        eight_device_mesh):
    steps = _session_stream(num_keys=16_000, n_steps=6, per_step=5000,
                            seed=29)
    j, t = _session_pair(eight_device_mesh)
    _drive(j, t, steps[:3])
    snap_t, snap_j = t.snapshot(), j.snapshot()
    assert_tables_equal(snap_t["table"], snap_j["table"])
    _drive(j, t, steps[3:4])
    assert_tables_equal(t.snapshot("delta")["table"],
                        j.snapshot("delta")["table"])
    j2, t2 = _session_pair(eight_device_mesh)
    t2.restore(snap_j)
    j2.restore(snap_t)
    _drive(j2, t2, steps[3:])


def test_merge_step_equals_reference(eight_device_mesh):
    """``build_mesh_steps``' raw merge (the hybrid fire's device part):
    the same ``[P, cap]`` planes (NaN payloads, +-inf) and ``[P, W, k]``
    slot matrices give the reference's merged leaves bit for bit, at the
    k where the reference's choice between two NaNs is fixed (ROADMAP
    Queue C item 3: float32 Sum at k = 1, 2, 4 and 16)."""
    import jax
    import torch
    from jax.sharding import NamedSharding, PartitionSpec

    from flink_tpu.parallel.mesh import KEY_AXIS
    from flink_tpu.parallel.sharded_windower import (
        build_mesh_steps as jsteps,
    )
    from flink_tpu_torch.parallel.sharded_windower import build_mesh_steps

    sh = NamedSharding(eight_device_mesh, PartitionSpec(KEY_AXIS))
    rng = np.random.default_rng(41)
    cap = 1024
    for name in ("sum", "count", "multi"):
        ja, ta = AGGS[name](jagg), AGGS[name](tagg)
        planes = []
        for leaf in ja.leaves:
            dt = np.dtype(leaf.dtype)
            if dt.kind == "f":
                p = rng.standard_normal((P, cap)).astype(dt)
                sp = rng.random((P, cap)) < 0.05
                p[sp] = rng.choice(_SPECIAL[np.float32],
                                   int(sp.sum())).view(np.float32)
            else:
                p = rng.integers(0, 100, (P, cap)).astype(dt)
            p[:, 0] = leaf.identity
            planes.append(p)
        for k in (1, 2, 4, 16):
            sm = rng.integers(0, cap, (P, 64, k)).astype(np.int32)
            want = jsteps(eight_device_mesh, ja)[5](
                tuple(jax.device_put(p, sh) for p in planes),
                jax.device_put(sm, sh))
            got = build_mesh_steps(make_mesh(P, "cpu"), ta)[5](
                tuple(torch.from_numpy(p.copy()) for p in planes),
                torch.from_numpy(sm))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_bits(g.numpy()),
                                              _bits(np.asarray(w)))
