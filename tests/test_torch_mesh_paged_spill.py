"""The mesh paged spill tier of the port (``MeshPagedSpillSupport`` in
``flink_tpu_torch/parallel/sharded_windower.py`` under
``MeshSessionEngine``) against the reference's on the CPU: the in-scope
cases of ``tests/test_mesh_paged_spill.py`` (its snapshot, query and
namespace-layout cases belong to ROADMAP Queue A items 8, 12 and 7c).

Both engines get the same batches and watermarks (made from numpy seeds,
a live session set far beyond a 1024-row budget per shard); every fired
batch is equal in order and bit for bit, and the spill counters equal the
reference's after every call. Tolerance: none, except against the
single-device engine's content (relative 1e-4, as the reference's test:
the P=1 engine folds one plane, the mesh eight, so a session's adds are
the same but its rows are fired in another order).
"""

import numpy as np
import pytest

from flink_tpu.parallel.sharded_sessions import MeshSessionEngine as JEngine
from flink_tpu.windowing.aggregates import SumAggregate as JSum
from flink_tpu_torch.core.records import KEY_ID_FIELD
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
from flink_tpu_torch.runtime.pending import PendingFire
from flink_tpu_torch.windowing.aggregates import SumAggregate
from flink_tpu_torch.windowing.sessions import SessionWindower

from tests.test_torch_mesh_sessions import (
    _jbatch,
    _tbatch,
    assert_batches_equal,
)

GAP = 100
P = 8


def _engine(**kw):
    return MeshSessionEngine(GAP, SumAggregate("v"), make_mesh(P, "cpu"),
                             capacity_per_shard=1 << 14, **kw)


def _jengine(mesh, **kw):
    return JEngine(GAP, JSum("v"), mesh, capacity_per_shard=1 << 14, **kw)


def _stream(num_keys=24_000, n_steps=8, per_step=6000, seed=17):
    """``tests/test_mesh_paged_spill.py``'s stream: ~num_keys keys recur
    within the gap and the watermark lags a step, so >10k sessions stay
    live (>1.3k per shard against 1024 rows) — cohort eviction and fires
    of paged-out sessions."""
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


def _run_both(t, j, steps):
    """Drive both engines in lockstep; fires equal in order, bit for bit,
    counters equal after every call. Returns the port's fired batches."""
    fired = []
    for keys, vals, ts, wm in steps:
        j.process_batch(_jbatch(keys, vals, ts))
        t.process_batch(_tbatch(keys, vals, ts))
        assert t.spill_counters() == j.spill_counters()
        want = j.on_watermark(wm)
        got = t.on_watermark(wm)
        assert_batches_equal(got, want)
        assert t.spill_counters() == j.spill_counters()
        fired.extend(got)
    return fired


def session_dict(batches):
    out = {}
    for b in batches:
        for r in b.to_rows():
            out[(r[KEY_ID_FIELD], r["window_start"],
                 r["window_end"])] = r["sum_v"]
    return out


def _single_device(steps):
    single = SessionWindower(GAP, SumAggregate("v"), capacity=1 << 15,
                             spill={"device": "cpu"})
    fired = []
    for keys, vals, ts, wm in steps:
        single.process_batch(_tbatch(keys, vals, ts))
        fired.extend(single.on_watermark(wm))
    return session_dict(fired)


def test_paged_is_default_and_registry_free():
    eng = _engine(max_device_slots=1024)
    assert eng.spill_layout == "pages"
    assert eng._paged
    assert all(pm.defer_sweeps for pm in eng._pmaps)
    for idx in eng.indexes:
        assert idx._track_ns is False
        assert idx._ns_slots == {}


def test_forced_eviction_matches_reference(eight_device_mesh):
    """1024 device rows a shard against ~12k live sessions: the fires and
    the spill counters equal the reference's, every session equals the
    unbounded single-device engine's, and the traffic is page-granular
    (cohorts of many rows a page, reloads by row, no re-bundling)."""
    steps = _stream()
    t = _engine(max_device_slots=1024)
    gathers = []
    gather = t._gather_step

    def counted(accs, block):
        gathers.append((block != 0).sum(dim=1).gt(0).sum().item())
        return gather(accs, block)

    t._gather_step = counted
    fired = _run_both(t, _jengine(eight_device_mesh, max_device_slots=1024),
                      steps)
    d_mesh, d_single = session_dict(fired), _single_device(steps)
    assert len(d_single) > 0 and set(d_mesh) == set(d_single)
    for k in d_single:
        assert d_mesh[k] == pytest.approx(d_single[k], rel=1e-4), k
    for idx in t.indexes:
        assert idx.capacity <= 1024
    c = t.spill_counters()
    assert c["pages_evicted"] > 0 and c["pages_reloaded"] > 0
    assert c["rows_evicted"] >= 8 * c["pages_evicted"]
    assert c["rows_split_on_reload"] == 0
    assert c["rows_compacted"] <= 2 * c["rows_reloaded"]
    # one [P, G] gather per eviction round, most carrying several shards'
    # cohorts
    assert len(gathers) < c["pages_evicted"]
    assert max(gathers) > 1


def test_deferred_sweeps_drain_at_the_next_ingest(eight_device_mesh):
    """Fires of paged-out sessions queue their pages' sweeps; the next
    ingest drains them; the counters stay the reference's."""
    steps = _stream(seed=5)
    t = _engine(max_device_slots=1024)
    j = _jengine(eight_device_mesh, max_device_slots=1024)
    queued = 0
    for keys, vals, ts, wm in steps[:-1]:
        j.process_batch(_jbatch(keys, vals, ts))
        t.process_batch(_tbatch(keys, vals, ts))
        assert not any(pm.deferred_pages for pm in t._pmaps)
        assert_batches_equal(t.on_watermark(wm), j.on_watermark(wm))
        queued += sum(len(pm.deferred_pages) for pm in t._pmaps)
        assert t.spill_counters() == j.spill_counters()
    assert queued > 0


def test_pipelined_fires_match_in_content_and_order(eight_device_mesh):
    """Dispatch-ahead 3 and async fires harvested lazily (up to 3 in
    flight) under forced eviction: the fire stream equals the synchronous
    engine's row for row and bit for bit, and the reference's."""
    steps = _stream(seed=31)
    sync_eng = _engine(max_device_slots=1024)
    sync_fired = _run_both(
        sync_eng, _jengine(eight_device_mesh, max_device_slots=1024), steps)
    async_eng = _engine(max_device_slots=1024, max_dispatch_ahead=3)
    assert async_eng.supports_async_fires
    pending, fired = [], []
    for keys, vals, ts, wm in steps:
        async_eng.process_batch(_tbatch(keys, vals, ts))
        out = async_eng.on_watermark(wm, async_ok=True)
        assert all(isinstance(b, PendingFire) for b in out)
        pending.extend(out)
        while len(pending) > 3:
            fired.append(pending.pop(0).harvest())
    fired.extend(p.harvest() for p in pending)
    assert_batches_equal(fired, sync_fired)
    c = async_eng.spill_counters()
    assert c == sync_eng.spill_counters()
    assert c["pages_evicted"] > 0 and c["rows_split_on_reload"] == 0


def test_unbudgeted_pages_layout_is_registry_free(eight_device_mesh):
    """Without a budget nothing spills, and the host indexes still free by
    slot (no per-namespace registry)."""
    steps = _stream(num_keys=3000, n_steps=5, per_step=1000)
    t = _engine()
    fired = _run_both(t, _jengine(eight_device_mesh), steps)
    d_got, d_ref = session_dict(fired), _single_device(steps)
    assert len(d_ref) > 0 and set(d_got) == set(d_ref)
    for k in d_ref:
        assert d_got[k] == pytest.approx(d_ref[k], rel=1e-4), k
    for idx in t.indexes:
        assert idx._ns_slots == {}
    assert not t._paged
    assert t.spill_counters() == {
        "pages_evicted": 0, "pages_reloaded": 0, "rows_evicted": 0,
        "rows_reloaded": 0, "rows_split_on_reload": 0,
        "rows_compacted": 0}


@pytest.mark.parametrize("batch", [1000, 4000])
def test_budget_split_matches_reference(batch, eight_device_mesh):
    """Batches whose per-shard records pass half the budget split in two
    (``rec_shard_max``, then the unique refinement) exactly where the
    reference splits: the same fires, in order, and counters."""
    rng = np.random.default_rng(8)
    steps = []
    for s in range(6):
        keys = rng.integers(0, 40_000, batch * 4).astype(np.int64)
        ts = rng.integers(s * 80, s * 80 + 60, batch * 4).astype(np.int64)
        steps.append((keys, rng.random(batch * 4).astype(np.float32), ts,
                      (s - 2) * 80))
    steps.append((np.array([1]), np.array([1.0], np.float32),
                  np.array([10_000]), 10 ** 9))
    t = _engine(max_device_slots=1024)
    calls = [0]
    ingest = t.process_batch

    def counted(b):
        calls[0] += 1
        return ingest(b)

    t.process_batch = counted
    _run_both(t, _jengine(eight_device_mesh, max_device_slots=1024), steps)
    if batch == 4000:  # 2,000 records a shard: every batch splits
        assert calls[0] > 2 * (len(steps) - 1)


@pytest.mark.parametrize("kind", ["avg", "count", "max"])
def test_forced_eviction_other_aggregates_match_reference(
        kind, eight_device_mesh):
    """Fires of paged-out sessions finish on the host (Avg's divide with
    the reference's NaN rule), resident ones on the device: both equal the
    reference's, in order and bit for bit, values with NaN payloads."""
    from flink_tpu.windowing import aggregates as jagg
    from flink_tpu_torch.windowing import aggregates as tagg

    make = {"avg": (lambda: jagg.AvgAggregate("v"),
                    lambda: tagg.AvgAggregate("v")),
            "count": (jagg.CountAggregate, tagg.CountAggregate),
            "max": (lambda: jagg.MaxAggregate("v"),
                    lambda: tagg.MaxAggregate("v"))}[kind]
    steps = _stream(n_steps=6, seed=41)
    nan = np.array([0x7fa00001, 0xffc00003], np.uint32).view(np.float32)
    for keys, vals, ts, wm in steps:
        vals[::97] = nan[0]
        vals[::89] = nan[1]
    t = MeshSessionEngine(GAP, make[1](), make_mesh(P, "cpu"),
                          capacity_per_shard=1 << 14, max_device_slots=1024)
    j = JEngine(GAP, make[0](), eight_device_mesh,
                capacity_per_shard=1 << 14, max_device_slots=1024)
    _run_both(t, j, steps)
    assert t.spill_counters()["rows_reloaded"] > 0
