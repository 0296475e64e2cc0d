"""The port's read replicas (``flink_tpu_torch/tenancy/replica.py`` and the
engines' arm/publish hooks) against the reference's on the CPU, mirroring
``tests/test_serving_replica.py``:

- window, session, join-side and CEP replicas: at every boundary the port
  replica's answers equal the port's live query AND the reference
  replica's answers at the same boundary (generation numbers included);
  the boundary state equals a checkpoint restored into a fresh engine;
- snapshot isolation: ingest without a boundary never moves a sealed
  generation, and the sealed tensors are never written in place;
- cold rows served through ``cold_fetch`` after forced eviction;
- the session END moving across three boundaries (and a merge removing
  both stale ends) on both hot-cache planes;
- hot-cache priming across publishes; a rebuild invalidating the op's
  entries; a rebuild dropping ghost index entries and sealing when
  empty; a crash inside a publish leaving the sealed generation intact.

Tolerance: none — ``same_answers`` compares structure, every float on its
raw bits (float32 streams with NaN payloads, infinities and signed zeros)
and every scalar's Python type.
"""

import numpy as np
import pytest
import torch

from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_tpu.parallel.sharded_sessions import MeshSessionEngine as JSess
from flink_tpu.parallel.sharded_windower import MeshWindowEngine as JWin
from flink_tpu.tenancy import replica as jreplica
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
from flink_tpu_torch.tenancy import replica
from flink_tpu_torch.tenancy.hot_cache import HotRowCache
from flink_tpu_torch.tenancy.replica import (
    COLD_SLOT,
    ReplicaPlane,
    SessionReplicaAdapter,
    WindowReplicaAdapter,
)
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

from tests.test_torch_queries import (
    AGGS,
    _assigners,
    _batches,
    _query_keys,
    _session_stream,
    _stream,
    same_answers,
)

P = 4


def _window_pair(agg, kind, budget, cap=2048):
    ja, ta = _assigners(kind)
    kw = {"max_device_slots": budget} if budget else {}
    j = JWin(ja, AGGS[agg][0](), jmake_mesh(P), capacity_per_shard=cap,
             **kw)
    t = MeshWindowEngine(ta, AGGS[agg][1](), make_mesh(P, "cpu"),
                         capacity_per_shard=cap, **kw)
    return j, t


def _session_pair(agg, budget, gap=400, cap=2048):
    kw = {"max_device_slots": budget} if budget else {}
    j = JSess(gap, AGGS[agg][0](), jmake_mesh(P), capacity_per_shard=cap,
              **kw)
    t = MeshSessionEngine(gap, AGGS[agg][1](), make_mesh(P, "cpu"),
                          capacity_per_shard=cap, **kw)
    return j, t


def _adapters(j, t, kind):
    """Arm both engines' replicas; (reference adapter, port adapter)."""
    jp, tp = j.arm_replica(), t.arm_replica()
    if kind == "session":
        ja = jreplica.SessionReplicaAdapter(jp, j.agg)
        ta = SessionReplicaAdapter(tp, t.agg)
    else:
        ja = jreplica.WindowReplicaAdapter(jp, j.agg, j.assigner)
        ta = WindowReplicaAdapter(tp, t.agg, t.assigner)
    ja.cold_fetch = lambda ks: j.query_batch(np.asarray(ks, np.int64))
    ta.cold_fetch = lambda ks: t.query_batch(np.asarray(ks, np.int64))
    return ja, ta


def _drive_compare(j, t, ja, ta, stream, qk, isolation=True):
    """Feed both; at every boundary: port replica == port live == the
    reference replica (and equal generations); between a batch and its
    boundary the sealed generation does not move (``isolation``: only
    without a device budget — a cold row detours to the LIVE engine, as
    in the reference, and the batch may reload and change it). Returns
    the last port replica answers and how many were non-empty."""
    got = None
    answered = 0
    for keys, vals, ts, wm in stream:
        jb, tb = _batches(keys, vals, ts)
        before = ta.lookup_batch(qk) if ta.ready() and isolation else None
        j.process_batch(jb)
        t.process_batch(tb)
        if before is not None:
            # snapshot isolation: ingest without a boundary
            same_answers(ta.lookup_batch(qk), before)
        j.on_watermark(wm)
        t.on_watermark(wm)
        got, gen = ta.lookup_batch(qk)
        want, jgen = ja.lookup_batch(qk)
        assert gen == jgen
        same_answers(got, want)
        same_answers(got, t.query_batch(np.asarray(qk, np.int64)))
        answered += sum(1 for a in got if a)
    return got, answered


@pytest.mark.parametrize("budget", [0, 1024])
@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
@pytest.mark.parametrize("agg", ["sum", "count", "avg"])
def test_window_replica_equals_live_reference_and_checkpoint(agg, kind,
                                                             budget):
    j, t = _window_pair(agg, kind, budget)
    ja, ta = _adapters(j, t, "window")
    stream = _stream(len(agg) + len(kind) + budget % 7, keys=1500, n=3000,
                     steps=6)
    qk = _query_keys(3, keys=1500).tolist()
    got, answered = _drive_compare(j, t, ja, ta, stream, qk, not budget)
    assert answered > 0 and ta.generation() >= 2
    if budget:
        assert t.spill_counters()["rows_evicted"] > 0
    fresh = _window_pair(agg, kind, budget)[1]
    fresh.restore(t.snapshot(mode="savepoint"))
    same_answers(got, fresh.query_batch(np.asarray(qk, np.int64)))


def test_window_forced_eviction_cold_slices_served():
    """Every window held open under a tight budget: namespaces evict, and
    the replica serves them through ``cold_fetch`` with the live answers
    and the reference replica's."""
    from flink_tpu.windowing import aggregates as jagg
    from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JT

    rng = np.random.default_rng(3)
    j = JWin(JT.of(500), jagg.SumAggregate("v"), jmake_mesh(P),
             capacity_per_shard=2048, max_device_slots=1024)
    t = MeshWindowEngine(TumblingEventTimeWindows.of(500),
                         tagg.SumAggregate("v"), make_mesh(P, "cpu"),
                         capacity_per_shard=2048, max_device_slots=1024)
    ja, ta = _adapters(j, t, "window")
    tt = 0
    for _ in range(8):
        ks = rng.integers(0, 700, 512)
        ts = tt + rng.integers(0, 4000, 512)
        vs = rng.random(512).astype(np.float32)
        jb, tb = _batches(ks, vs, ts)
        j.process_batch(jb)
        t.process_batch(tb)
        tt += 4000
        j.on_watermark(0)
        t.on_watermark(0)
    assert t.spill_counters()["rows_evicted"] > 0
    qk = list(range(0, 700, 3))
    got, _ = ta.lookup_batch(qk)
    same_answers(got, t.query_batch(np.asarray(qk, np.int64)))
    same_answers(got, ja.lookup_batch(qk)[0])
    assert ta.plane.cold_rows_served > 0
    assert ta.plane.cold_flips == ja.plane.cold_flips > 0


@pytest.mark.parametrize("budget", [0, 1024])
@pytest.mark.parametrize("agg", ["sum", "count"])
def test_session_replica_equals_live_reference_and_checkpoint(agg, budget):
    j, t = _session_pair(agg, budget)
    ja, ta = _adapters(j, t, "session")
    stream = _session_stream(len(agg) + budget % 5, steps=8)
    qk = _query_keys(4, keys=4000, n=128).tolist()
    got, answered = _drive_compare(j, t, ja, ta, stream, qk, not budget)
    assert answered > 0
    if budget:
        assert t.spill_counters()["rows_evicted"] > 0
        assert ta.plane.cold_rows_served > 0
    fresh = _session_pair(agg, budget)[1]
    fresh.restore(t.snapshot(mode="savepoint"))
    same_answers(got, fresh.query_batch(np.asarray(qk, np.int64)))


@pytest.mark.parametrize("budget", [0, 1024])
@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
def test_array_index_equals_the_reference_dict_index(kind, budget):
    """The port's array-backed index holds, at every boundary, exactly the
    entries of the reference's ``key -> {ns -> (shard, slot, extra)}``
    dict (resident and cold), and the same publish counters."""
    if kind == "session":
        j, t = _session_pair("sum", budget)
        stream = _session_stream(7 + budget % 5, steps=8)
    else:
        j, t = _window_pair("sum", kind, budget)
        stream = _stream(5 + budget % 7, keys=1500, n=3000, steps=6)
    jp, tp = j.arm_replica(), t.arm_replica()
    for keys, vals, ts, wm in stream:
        jb, tb = _batches(keys, vals, ts)
        j.process_batch(jb)
        t.process_batch(tb)
        # under a budget the watermark stays put: state piles up, evicts
        # and the index gains cold entries
        wm = 0 if budget else wm
        j.on_watermark(wm)
        t.on_watermark(wm)
        want = jp.sealed.index
        got = tp.sealed.index
        kids = sorted(set(want) | set(np.unique(keys).tolist()))
        for k in kids:
            w = {int(n): (int(e[0]), int(e[1]), e[2])
                 for n, e in want.get(k, {}).items()}
            assert (got.get(k) or {}) == w, k
        assert got.count(kids).tolist() == [len(want.get(k, ()))
                                            for k in kids]
    assert tp.counters() == jp.counters()
    if budget:
        assert tp.cold_flips > 0


def test_session_restore_triggers_rebuild():
    """A fresh engine with an armed replica (a cluster restart) restores a
    checkpoint: the next boundary rebuilds the plane and republishes
    every row, equal to the live query."""
    j, t = _session_pair("sum", 0)
    stream = _session_stream(11, steps=4)
    for keys, vals, ts, wm in stream:
        t.process_batch(_batches(keys, vals, ts)[1])
        t.on_watermark(wm)
    snap = t.snapshot(mode="savepoint")
    fresh = _session_pair("sum", 0)[1]
    plane = fresh.arm_replica()
    fresh.on_watermark(-1)  # clears the arm-time rebuild flag
    fresh.restore(snap)     # must set it again
    assert fresh._rep_rebuild
    fresh.on_watermark(stream[-1][3])
    ad = SessionReplicaAdapter(plane, fresh.agg)
    ad.cold_fetch = lambda ks: fresh.query_batch(np.asarray(ks, np.int64))
    qk = list(range(0, 4000, 31))
    got, _ = ad.lookup_batch(qk)
    same_answers(got, fresh.query_batch(np.asarray(qk, np.int64)))
    assert any(got)


def _cache(kind):
    if kind == "native":
        from flink_tpu_torch.native import hotcache_available

        if not hotcache_available():
            pytest.skip("the native hot cache did not build here")
        from flink_tpu_torch.tenancy.hot_cache_native import (
            NativeHotRowCache,
        )

        return NativeHotRowCache(max_entries=1 << 12)
    return HotRowCache(max_entries=1 << 12)


def _one(keys, ts, vals):
    from flink_tpu_torch.core.records import KEY_ID_FIELD

    return RecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, np.int64),
         "value": np.asarray(vals, np.float32)},
        timestamps=np.asarray(ts, np.int64))


@pytest.mark.parametrize("kind", ["native", "python"])
def test_session_end_moves_across_three_boundaries_on_the_hit_path(kind):
    """One session absorbs across three publishes: each publish primes
    the entry under the NEW end and deletes the stale one in the same
    prime, so the hit path serves the right end at every boundary, equal
    to the live query and to a checkpoint restored there."""
    gap = 1000

    def engine():
        return MeshSessionEngine(gap, tagg.SumAggregate("value"),
                                 make_mesh(P, "cpu"),
                                 capacity_per_shard=4096)

    eng = engine()
    plane = eng.arm_replica()
    ad = SessionReplicaAdapter(plane, eng.agg)
    ad.cold_fetch = lambda ks: eng.query_batch(np.asarray(ks, np.int64))
    cache = _cache(kind)
    ad.attach_cache(cache, "j", "op")
    ends, total = [], 0.0
    for b in range(3):
        t = 100 + b * 600
        total += 1.0
        eng.process_batch(_one([5], [t], [1.0]))
        eng.on_watermark(t - 50)
        hits0 = cache.hits
        hit, val = cache.get("j", "op", 5, plane.generation(), exact=False)
        assert hit and cache.hits == hits0 + 1
        assert set(val) == {t + gap}
        assert val[t + gap]["sum_value"] == total
        live = eng.query_batch(np.asarray([5], np.int64))[0]
        assert val == live
        fresh = engine()
        fresh.restore(eng.snapshot(mode="savepoint"))
        assert val == fresh.query_batch(np.asarray([5], np.int64))[0]
        ends.append(t + gap)
    assert len(set(ends)) == 3
    if hasattr(cache, "close"):
        cache.close()


@pytest.mark.parametrize("kind", ["native", "python"])
def test_session_merge_removes_both_stale_ends(kind):
    eng = MeshSessionEngine(1000, tagg.SumAggregate("value"),
                            make_mesh(P, "cpu"), capacity_per_shard=4096)
    plane = eng.arm_replica()
    ad = SessionReplicaAdapter(plane, eng.agg)
    ad.cold_fetch = lambda ks: eng.query_batch(np.asarray(ks, np.int64))
    cache = _cache(kind)
    ad.attach_cache(cache, "j", "op")
    eng.process_batch(_one([5, 5], [100, 1900], [1.0, 2.0]))
    eng.on_watermark(50)
    hit, val = cache.get("j", "op", 5, plane.generation(), exact=False)
    assert hit and set(val) == {1100, 2900}
    eng.process_batch(_one([5], [1000], [4.0]))
    eng.on_watermark(60)
    hit, val = cache.get("j", "op", 5, plane.generation(), exact=False)
    assert hit and set(val) == {2900} and val[2900]["sum_value"] == 7.0
    assert val == eng.query_batch(np.asarray([5], np.int64))[0]
    if hasattr(cache, "close"):
        cache.close()


# ------------------------------------------------------------- join side


def _join_pair(budget):
    from flink_tpu.joins import MeshIntervalJoinEngine as JInterval
    from flink_tpu_torch.joins import MeshIntervalJoinEngine

    kw = {"max_device_slots": budget} if budget else {}
    j = JInterval(-2000, 2000, mesh=jmake_mesh(P), capacity_per_shard=1024,
                  max_parallelism=128, **kw)
    t = MeshIntervalJoinEngine(-2000, 2000, num_shards=P, device="cpu",
                               capacity_per_shard=1024, max_parallelism=128,
                               **kw)
    return j, t


def _join_batches(rng, t, n=512, keys=800):
    ts = (t + rng.integers(0, 500, n)).astype(np.int64)
    cols = {"__key_id__": rng.integers(0, keys, n).astype(np.int64),
            "price": rng.random(n).astype(np.float32),
            "tag": (ts * 7 + 1).astype(np.int64)}
    return (JRecordBatch.from_pydict(dict(cols), timestamps=ts),
            RecordBatch.from_pydict(dict(cols), timestamps=ts))


@pytest.mark.parametrize("budget", [0, 512])
def test_join_side_replica_equals_live_reference_and_checkpoint(budget):
    j, t = _join_pair(budget)
    rng = np.random.default_rng(5)
    qk = list(range(0, 800, 3))
    tt = 400
    for side in (0, 1):
        jb, tb = _join_batches(rng, tt)
        j.process_batch(jb, side)
        t.process_batch(tb, side)
    j.on_watermark(tt - 300)
    t.on_watermark(tt - 300)
    jad, tad = j.arm_side_replica(1), t.arm_side_replica(1)
    jad.cold_fetch = lambda ks: j.query_side_batch(1, np.asarray(ks))
    tad.cold_fetch = lambda ks: t.query_side_batch(1, np.asarray(ks))
    for _ in range(6):
        tt += 400
        for side in (0, 1):
            jb, tb = _join_batches(rng, tt)
            j.process_batch(jb, side)
            before = tad.lookup_batch(qk) if tad.ready() else None
            t.process_batch(tb, side)
            if before is not None:
                same_answers(tad.lookup_batch(qk), before)
        j.on_watermark(tt - 300)
        t.on_watermark(tt - 300)
        got, gen = tad.lookup_batch(qk)
        want, jgen = jad.lookup_batch(qk)
        assert gen == jgen
        same_answers(got, want)
        same_answers(got, t.query_side_batch(1, np.asarray(qk, np.int64)))
    assert gen >= 2 and any(got)
    if budget:
        assert t.spill_counters()["rows_evicted"] > 0
        assert tad.plane.cold_rows_served > 0
    fresh = _join_pair(budget)[1]
    fresh.restore(t.snapshot(mode="savepoint"))
    same_answers(got, fresh.query_side_batch(1, np.asarray(qk, np.int64)))


def test_side_replica_needs_a_device_side():
    from flink_tpu_torch.joins import MeshIntervalJoinEngine

    t = MeshIntervalJoinEngine(-1, 1, num_shards=2, device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        t.arm_side_replica(0)
    h = MeshIntervalJoinEngine(-1, 1, num_shards=2, backend="host")
    h.process_batch(RecordBatch.from_pydict(
        {"__key_id__": np.asarray([1]), "v": np.asarray([1.0], np.float32)},
        timestamps=np.asarray([0])), 0)
    with pytest.raises(RuntimeError, match="device value planes"):
        h.arm_side_replica(0)


# ------------------------------------------------------------------- CEP


@pytest.mark.parametrize("serving", [False, True])
def test_cep_match_replica_equals_live_and_reference(serving):
    from flink_tpu.cep.mesh_engine import (
        CepMatchServingAdapter as JServing,
    )
    from flink_tpu_torch.cep.mesh_engine import CepMatchServingAdapter

    from tests.test_torch_mesh_cep import REF, PORT, gen_steps, mk_batch
    from tests.test_torch_mesh_cep import port as cep_port
    from tests.test_torch_mesh_cep import ref as cep_ref
    from tests.test_torch_queries_mesh import _seq2

    t = cep_port(_seq2, P, match_capacity=64)
    j = cep_ref(_seq2, P, match_capacity=64)
    tad = t.arm_match_replica(serving=serving)
    jad = j.arm_match_replica(serving=serving)
    q = list(range(45))
    answered = 0
    for keys, vals, tss, wm in gen_steps(5, n_steps=8, n_keys=40,
                                         batch=128):
        t.process_batch(mk_batch(PORT[2], keys, vals, tss))
        j.process_batch(mk_batch(REF[2], keys, vals, tss))
        t.on_watermark(wm)
        j.on_watermark(wm)
        got, gen = tad.lookup_batch(q)
        want, jgen = jad.lookup_batch(q)
        assert gen == jgen
        same_answers(got, want)
        live = t.query_match_batch(np.asarray(q, np.int64))
        if serving:
            got = [CepMatchServingAdapter.match_rows(r) for r in got]
            assert got == [JServing.match_rows(r) for r in want]
        same_answers(got, live)
        answered += sum(1 for r in live if r)
    assert answered > 0


# --------------------------------------------------------- hot-cache priming


def _armed_window():
    eng = MeshWindowEngine(TumblingEventTimeWindows.of(5000),
                           tagg.SumAggregate("value"), make_mesh(P, "cpu"),
                           capacity_per_shard=4096)
    plane = eng.arm_replica()
    ad = WindowReplicaAdapter(plane, eng.agg, eng.assigner)
    ad.cold_fetch = lambda ks: eng.query_batch(np.asarray(ks, np.int64))
    cache = HotRowCache(max_entries=1 << 12)
    ad.attach_cache(cache, "j", "op")
    return eng, plane, ad, cache


def _drive_value(eng, n_batches=6, keys=64, per=256, t0=0, step=700):
    rng = np.random.default_rng(7 + t0)
    t = t0
    for _ in range(n_batches):
        eng.process_batch(_one(rng.integers(0, keys, per),
                               t + rng.integers(0, 500, per),
                               rng.random(per).astype(np.float32)))
        t += step
        eng.on_watermark(t - 600)
    return t


def test_prime_keeps_entries_true_across_publishes():
    eng, plane, ad, cache = _armed_window()
    _drive_value(eng, 2)
    qk = list(range(16))
    res, gen = ad.lookup_batch(qk)
    for k, r in zip(qk, res):
        cache.put("j", "op", k, gen, r)
    _drive_value(eng, 3, t0=2 * 700)
    live = eng.query_batch(np.asarray(qk, np.int64))
    for k, want in zip(qk, live):
        hit, val = cache.get("j", "op", k, plane.generation(), exact=False)
        assert hit and val == want
    assert cache.primes > 0


def test_prime_removes_fired_windows():
    eng, plane, ad, cache = _armed_window()
    _drive_value(eng, 2)
    qk = list(range(16))
    res, gen = ad.lookup_batch(qk)
    for k, r in zip(qk, res):
        cache.put("j", "op", k, gen, r)
    eng.on_watermark(10 ** 9)
    live = eng.query_batch(np.asarray(qk, np.int64))
    for k, want in zip(qk, live):
        hit, val = cache.get("j", "op", k, plane.generation(), exact=False)
        if hit:
            assert val == want


def test_rebuild_invalidates_op_entries():
    """A restore rebuilds the plane at the next boundary: this op's cached
    entries drop (a rolled-back value must not serve), another job's
    stay."""
    eng, plane, ad, cache = _armed_window()
    t = _drive_value(eng, 2)
    snap = eng.snapshot(mode="savepoint")
    _drive_value(eng, 2, t0=t)
    cache.put("j", "op", 1, plane.generation(), {"x": 1})
    cache.put("other", "op", 1, 5, {"y": 2})
    eng.restore(snap)
    eng.on_watermark(t - 600)
    hit, val = cache.get("j", "op", 1, plane.generation(), exact=False)
    if hit:
        assert val != {"x": 1}
        assert val == eng.query_batch(np.asarray([1], np.int64))[0]
    assert cache.get("other", "op", 1, 5)[0]


# ------------------------------------------------------------ the plane


class _Leaf:
    dtype = np.float32
    identity = 0.0


def _shard(up, cold=(), freed=(), resident=None):
    """One shard's publish delta: slot s holds key s at namespace s;
    ``resident`` (default: ``up``) the slots holding a row after it."""
    up = np.asarray(up, dtype=np.int64)
    res = np.asarray(up if resident is None else resident, dtype=np.int64)
    used = np.zeros(int(res.max()) + 1 if len(res) else 0, dtype=bool)
    used[res] = True
    ids = np.arange(len(used), dtype=np.int64)
    return {"resident": (used, ids, ids), "up_slots": up.astype(np.int32),
            "up_keys": up, "up_ns": up, "up_extra": None, "cold": list(cold),
            "freed": list(freed), "fresh": bool(len(up))}


@pytest.mark.parametrize("mod", ["port", "reference"])
def test_rebuild_drops_ghost_index_entries(mod):
    if mod == "port":
        plane = ReplicaPlane(make_mesh(2, "cpu"), [_Leaf()], 256)
    else:
        plane = jreplica.ReplicaPlane(jmake_mesh(2), [_Leaf()], 256)
    plane.publish(plane._accs, {0: _shard([7]), 1: _shard([])}, 10)
    assert 7 in plane.sealed.index
    plane.rebuild(plane.mesh, 256)
    plane.publish(plane._accs, {0: _shard([3]), 1: _shard([])}, 20)
    assert 3 in plane.sealed.index and 7 not in plane.sealed.index


@pytest.mark.parametrize("mod", ["port", "reference"])
def test_rebuild_republish_seals_even_when_empty(mod):
    if mod == "port":
        plane = ReplicaPlane(make_mesh(2, "cpu"), [_Leaf()], 256)
    else:
        plane = jreplica.ReplicaPlane(jmake_mesh(2), [_Leaf()], 256)
    plane.publish(plane._accs, {0: _shard([5]), 1: _shard([])}, 10)
    gen = plane.generation()
    plane.rebuild(plane.mesh, 256)
    empty = _shard([])
    assert plane.publish(plane._accs, {0: empty, 1: dict(empty)}, 20)
    assert plane.generation() > gen and 5 not in plane.sealed.index


def test_publish_never_writes_a_sealed_generation():
    """The sealed tensors are fresh at every publish and keep their values
    while the live planes move on (the snapshot isolation the reference
    gets from a functional update)."""
    live = (torch.arange(16, dtype=torch.float32).view(2, 8),)
    plane = ReplicaPlane(make_mesh(2, "cpu"), [_Leaf()], 8)
    plane.publish(live, {0: _shard([1, 2]), 1: _shard([3])}, 1)
    g1 = plane.sealed
    held = g1.accs[0].clone()
    live[0].add_(100.0)                       # the next scatter, in place
    plane.publish(live, {0: _shard([2], resident=[1, 2]),
                         1: _shard([], resident=[3])}, 2)
    g2 = plane.sealed
    assert g2.accs[0] is not g1.accs[0]
    assert torch.equal(g1.accs[0], held)
    assert g2.accs[0][0, 2].item() == 102.0 and g2.accs[0][0, 1].item() == 1
    rows = plane.gather_rows(g1, [(0, 1), (0, 2), (1, 3)])
    assert [r[0] for r in rows] == [1.0, 2.0, 11.0]
    assert plane.gather_rows(g2, [(0, 2)])[0][0] == 102.0


def test_cold_entries_keep_their_payload_and_free():
    plane = ReplicaPlane(make_mesh(2, "cpu"), [_Leaf()], 64)
    s = _shard([4])
    s["up_extra"] = [99]
    plane.publish(plane._accs, {0: s, 1: _shard([])}, 1)
    plane.publish(plane._accs, {0: _shard([], cold=[(4, 4, None),
                                                    (9, 9, 7)]),
                                1: _shard([])}, 2)
    idx = plane.sealed.index
    assert idx[4][4] == (0, COLD_SLOT, 99) and idx[9][9] == (0, COLD_SLOT, 7)
    plane.publish(plane._accs, {0: _shard([], freed=[(4, 4)]),
                                1: _shard([])}, 3)
    assert 4 not in plane.sealed.index and plane.rows_freed == 1


def test_crash_mid_publish_readers_keep_sealed_generation():
    from flink_tpu_torch.chaos import injection as chaos
    from flink_tpu_torch.chaos.injection import (
        FaultPlan,
        FaultRule,
        InjectedFault,
    )

    eng, plane, ad, _ = _armed_window()
    t = _drive_value(eng, 3)
    qk = list(range(16))
    sealed_before, gen = ad.lookup_batch(qk)
    snap = eng.snapshot(mode="savepoint")
    plan = FaultPlan(rules=[FaultRule(pattern="serving.replica_publish",
                                      nth=1)])
    with chaos.chaos_active(plan, seed=1):
        eng.process_batch(_one([1, 2], [t, t], [5.0, 5.0]))
        with pytest.raises(InjectedFault):
            eng.on_watermark(t - 100)
    again, gen2 = ad.lookup_batch(qk)
    assert gen2 == gen and again == sealed_before
    eng.restore(snap)
    eng.on_watermark(t - 100)
    restored, gen3 = ad.lookup_batch(qk)
    assert gen3 > gen
    assert restored == eng.query_batch(np.asarray(qk, np.int64))


def test_operators_arm_serving_replicas():
    """``arm_serving_replica``: the mesh window and session operators hand
    back their adapters with the publish interval set; single-device
    layouts hand back None (they serve through the control queue)."""
    from flink_tpu_torch.runtime.operators import (
        OperatorContext,
        SessionWindowAggOperator,
        WindowAggOperator,
    )

    ctx = OperatorContext(parallelism=4, max_parallelism=128, device="cpu")
    w = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                          tagg.SumAggregate("v"), "key")
    w.open(ctx)
    ad = w.arm_serving_replica(publish_interval_ms=25)
    assert isinstance(ad, WindowReplicaAdapter)
    assert ad.plane.min_interval_s == 0.025
    s = SessionWindowAggOperator(1000, tagg.SumAggregate("v"), "key")
    s.open(ctx)
    assert isinstance(s.arm_serving_replica(), SessionReplicaAdapter)
    one = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                            tagg.SumAggregate("v"), "key")
    one.open(OperatorContext(parallelism=1, max_parallelism=128,
                             device="cpu"))
    assert one.arm_serving_replica() is None


def test_finish_host_equals_the_reference_adapters_finish():
    """The adapters finish host leaves through the aggregate's torch
    ``finish``: Avg's division gives the reference's bits."""
    from flink_tpu.windowing import aggregates as jagg

    rng = np.random.default_rng(2)
    s = rng.standard_normal(64).astype(np.float64)
    c = rng.integers(1, 9, 64).astype(np.int64)
    tl = [a.astype(l.dtype) for a, l in zip(
        (s, c), tagg.AvgAggregate("v").leaves)]
    got = replica.finish_host(tagg.AvgAggregate("v"), tl)
    want = {k: np.asarray(v) for k, v in jagg.AvgAggregate("v").finish(
        tuple(tl)).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].tobytes() == want[k].tobytes()
