"""The port's join engines (``flink_tpu_torch/joins/``) against the
reference's (``flink_tpu/joins/``) on the CPU: the reference's device
backend on the virtual devices of ``tests/conftest.py`` (exchange rank on
its ``xla`` backend, the default), the port on a logical mesh of as many
shards on the CPU.

The counterparts of ``tests/test_device_joins.py``'s classes:
- ``pair_lower_bound`` against the reference's and a brute-force search,
  and the metadata merge against the reference's order;
- the interval and temporal engines against the reference engines and
  against their own ``backend="host"``, under forced paged eviction too
  (spill engaged and asserted, counters equal to the reference's), with
  int64 columns on the host shadow, late left rows dropped and counted;
- snapshots: equal to the reference's array by array, snapshot -> restore
  -> snapshot bit for bit, a restored engine that continues bit-identical
  to an uninterrupted one, restores across the two packages;
- pair-set semantics against the port's host operators;
- the fault points ``join.exchange`` (with its drop / duplicate payload
  rule) and ``join.versioned_lookup`` acting as the reference's do;
- each feature that is not ported raising and naming its ROADMAP item.

Tolerance: none. Every comparison is exact: the same batches in the same
order, every column equal bit for bit (floats compared on their bits),
column names and dtypes equal.
"""

import pathlib
import re

import numpy as np
import pytest

from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.joins import (
    MeshIntervalJoinEngine as JInterval,
    MeshTemporalJoinEngine as JTemporal,
    pair_lower_bound as jpair_lower_bound,
)
from flink_tpu.joins.side_table import _ShardMeta as JShardMeta
from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.joins import (
    MeshIntervalJoinEngine,
    MeshTemporalJoinEngine,
    pair_lower_bound,
)
from flink_tpu_torch.joins.side_table import _ShardMeta
from flink_tpu_torch.runtime.join_operators import (
    IntervalJoinOperator,
    TemporalJoinOperator,
)

_U = {1: np.uint8, 4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def cols(keys, vals, ts, name="v", dtype=np.float32):
    return {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
            name: np.asarray(vals, dtype=dtype),
            TIMESTAMP_FIELD: np.asarray(ts, dtype=np.int64)}


def assert_batches_equal(got, want):
    """Same batches, same order, same columns and dtypes, equal bits."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        assert sorted(a.names()) == sorted(b.names())
        assert len(a) == len(b), (len(a), len(b))
        for n in a.names():
            x, y = np.asarray(a[n]), np.asarray(b[n])
            assert x.dtype == y.dtype, (n, x.dtype, y.dtype)
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=n)


def assert_snapshots_equal(got, want, path=""):
    """Snapshot dicts equal key by key, arrays bit for bit."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_snapshots_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype, (path, g.dtype, want.dtype)
        np.testing.assert_array_equal(_bits(g), _bits(want), err_msg=path)
    else:
        assert [tuple(x) for x in got] == [tuple(x) for x in want] \
            if isinstance(want, list) else got == want, path


def interval_stream(steps=6, n=400, keys=500, span=100, seed=0):
    """(side, columns, watermark) steps, out of order within each batch
    (``tests/test_device_joins.py``'s stream)."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        for side in (0, 1):
            ks = rng.integers(0, keys, n)
            ts = step * span + rng.integers(0, span, n)
            vs = rng.random(n).astype(np.float32)
            out.append((side, cols(ks, vs, ts, "v" if side == 0 else "w"),
                        step * span - 2 * span))
    return out


def drive_interval(eng, stream, batch_cls):
    out = []
    for side, c, wm in stream:
        out += eng.process_batch(batch_cls(c), side)
        eng.on_watermark(wm)
    return out


def temporal_stream(steps=8, seed=1, keys=150, n=300, nv=60, span=100,
                    lag=50):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        out.append((0, cols(rng.integers(0, keys, n),
                            rng.random(n).astype(np.float32),
                            step * span + rng.integers(0, span, n))))
        out.append((1, cols(rng.integers(0, keys, nv),
                            rng.random(nv).astype(np.float32),
                            step * span + rng.integers(0, span, nv),
                            name="rate")))
        out.append(("wm", step * span - lag))
    out.append(("wm", 1 << 40))
    return out


def drive_temporal(eng, stream, batch_cls):
    out = []
    for side, x in stream:
        if side == "wm":
            out += eng.on_watermark(x)
        else:
            out += eng.process_batch(batch_cls(x), side)
    return out


def port(cls, *a, shards=4, **kw):
    return cls(*a, num_shards=shards, device="cpu", **kw)


def ref(cls, *a, shards=4, **kw):
    return cls(*a, mesh=jmake_mesh(shards), **kw)


# ------------------------------------------------------------ lower bound


def test_pair_lower_bound_matches_reference_and_brute_force():
    rng = np.random.default_rng(3)
    k = np.sort(rng.integers(0, 20, 200))
    t = rng.integers(0, 50, 200)
    order = np.lexsort((t, k))
    k, t = k[order], t[order]
    qk = rng.integers(-1, 22, 64)
    qt = rng.integers(-5, 55, 64)
    got = pair_lower_bound(k, t, qk, qt)
    np.testing.assert_array_equal(got, jpair_lower_bound(k, t, qk, qt))
    pairs = list(zip(k.tolist(), t.tolist()))
    for i in range(64):
        assert got[i] == sum(1 for p in pairs if p < (qk[i], qt[i]))
    e = np.empty(0, dtype=np.int64)
    assert len(pair_lower_bound(e, e, e, e)) == 0
    assert pair_lower_bound(e, e, np.array([1]), np.array([2]))[0] == 0


def test_merge_rows_keeps_reference_order_and_rejects_older_rids():
    """Batches merged into a shard's metadata (an unsorted first batch as
    a restore gives it, then batches of newer rids sharing ``(key, ts)``
    with stored rows) keep the reference's full-lexsort order; a batch
    with a rid not above the stored ones is refused."""
    rng = np.random.default_rng(5)
    got, want = _ShardMeta(), JShardMeta()
    rid0 = 0
    for n in (300, 1, 250, 400):
        rid = rng.permutation(np.arange(rid0, rid0 + n)).astype(np.int64)
        rid0 += n
        cols = (rng.integers(0, 30, n).astype(np.int64),
                rng.integers(0, 12, n).astype(np.int64), rid,
                rng.integers(-1, 500, n).astype(np.int32),
                rng.random(n) < 0.5)
        got.merge_rows(*cols)
        want.merge_rows(*cols)
        for name in ("key", "ts", "rid", "slot", "dirty"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    e = np.empty(0, dtype=np.int64)
    got.merge_rows(e, e, e, e.astype(np.int32), e.astype(bool))
    assert len(got) == rid0
    one = np.array([rid0 - 1], dtype=np.int64)
    with pytest.raises(ValueError, match="row ids"):
        got.merge_rows(one, one, one, one.astype(np.int32),
                       np.ones(1, dtype=bool))


# --------------------------------------------------------------- interval

INTERVAL_CASES = {
    # name: (stream kwargs, engine kwargs, shards)
    "plain": (dict(), dict(), 4),
    "forced_eviction": (dict(steps=8, n=700, keys=20_000, span=40),
                        dict(capacity_per_shard=256, max_device_slots=256),
                        4),
    "p8_grow": (dict(steps=5, n=900, keys=3_000, span=60, seed=4),
                dict(capacity_per_shard=256), 8),
}


@pytest.mark.parametrize("case", sorted(INTERVAL_CASES))
def test_interval_engine_matches_reference_bitwise(case):
    skw, ekw, shards = INTERVAL_CASES[case]
    stream = interval_stream(**skw)
    eng = port(MeshIntervalJoinEngine, -30, 40, shards=shards, **ekw)
    jeng = ref(JInterval, -30, 40, shards=shards, **ekw)
    got = drive_interval(eng, stream, RecordBatch)
    want = drive_interval(jeng, stream, JRecordBatch)
    assert sum(len(b) for b in want) > 0
    assert_batches_equal(got, want)
    assert eng.spill_counters() == jeng.spill_counters()
    assert eng._next_rid == jeng._next_rid
    if case == "forced_eviction":
        sc = eng.spill_counters()
        assert sc["rows_evicted"] > 0, "spill never engaged"
        assert sc["cold_rows_served"] > 0, "no probe hit the page tier"


@pytest.mark.parametrize("case", sorted(INTERVAL_CASES))
def test_interval_device_matches_own_host_backend(case):
    skw, ekw, shards = INTERVAL_CASES[case]
    stream = interval_stream(**skw)
    dev = port(MeshIntervalJoinEngine, -30, 40, shards=shards, **ekw)
    host = MeshIntervalJoinEngine(-30, 40, backend="host",
                                  num_shards=shards, **ekw)
    got = drive_interval(dev, stream, RecordBatch)
    want = drive_interval(host, stream, RecordBatch)
    assert sum(len(b) for b in want) > 0
    assert_batches_equal(got, want)
    assert dev.spill_counters() == host.spill_counters()


def test_int64_columns_ride_the_host_shadow_bitwise():
    big = (1 << 60) + 7
    got, want = [], []
    for eng, sink, bc in (
            (port(MeshIntervalJoinEngine, -30, 40), got, RecordBatch),
            (ref(JInterval, -30, 40), want, JRecordBatch)):
        sink += eng.process_batch(bc(cols([1, 2], [big, big + 1], [0, 10],
                                          name="snowflake",
                                          dtype=np.int64)), 0)
        sink += eng.process_batch(bc(cols([1, 2], [5, 6], [5, 15],
                                          name="w")), 1)
    assert_batches_equal(got, want)
    assert got[0]["snowflake"].dtype == np.int64
    assert set(got[0]["snowflake"].tolist()) == {big, big + 1}
    # the int64 column never rode the device plane: the left side's
    # planes are empty
    eng = port(MeshIntervalJoinEngine, -30, 40)
    eng.process_batch(RecordBatch(cols([1], [big], [0], name="snowflake",
                                       dtype=np.int64)), 0)
    assert eng._planes[0] == ()
    assert eng.sides[0].host_cols == [0]


def test_mixed_dtypes_ride_planes_and_shadow_like_reference():
    """float32, int32 and bool on the planes, float64 and int64 on the
    shadow, under forced eviction: every column equal."""
    rng = np.random.default_rng(12)

    def mixed(n, t0):
        return {KEY_ID_FIELD: rng.integers(0, 5_000, n).astype(np.int64),
                "a": rng.random(n).astype(np.float32),
                "b": rng.integers(-9, 9, n).astype(np.int32),
                "c": rng.random(n) < 0.5,
                "d": rng.random(n),
                "e": rng.integers(0, 1 << 62, n).astype(np.int64),
                TIMESTAMP_FIELD: t0 + rng.integers(0, 40, n)}

    stream = []
    for step in range(6):
        stream.append((0, mixed(600, step * 40), step * 40 - 80))
        stream.append((1, mixed(600, step * 40), step * 40 - 80))
    kw = dict(capacity_per_shard=256, max_device_slots=256)
    got = drive_interval(port(MeshIntervalJoinEngine, -20, 20, **kw),
                         stream, RecordBatch)
    want = drive_interval(ref(JInterval, -20, 20, **kw), stream,
                          JRecordBatch)
    assert sum(len(b) for b in want) > 0
    assert_batches_equal(got, want)


def test_shared_key_routing_makes_probes_shard_local():
    eng = port(MeshIntervalJoinEngine, -30, 40)
    out = eng.process_batch(RecordBatch(cols([123], [1.0], [0])), 0)
    out += eng.process_batch(RecordBatch(cols([123], [2.0], [5], "w")), 1)
    assert sum(len(b) for b in out) == 1


def test_invalid_modes_rejected():
    with pytest.raises(ValueError):
        MeshIntervalJoinEngine(-1, 1, backend="gpu")
    with pytest.raises(ValueError):
        MeshIntervalJoinEngine(-1, 1, backend="host", shuffle_mode="magic")
    with pytest.raises(ValueError):
        MeshIntervalJoinEngine(5, 4, backend="host")


def test_cuda_default_raises_without_a_card():
    """The engine's default device is the card: without one it raises
    instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="execution.device"):
        MeshIntervalJoinEngine(-1, 1, num_shards=2)


# --------------------------------------------------------------- temporal


@pytest.mark.parametrize("budget", [0, 256])
def test_temporal_engine_matches_reference_and_host(budget):
    kw = (dict(capacity_per_shard=256, max_device_slots=256) if budget
          else {})
    skw = (dict(steps=6, keys=30_000, n=400, nv=900, span=50, lag=500,
                seed=5) if budget else dict())
    stream = temporal_stream(**skw)
    dev = port(MeshTemporalJoinEngine, **kw)
    got = drive_temporal(dev, stream, RecordBatch)
    jdev = ref(JTemporal, **kw)
    want = drive_temporal(jdev, stream, JRecordBatch)
    host = MeshTemporalJoinEngine(backend="host", num_shards=4, **kw)
    own = drive_temporal(host, stream, RecordBatch)
    assert sum(len(b) for b in want) > 0
    assert_batches_equal(got, want)
    assert_batches_equal(own, want)
    assert dev.spill_counters() == jdev.spill_counters()
    assert dev.late_left_dropped == jdev.late_left_dropped
    if budget:
        sc = dev.spill_counters()
        assert sc["rows_evicted"] > 0 and sc["cold_rows_served"] > 0


@pytest.mark.parametrize("backend", ["device", "host"])
def test_late_left_rows_drop_with_counter(backend):
    kw = dict(device="cpu") if backend == "device" else {}
    eng = MeshTemporalJoinEngine(backend=backend, num_shards=2, **kw)
    jeng = (JTemporal(mesh=jmake_mesh(2)) if backend == "device"
            else JTemporal(backend="host", num_shards=2))
    for e, bc in ((eng, RecordBatch), (jeng, JRecordBatch)):
        e.process_batch(bc(cols([1], [9.0], [100], "rate")), 1)
        e.on_watermark(200)
        assert e.process_batch(bc(cols([1, 1], [1.0, 2.0], [150, 300])),
                               0) == []
        assert e.late_left_dropped == 1   # ts=150 <= watermark 200
        out = e.on_watermark(400)
        assert sum(len(b) for b in out) == 1   # the ts=300 row joined
    assert_batches_equal(eng.on_watermark(500), jeng.on_watermark(500))


# -------------------------------------------------------------- snapshots


def _spilling(cls, backend="device", **kw):
    kw = dict(capacity_per_shard=256, max_device_slots=256, **kw)
    if cls is MeshIntervalJoinEngine:
        return (port(cls, -30, 40, **kw) if backend == "device"
                else cls(-30, 40, backend="host", num_shards=4, **kw))
    return ref(cls, -30, 40, **kw)


def _loaded(cls, backend="device"):
    eng = _spilling(cls, backend)
    drive_interval(eng, interval_stream(steps=4, n=600, keys=20_000,
                                        span=40),
                   RecordBatch if cls is MeshIntervalJoinEngine
                   else JRecordBatch)
    return eng


@pytest.mark.parametrize("backend", ["device", "host"])
def test_snapshot_equals_reference_snapshot(backend):
    snap = _loaded(MeshIntervalJoinEngine, backend).snapshot()
    jsnap = _loaded(JInterval).snapshot()
    assert len(snap["left"]["table"]["key_id"]) > 0
    assert_snapshots_equal(snap, jsnap)


def test_snapshot_restore_snapshot_roundtrip_bitwise():
    eng = _loaded(MeshIntervalJoinEngine)
    s1 = eng.snapshot()
    fresh = _spilling(MeshIntervalJoinEngine)
    fresh.restore(s1)
    s2 = fresh.snapshot()
    assert s2["next_rid"] == s1["next_rid"]
    for side in ("left", "right"):
        t1, t2 = s1[side]["table"], s2[side]["table"]
        assert set(t1) == set(t2)
        for k in t1:
            if k == "dirty":
                continue  # restored rows are the checkpoint's: clean
            np.testing.assert_array_equal(_bits(t1[k]), _bits(t2[k]),
                                          err_msg=f"{side}/{k}")
    # the restore re-homed cold rows into pages, as the reference's does
    j = _spilling(JInterval)
    j.restore(_loaded(JInterval).snapshot())
    assert_snapshots_equal(s2, j.snapshot())


@pytest.mark.parametrize("across", ["port", "ref_to_port", "port_to_ref"])
def test_restored_engine_continues_bit_identical(across):
    """Cut at batch 8: snapshot, a fresh engine restores and continues;
    its output equals an uninterrupted reference run. Across packages the
    snapshot of one restores into the other."""
    stream = interval_stream(steps=8, n=500, keys=20_000, span=40)
    want = drive_interval(_spilling(JInterval), stream, JRecordBatch)
    first = _spilling(JInterval if across == "ref_to_port"
                      else MeshIntervalJoinEngine)
    bc1 = JRecordBatch if across == "ref_to_port" else RecordBatch
    got = drive_interval(first, stream[:8], bc1)
    snap = first.snapshot()
    second = _spilling(JInterval if across == "port_to_ref"
                       else MeshIntervalJoinEngine)
    second.restore(snap)
    bc2 = JRecordBatch if across == "port_to_ref" else RecordBatch
    got += drive_interval(second, stream[8:], bc2)
    assert_batches_equal(got, want)


def test_restore_grows_past_base_capacity_without_spill():
    eng = port(MeshIntervalJoinEngine, -30, 40, shards=2,
               capacity_per_shard=256)
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 100_000, 2000)
    eng.process_batch(RecordBatch(cols(keys, np.ones(2000),
                                       np.arange(2000))), 0)
    snap = eng.snapshot()
    assert len(snap["left"]["table"]["key_id"]) == 2000
    assert eng.sides[0].capacity > 256
    fresh = port(MeshIntervalJoinEngine, -30, 40, shards=2,
                 capacity_per_shard=256)
    fresh.restore(snap)
    assert_snapshots_equal(fresh.snapshot()["left"]["table"]["namespace"],
                           snap["left"]["table"]["namespace"])


def test_temporal_snapshot_carries_pending_and_watermark():
    eng = port(MeshTemporalJoinEngine, shards=2)
    jeng = ref(JTemporal, shards=2)
    for e, bc in ((eng, RecordBatch), (jeng, JRecordBatch)):
        e.process_batch(bc(cols([1, 2], [1.0, 2.0], [50, 60], "rate")), 1)
        e.process_batch(bc(cols([1, 2], [3.0, 4.0], [80, 90])), 0)
        e.on_watermark(70)
    snap = eng.snapshot()
    assert snap["pending"] is not None
    assert_snapshots_equal(snap, jeng.snapshot())
    fresh = port(MeshTemporalJoinEngine, shards=2)
    fresh.restore(snap)
    assert fresh._emitted_wm == eng._emitted_wm
    assert_batches_equal(fresh.on_watermark(1 << 40),
                         jeng.on_watermark(1 << 40))


# -------------------------------------------------- against host operators


def _pairs(batches):
    rows = set()
    for b in batches:
        for r in b.to_rows():
            rows.add(tuple(sorted(r.items())))
    return rows


def test_interval_pairs_equal_host_interval_operator():
    stream = interval_stream(steps=6, n=250, keys=60, span=80, seed=9)
    eng = port(MeshIntervalJoinEngine, -30, 40)
    op = IntervalJoinOperator(-30, 40)
    got, want = [], []
    for side, c, wm in stream:
        got += eng.process_batch(RecordBatch(c), side)
        want += op.process_batch(RecordBatch(c), side)
        eng.on_watermark(wm)
        op.process_watermark(wm)
    assert _pairs(got) == _pairs(want)
    assert len(_pairs(got)) > 0


def test_pruned_rows_never_match_like_host_operator():
    eng = port(MeshIntervalJoinEngine, 0, 10, shards=2)
    op = IntervalJoinOperator(0, 10)
    for o in (eng, op):
        o.process_batch(RecordBatch(cols([7], [1.0], [100])), 0)
    eng.on_watermark(200)
    op.process_watermark(200)
    got = eng.process_batch(RecordBatch(cols([7], [2.0], [105], "w")), 1)
    want = op.process_batch(RecordBatch(cols([7], [2.0], [105], "w")), 1)
    assert _pairs(got) == _pairs(want) == set()


def test_temporal_pairs_equal_host_temporal_operator():
    stream = temporal_stream(steps=6, seed=11, keys=40, n=200, nv=40,
                             lag=30)
    eng = port(MeshTemporalJoinEngine)
    op = TemporalJoinOperator()
    got, want = [], []
    for side, x in stream:
        if side == "wm":
            got += eng.on_watermark(x)
            want += op.process_watermark(x)
        else:
            got += eng.process_batch(RecordBatch(x), side)
            want += op.process_batch(RecordBatch(x), side)
    assert _pairs(got) == _pairs(want)
    assert len(_pairs(got)) > 0
    assert eng.late_left_dropped == op.late_left_dropped


# ------------------------------------------------------------------ chaos


@pytest.mark.parametrize("rules", [
    [("join.exchange", "drop", 2, {"shard": 1})],
    [("join.exchange", "duplicate", 3, {"side": 1})],
    [("join.exchange", "raise", 5, {})],
    [("join.versioned_lookup", "raise", 2, {})],
])
def test_join_fault_points_match_reference(rules):
    """The join fault points sit where the reference's do and act alike:
    a dropped or duplicated shard bucket changes the output identically,
    a raise fires at the same hit; the points hit are counted alike."""
    from flink_tpu.chaos import injection as jchaos
    from flink_tpu_torch.chaos import injection as tchaos

    temporal = rules[0][0] == "join.versioned_lookup"
    results = []
    for mod, eng, bc in (
            (jchaos, ref(JTemporal) if temporal else ref(JInterval, -30, 40),
             JRecordBatch),
            (tchaos, port(MeshTemporalJoinEngine) if temporal
             else port(MeshIntervalJoinEngine, -30, 40), RecordBatch)):
        plan = mod.FaultPlan(rules=[
            mod.FaultRule(pattern=pt, kind=kind, nth=nth,
                          where=tuple(where.items()))
            for pt, kind, nth, where in rules])
        out, raised = [], None
        with mod.chaos_active(plan, seed=0) as c:
            try:
                if temporal:
                    out = drive_temporal(eng, temporal_stream(), bc)
                else:
                    out = drive_interval(eng, interval_stream(), bc)
            except mod.InjectedFault as e:
                raised = e.point
        results.append((out, raised, dict(c.faults_injected),
                        dict(c.points_hit)))
    (jout, jraised, jf, jh), (tout, traised, tf, th) = results
    assert tf == jf and sum(tf.values()) == 1
    assert traised == jraised
    assert th == jh
    assert_batches_equal(tout, jout)


# ------------------------------------------------------- not in this slice

_ROADMAP = (pathlib.Path(__file__).resolve().parent.parent
            / "ROADMAP.md").read_text()


def _item(exc) -> str:
    m = re.search(r"Queue A item (\w+)", str(exc.value))
    assert m, str(exc.value)
    assert f"**Item {m.group(1)} " in _ROADMAP, m.group(1)
    return m.group(1)


@pytest.mark.parametrize("kwargs,item", [
    ({"shuffle_mode": "host"}, "12h"),
    ({"host_topology": object()}, "12h"),
])
def test_unported_options_raise_naming_their_item(kwargs, item):
    with pytest.raises(NotImplementedError) as e:
        port(MeshIntervalJoinEngine, -1, 1, **kwargs)
    assert _item(e) == item


@pytest.mark.parametrize("call,item", [
    (lambda e: e.reshard(2), "12g"),
    (lambda e: e.arm_side_replica(0), "12f"),
    (lambda e: e.query_side_batch(0, [1]), "12e"),
    (lambda e: e.exchange2_traffic(), "12h"),
])
def test_unported_features_raise_naming_their_item(call, item):
    eng = port(MeshIntervalJoinEngine, -1, 1)
    eng.process_batch(RecordBatch(cols([1], [1.0], [0])), 0)
    with pytest.raises(NotImplementedError) as e:
        call(eng)
    assert _item(e) == item
