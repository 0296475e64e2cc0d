"""Host shuffle mode of the port (``shuffle.mode=host``:
``flink_tpu_torch/parallel/shuffle.py`` ``bucket_by_shard`` and the
engines' ``[P, B]`` paths) against the reference's, on the CPU.

- ``bucket_by_shard``: counts, blocks and the applied order equal the
  reference's array by array, with a pool too, and under its chaos points
  (``shuffle.bucket_send`` drop and duplicate, ``shuffle.bucket_prep``
  raise) acting as the reference's;
- every engine's host mode against the reference's host mode and the
  port's device mode: the window engine (plain, valued partials, a
  device budget with eviction), the session engine (both spill layouts),
  the temporal join, and ``shuffle.mode=host`` through ``env.execute()``;
- ``make_all_to_all_repartition`` and ``make_global_combine`` on the
  cases of ``tests/test_mesh_parallel.py``.

Tolerance: none; floats are compared on their bits.
"""

import numpy as np
import pytest
import torch

from flink_tpu.chaos import injection as jchaos
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.parallel import shuffle as jshuffle
from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.parallel import shuffle as tshuffle
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.windowing import aggregates as tagg

_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def _case(seed=1, n=2000, P=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, P, n).astype(np.int64),
            rng.integers(0, 1 << 40, n).astype(np.int64),
            rng.random(n).astype(np.float32))


def _assert_bucketing_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if len(want) > 2:
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("pooled", [False, True], ids=["fresh", "pool"])
def test_bucket_by_shard_equals_the_references(pooled):
    shards, keys, vals = _case()
    tpool, jpool = ((tshuffle.ShuffleBufferPool(), jshuffle.ShuffleBufferPool())
                    if pooled else (None, None))
    for _ in range(2):  # the pool's second generation too
        got = tshuffle.bucket_by_shard(shards, 8, [keys, vals], [0, 0.0],
                                       pool=tpool, want_order=True)
        want = jshuffle.bucket_by_shard(shards, 8, [keys, vals], [0, 0.0],
                                        pool=jpool, want_order=True)
        _assert_bucketing_equal(got, want)
        if pooled:
            tpool.flip()
            jpool.flip()
    counts, blocks = tshuffle.bucket_by_shard(shards, 8, [keys], [0])
    for p in range(8):
        np.testing.assert_array_equal(blocks[0][p, :counts[p]],
                                      keys[shards == p])
    empty = tshuffle.bucket_by_shard(np.zeros(0, np.int64), 4,
                                     [np.zeros(0, np.int64)], [0])
    _assert_bucketing_equal(empty, jshuffle.bucket_by_shard(
        np.zeros(0, np.int64), 4, [np.zeros(0, np.int64)], [0]))


@pytest.mark.parametrize("kind", ["drop", "duplicate"])
def test_bucket_send_faults_equal_the_references(kind):
    shards, keys, vals = _case(seed=2)
    out = {}
    for pkg, chaos, mod in (("port", tchaos, tshuffle),
                            ("ref", jchaos, jshuffle)):
        plan = chaos.FaultPlan(rules=[chaos.FaultRule(
            pattern="shuffle.bucket_send", kind=kind, nth=1,
            where={"shard": 3})])
        with chaos.chaos_active(plan, seed=9) as ctl:
            out[pkg] = mod.bucket_by_shard(shards, 8, [keys, vals],
                                           [0, 0.0])
            out[pkg + "_hits"] = dict(ctl.points_hit)
            out[pkg + "_faults"] = dict(ctl.faults_injected)
    _assert_bucketing_equal(out["port"], out["ref"])
    assert out["port_hits"] == out["ref_hits"]
    assert out["port_faults"] == out["ref_faults"]
    c3 = int((shards == 3).sum())
    assert out["port"][0][3] == (0 if kind == "drop" else 2 * c3)


def test_bucket_prep_raise_equals_the_references():
    shards, keys, _ = _case(seed=4)
    for chaos, mod in ((tchaos, tshuffle), (jchaos, jshuffle)):
        plan = chaos.FaultPlan(rules=[chaos.FaultRule(
            pattern="shuffle.bucket_prep", kind="raise", nth=1)])
        with chaos.chaos_active(plan, seed=1):
            with pytest.raises(chaos.InjectedFault):
                mod.bucket_by_shard(shards, 8, [keys], [0])


# ---------------------------------------------------------------- engines


def _batch(cls, keys, vals, ts):
    return cls.from_pydict({KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
                            "v": np.asarray(vals, dtype=np.float32)},
                           timestamps=np.asarray(ts, dtype=np.int64))


def _fired(batches, field="sum_v"):
    out = []
    for b in batches:
        out.extend(zip(np.asarray(b[KEY_ID_FIELD]).tolist(),
                       b["window_start"].tolist(), b["window_end"].tolist(),
                       _bits(np.asarray(b[field])).tolist()))
    return out


def _steps(num_keys=6000, n_steps=5, per_step=3000, seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_steps):
        out.append((rng.integers(0, num_keys, per_step).astype(np.int64),
                    rng.random(per_step).astype(np.float32),
                    rng.integers(s * 80, s * 80 + 60, per_step)
                    .astype(np.int64), (s - 1) * 80))
    out.append((np.array([0], np.int64), np.array([0.0], np.float32),
                np.array([n_steps * 80 + 10_000], np.int64), 1 << 40))
    return out


def _drive(eng, steps, cls, partial_prefix=None):
    fired = []
    for keys, vals, ts, wm in steps:
        b = _batch(cls, keys, vals, ts)
        if partial_prefix is not None:
            b = b.with_column(partial_prefix + "0", vals)
        eng.process_batch(b)
        fired.extend(eng.on_watermark(wm))
    return _fired(fired)


def _window(pkg, **kw):
    if pkg == "ref":
        from flink_tpu.parallel.sharded_windower import MeshWindowEngine
        from flink_tpu.windowing.assigners import SlidingEventTimeWindows

        return MeshWindowEngine(SlidingEventTimeWindows.of(100, 50),
                                jagg.SumAggregate("v"), jmake_mesh(8),
                                capacity_per_shard=1 << 12, **kw)
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    return MeshWindowEngine(SlidingEventTimeWindows.of(100, 50),
                            tagg.SumAggregate("v"), make_mesh(8, "cpu"),
                            capacity_per_shard=1 << 12, **kw)


@pytest.mark.parametrize("budget", [0, 1024], ids=["resident", "budget"])
def test_window_engine_host_mode(budget):
    kw = {"max_device_slots": budget} if budget else {}
    steps = _steps()
    want_eng = _window("ref", shuffle_mode="host", **kw)
    want = _drive(want_eng, steps, JRecordBatch)
    got_eng = _window("port", shuffle_mode="host", **kw)
    got = _drive(got_eng, steps, RecordBatch)
    assert got == want and len(got) > 1000
    assert got == _drive(_window("port", **kw), steps, RecordBatch)
    assert got_eng.spill_counters() == want_eng.spill_counters()
    if budget:
        assert got_eng.spill_counters()["rows_evicted"] > 0


def test_window_engine_host_mode_valued_partials():
    from flink_tpu.runtime.local_agg import PARTIAL_LEAF_PREFIX as JPRE
    from flink_tpu_torch.runtime.local_agg import PARTIAL_LEAF_PREFIX

    steps = _steps(n_steps=3)
    want = _drive(_window("ref", shuffle_mode="host"), steps, JRecordBatch,
                  JPRE)
    got = _drive(_window("port", shuffle_mode="host"), steps, RecordBatch,
                 PARTIAL_LEAF_PREFIX)
    assert got == want
    assert got == _drive(_window("port"), steps, RecordBatch,
                         PARTIAL_LEAF_PREFIX)


@pytest.mark.parametrize("layout", ["pages", "namespaces"])
def test_session_engine_host_mode(layout):
    def make(pkg, **kw):
        if pkg == "ref":
            from flink_tpu.parallel.sharded_sessions import (
                MeshSessionEngine,
            )

            return MeshSessionEngine(60, jagg.SumAggregate("v"),
                                     jmake_mesh(8), spill_layout=layout,
                                     capacity_per_shard=1 << 12,
                                     max_device_slots=1024, **kw)
        from flink_tpu_torch.parallel.sharded_sessions import (
            MeshSessionEngine,
        )

        return MeshSessionEngine(60, tagg.SumAggregate("v"),
                                 make_mesh(8, "cpu"), spill_layout=layout,
                                 capacity_per_shard=1 << 12,
                                 max_device_slots=1024, **kw)

    steps = _steps(num_keys=12_000)
    want_eng = make("ref", shuffle_mode="host")
    want = _drive(want_eng, steps, JRecordBatch)
    got_eng = make("port", shuffle_mode="host")
    got = _drive(got_eng, steps, RecordBatch)
    assert got == want and len(got) > 1000
    assert got == _drive(make("port"), steps, RecordBatch)
    assert got_eng.spill_counters() == want_eng.spill_counters()
    assert got_eng.spill_counters()["rows_evicted"] > 0


def test_temporal_join_host_mode():
    from flink_tpu.joins import MeshTemporalJoinEngine as JTemporal
    from flink_tpu_torch.joins import MeshTemporalJoinEngine

    rng = np.random.default_rng(8)
    steps = []
    for s in range(6):
        for side in (0, 1):
            n = 300
            cols = {KEY_ID_FIELD: rng.integers(0, 120, n).astype(np.int64),
                    ("v" if side == 0 else "w"):
                        rng.random(n).astype(np.float32),
                    TIMESTAMP_FIELD: (s * 100 + rng.integers(0, 100, n))
                    .astype(np.int64)}
            steps.append((side, cols, s * 100 - 50))

    def drive(eng, cls):
        out = []
        for side, cols, wm in steps:
            out += eng.process_batch(cls(cols), side)
            out += eng.on_watermark(wm)
        return [tuple(sorted((k, _bits(np.asarray(v)).item())
                             for k, v in r.items()))
                for b in out for r in b.to_rows()]

    want = drive(JTemporal(mesh=jmake_mesh(4), shuffle_mode="host",
                           capacity_per_shard=1024), JRecordBatch)
    got = drive(MeshTemporalJoinEngine(num_shards=4, device="cpu",
                                       shuffle_mode="host",
                                       capacity_per_shard=1024),
                RecordBatch)
    assert got == want and len(got) > 0
    assert got == drive(MeshTemporalJoinEngine(num_shards=4, device="cpu",
                                               capacity_per_shard=1024),
                        RecordBatch)


@pytest.mark.parametrize("kind", ["tumble", "session"])
def test_host_shuffle_mode_through_execute(kind):
    import flink_tpu
    import flink_tpu_torch

    rng = np.random.default_rng(6)
    n = 5000
    rows = [{"k": int(k), "v": float(v), "t": int(t)}
            for k, v, t in zip(rng.integers(0, 700, n),
                               rng.random(n).astype(np.float32),
                               rng.integers(0, 600, n))]

    def run(top, mode):
        conf = {"parallelism.default": 8, "execution.micro-batch.size": 700,
                "shuffle.mode": mode}
        if top is flink_tpu_torch:
            conf["execution.device"] = "cpu"
        env = top.StreamExecutionEnvironment(top.Configuration(conf))
        asg = __import__(f"{top.__name__}.windowing.assigners",
                         fromlist=["x"])
        agg = __import__(f"{top.__name__}.windowing.aggregates",
                         fromlist=["x"])
        sink = __import__(f"{top.__name__}.connectors.sinks",
                          fromlist=["x"]).CollectSink()
        w = (asg.TumblingEventTimeWindows.of(100) if kind == "tumble"
             else asg.EventTimeSessionWindows.with_gap(15))
        (env.from_collection(rows, timestamp_field="t").key_by("k")
         .window(w).aggregate(agg.SumAggregate("v")).sink_to(sink))
        env.execute("host-mode")
        return sorted((r["k"], r["window_start"], r["window_end"],
                       _bits(np.float32(r["sum_v"])).item())
                      for r in sink.rows())

    got = run(flink_tpu_torch, "host")
    assert got == run(flink_tpu, "host") == run(flink_tpu_torch, "device")
    assert len(got) > 100


# ------------------------------------------------------------ collectives


def test_all_to_all_repartition():
    """``tests/test_mesh_parallel.py``'s case: block [src, dst] moves to
    [dst, src]."""
    x = np.arange(8 * 8 * 4, dtype=np.float32).reshape(8, 8, 4)
    repart = tshuffle.make_all_to_all_repartition(make_mesh(8, "cpu"))
    np.testing.assert_array_equal(repart(torch.from_numpy(x)).numpy(),
                                  x.transpose(1, 0, 2))
    with pytest.raises(ValueError):
        repart(torch.zeros(4, 8, 2))


@pytest.mark.parametrize("reduce,partials,want", [
    ("sum", np.ones((8, 5), np.float32) * np.arange(8, dtype=np.float32)
     [:, None], np.full(5, 28.0)),
    ("max", np.arange(8, dtype=np.float32)[:, None]
     * np.ones((8, 3), np.float32), np.full(3, 7.0)),
    ("min", np.arange(8, dtype=np.float32)[:, None]
     * np.ones((8, 3), np.float32), np.zeros(3)),
])
def test_global_combine(reduce, partials, want):
    import jax.numpy as jnp

    combine = tshuffle.make_global_combine(make_mesh(8, "cpu"), reduce)
    got = combine(torch.from_numpy(partials)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    ref = jshuffle.make_global_combine(jmake_mesh(8), reduce)
    np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(partials))))
