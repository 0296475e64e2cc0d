"""The port's MeshWindowEngine against the JAX reference's on the same
batches and watermarks (8 shards: the reference on its 8-virtual-device
mesh, the port on an 8-shard logical mesh on the CPU).

The port starts from the reference's state: after the first batch both
planes are compared, then the reference's planes are carried into the port
with ``from_jax_planes`` and both engines go on from there.

Tolerance: none — fired rows (keys, window bounds, results, row order) are
equal. Count is integer; the float32 Sum and Avg run twice: on
integer-valued inputs, where every fold is exact in any order, and on
non-integer values of wide range, where the ingest folds and the slice
merges must take the reference's order to give its bits.
"""

import numpy as np
import pytest
import torch

from flink_tpu.core.records import RecordBatch as JBatch
from flink_tpu.parallel.sharded_windower import (
    MeshWindowEngine as JEngine,
    build_mesh_steps as jbuild_mesh_steps,
)
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing import assigners as jasg
from flink_tpu.windowing.fire_projectors import TopKFireProjector as JTopK
from flink_tpu_torch.convert import from_jax_planes
from flink_tpu_torch.core.records import RecordBatch as TBatch
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_windower import (
    MeshWindowEngine as TEngine,
    build_mesh_steps as tbuild_mesh_steps,
)
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing import assigners as tasg
from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector as TTopK

P = 8


def _steps(seed, n_steps=6, per_step=3000, num_keys=2000, span=700,
           wide=False):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        if wide:  # non-integer values of wide range: order shows
            vals = (rng.standard_normal(per_step)
                    * np.exp(rng.uniform(-8, 8, per_step))
                    ).astype(np.float32)
        else:
            vals = rng.integers(0, 1000, per_step).astype(np.float32)
        ts = rng.integers(s * span, s * span + span,
                          per_step).astype(np.int64)
        out.append((keys, vals, ts, s * span - 1))
    return out


def _batch(cls, keys, vals, ts):
    return cls({"__key_id__": keys, "v": vals, "__ts__": ts})


def _rows(batches):
    out = []
    for b in batches:
        cols = sorted(b.columns)
        out.append({c: np.asarray(b.columns[c]).tolist() for c in cols})
    return out


def _planes(jengine):
    import jax

    return [np.asarray(a) for a in jax.device_get(list(jengine.accs))]


CASES = {
    "sliding_count": (lambda m: m.SlidingEventTimeWindows.of(1000, 250),
                      lambda a: a.CountAggregate(), False, False),
    "sliding_sum_topk": (lambda m: m.SlidingEventTimeWindows.of(1000, 500),
                         lambda a: a.SumAggregate("v"), True, False),
    "tumbling_sum": (lambda m: m.TumblingEventTimeWindows.of(500),
                     lambda a: a.SumAggregate("v"), False, False),
    "tumbling_sum_wide": (lambda m: m.TumblingEventTimeWindows.of(500),
                          lambda a: a.SumAggregate("v"), False, True),
    "sliding_sum_wide": (lambda m: m.SlidingEventTimeWindows.of(1000, 200),
                         lambda a: a.SumAggregate("v"), False, True),
    "sliding_avg_wide": (lambda m: m.SlidingEventTimeWindows.of(1000, 200),
                         lambda a: a.AvgAggregate("v"), False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fired_rows_equal_reference(eight_device_mesh, case):
    assigner, agg, topk, wide = CASES[case]
    jeng = JEngine(assigner(jasg), agg(jagg), eight_device_mesh,
                   capacity_per_shard=1024, max_parallelism=128,
                   fire_projector=JTopK("sum_v" if "sum" in case
                                        else "count", k=8)
                   if topk else None)
    teng = TEngine(assigner(tasg), agg(tagg), make_mesh(P, "cpu"),
                   capacity_per_shard=1024, max_parallelism=128,
                   fire_projector=TTopK("sum_v" if "sum" in case
                                        else "count", k=8)
                   if topk else None)
    fired_j, fired_t = [], []
    steps = _steps(list(CASES).index(case), wide=wide)
    for i, (keys, vals, ts, wm) in enumerate(steps):
        jeng.process_batch(_batch(JBatch, keys, vals, ts))
        teng.process_batch(_batch(TBatch, keys, vals, ts))
        if i == 0:
            planes = _planes(jeng)
            for a, p in zip(teng.accs, planes):
                np.testing.assert_array_equal(a.numpy(), p)
            # carry the reference's state into the port
            teng.accs = from_jax_planes(planes, "cpu")
        fired_j += jeng.on_watermark(wm)
        fired_t += teng.on_watermark(wm)
    fired_j += jeng.on_watermark(1 << 62)
    fired_t += teng.on_watermark(1 << 62)
    assert len(fired_t) > 3
    assert _rows(fired_t) == _rows(fired_j)
    for a, p in zip(teng.accs, _planes(jeng)):  # frees reset alike
        np.testing.assert_array_equal(a.numpy(), p)


def test_mesh_steps_match_reference(eight_device_mesh):
    """The scatter / fire / reset steps of build_mesh_steps on the same
    [P, cap] planes and [P, B] blocks."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from flink_tpu.parallel.mesh import KEY_AXIS

    sh = NamedSharding(eight_device_mesh, PartitionSpec(KEY_AXIS))
    rng = np.random.default_rng(5)
    cap, B = 1024, 256
    for jagg_, tagg_ in [(jagg.SumAggregate("v"), tagg.SumAggregate("v")),
                         (jagg.CountAggregate(), tagg.CountAggregate()),
                         (jagg.MinAggregate("v"), tagg.MinAggregate("v"))]:
        leaf = jagg_.leaves[0]
        plane = np.full((P, cap), leaf.identity, dtype=leaf.dtype)
        slots = rng.integers(0, cap, (P, B)).astype(np.int32)
        vals = rng.integers(-50, 50, (P, B)).astype(leaf.dtype)
        js, jf, jr = jbuild_mesh_steps(eight_device_mesh, jagg_)[:3]
        ts, tf, tr = tbuild_mesh_steps(make_mesh(P, "cpu"), tagg_)[:3]
        inputs = (vals,) if tagg_.input_leaves else ()
        jaccs = js((jax.device_put(plane, sh),), jax.device_put(slots, sh),
                   tuple(jax.device_put(v, sh) for v in inputs))
        taccs = ts(from_jax_planes([plane], "cpu"), torch.from_numpy(slots),
                   tuple(torch.from_numpy(v) for v in inputs))
        np.testing.assert_array_equal(taccs[0].numpy(), np.asarray(jaccs[0]))
        sm = rng.integers(0, cap, (P, 64, 5)).astype(np.int32)
        jout = jf(jaccs, jax.device_put(sm, sh))
        tout = tf(taccs, torch.from_numpy(sm))
        assert sorted(jout) == sorted(tout)
        for name in jout:
            np.testing.assert_array_equal(tout[name].numpy(),
                                          np.asarray(jout[name]))
        freed = rng.integers(0, cap, (P, 128)).astype(np.int32)
        jaccs = jr(jaccs, jax.device_put(freed, sh))
        taccs = tr(taccs, torch.from_numpy(freed))
        np.testing.assert_array_equal(taccs[0].numpy(), np.asarray(jaccs[0]))


def test_unported_features_raise():
    asg, agg = tasg.TumblingEventTimeWindows.of(100), tagg.CountAggregate()
    mesh = make_mesh(P, "cpu")
    with pytest.raises(NotImplementedError, match="two-level"):
        TEngine(asg, agg, mesh, host_topology=object())
    with pytest.raises(NotImplementedError, match="shuffle.mode"):
        TEngine(asg, agg, mesh, shuffle_mode="host")
    eng = TEngine(asg, agg, mesh)
    for call in (lambda: eng.reassign_key_groups({}),
                 lambda: eng.arm_replica()):
        with pytest.raises(NotImplementedError):
            call()
