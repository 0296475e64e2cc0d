"""The port's keyed exchange (flink_tpu_torch/parallel/shuffle.py) against
the JAX reference on the 8-virtual-device mesh.

Tolerance: none. Staging and routing are integer work; the folds are
bit-identical on the CPU because both sides fold each slot's records in
stream order (the reference's all_to_all order is (source shard, rank),
the port's transpose gives the same order, and torch's CPU ``index_add_``
adds in index order like XLA's CPU scatter) — so even float32 sums of
non-integer values must match bit for bit.
"""

import numpy as np
import pytest
import torch

from flink_tpu.parallel import shuffle as jshuffle
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.convert import from_jax_planes
from flink_tpu_torch.parallel import shuffle as tshuffle
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.windowing import aggregates as tagg

P = 8


def _batch(seed, n=4000, cap=2048):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 10_000, n).astype(np.int64)
    shards = jshuffle.shard_records(keys, P, 128)
    slots = rng.integers(1, cap, n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    return keys, shards, slots, vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_and_staging_identical(seed):
    keys, shards, slots, vals = _batch(seed)
    np.testing.assert_array_equal(
        tshuffle.shard_records(keys, P, 128), shards)
    np.testing.assert_array_equal(
        tshuffle.shard_records(keys, P, 128, key_group_range=(16, 79)),
        jshuffle.shard_records(keys, P, 128, key_group_range=(16, 79)))
    want = jshuffle.stage_device_exchange(shards, P, [slots, vals],
                                          fills=[0, 0.0])
    got = tshuffle.stage_device_exchange(shards, P, [slots, vals],
                                         fills=[0, 0.0],
                                         pool=tshuffle.ShuffleBufferPool())
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    assert tshuffle.exchange_chunk_size(len(keys), P) == \
        jshuffle.exchange_chunk_size(len(keys), P)


def _jax_exchange(mesh, agg, dst, staged, width, planes):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from flink_tpu.parallel.mesh import KEY_AXIS

    sharding = NamedSharding(mesh, PartitionSpec(KEY_AXIS))
    accs = tuple(jax.device_put(p, sharding) for p in planes)
    put = jax.device_put((dst, *staged), sharding)
    step = jshuffle.build_exchange_scatter(mesh, agg, valued=False)
    return [np.asarray(a) for a in jax.device_get(list(step(
        accs, put[0], put[1], tuple(put[2:]), width)))]


@pytest.mark.parametrize("kind", ["sum_f32", "count", "max_f32"])
def test_exchange_scatter_planes_bit_identical(eight_device_mesh, kind):
    cap = 2048
    jax_agg, torch_agg = {
        "sum_f32": (jagg.SumAggregate("v"), tagg.SumAggregate("v")),
        "count": (jagg.CountAggregate(), tagg.CountAggregate()),
        "max_f32": (jagg.MaxAggregate("v"), tagg.MaxAggregate("v")),
    }[kind]
    rng = np.random.default_rng(11)
    # non-identity starting planes, carried over to the port
    planes = [rng.integers(0, 50, (P, cap)).astype(l.dtype)
              for l in jax_agg.leaves]
    for p in planes:
        p[:, 0] = jax_agg.leaves[0].identity
    step = tshuffle.build_exchange_scatter(make_mesh(P, "cpu"), torch_agg)
    accs = from_jax_planes(planes, "cpu")
    for seed in range(3):  # several batches: folds compound
        _, shards, slots, vals = _batch(seed, cap=cap)
        cols = [slots] + ([vals] if torch_agg.input_leaves else [])
        fills = [0] + ([0.0] if torch_agg.input_leaves else [])
        dst, staged, width = jshuffle.stage_device_exchange(
            shards, P, cols, fills=fills)
        planes = _jax_exchange(eight_device_mesh, jax_agg, dst, staged,
                               width, planes)
        t = [torch.from_numpy(c) for c in (dst, *staged)]
        accs = step(accs, t[0], t[1], tuple(t[2:]), width)
        for a, p in zip(accs, planes):
            np.testing.assert_array_equal(a.numpy(), p)
