"""Float folds of the port against the JAX reference, bit for bit.

- the slice merge of a fire (``build_mesh_steps``'s fire step) against the
  reference's, for float Sum over k slices and for float Max/Min;
- the CPU path of the ordered fold (``stateplane/fold.py``) against
  ``.at[].add/max/min``;
- the fused exchange+scatter at P = 8 against the reference's on the
  8-virtual-device mesh, with non-integer float values;
- the plain flat exchange rank against the reference's
  ``exchange_rank_flat``.

Inputs come from numpy seeds: standard normals scaled by exp(U(-8, 8)), so
the float sums depend on their order. Tolerance: none — results are
compared on their raw bits (NaN included: both sides write the canonical
quiet NaN).
"""

import numpy as np
import pytest
import torch

from flink_tpu.parallel import shuffle as jshuffle
from flink_tpu.parallel.sharded_windower import (
    build_mesh_steps as jbuild_mesh_steps,
)
from flink_tpu.stateplane.rank import exchange_rank_flat as jax_flat
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.convert import from_jax_planes
from flink_tpu_torch.parallel import shuffle as tshuffle
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_windower import (
    build_mesh_steps as tbuild_mesh_steps,
)
from flink_tpu_torch.stateplane.fold import (
    ordered_scatter_add,
    ordered_scatter_add_plain,
    ordered_scatter_reduce,
    ordered_scatter_reduce_plain,
)
from flink_tpu_torch.stateplane.rank import exchange_rank_flat_plain
from flink_tpu_torch.windowing import aggregates as tagg

P = 8


def _wide(rng, shape):
    """float32 of wide dynamic range: a sum of them depends on its order."""
    return (rng.standard_normal(shape)
            * np.exp(rng.uniform(-8, 8, shape))).astype(np.float32)


def _with_specials(rng, vals):
    """Sprinkle NaN, +0.0 and -0.0 over a float array (max/min cases)."""
    vals = vals.copy()
    pick = rng.random(vals.shape)
    vals[pick < 0.02] = np.nan
    vals[(pick >= 0.02) & (pick < 0.2)] = 0.0
    vals[(pick >= 0.2) & (pick < 0.4)] = -0.0
    return vals


def _bits_equal(got, want):
    got = np.ascontiguousarray(np.asarray(got))
    want = np.ascontiguousarray(np.asarray(want))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _sharded(mesh, arrays):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from flink_tpu.parallel.mesh import KEY_AXIS

    return jax.device_put(arrays, NamedSharding(mesh, PartitionSpec(KEY_AXIS)))


AGGS = {
    "sum": (jagg.SumAggregate, tagg.SumAggregate),
    "max": (jagg.MaxAggregate, tagg.MaxAggregate),
    "min": (jagg.MinAggregate, tagg.MinAggregate),
}


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("reduce", sorted(AGGS))
def test_fire_merge_bit_identical(eight_device_mesh, reduce, k):
    """A fire merges each row's k slices in the reference's order: for a
    float Sum the left fold ((0 + x0) + x1) + ... of XLA's CPU reduce (k = 5
    is HOP 10 s / 2 s); for Max/Min NaN wins and -0.0 < +0.0."""
    rng = np.random.default_rng(100 + k)
    cap, W = 4096, 512
    plane = _wide(rng, (P, cap))
    if reduce != "sum":
        plane = _with_specials(rng, plane)
    plane[:, 0] = AGGS[reduce][0]("v").leaves[0].identity
    sm = rng.integers(0, cap, (P, W, k)).astype(np.int32)
    jfire = jbuild_mesh_steps(eight_device_mesh, AGGS[reduce][0]("v"))[1]
    tfire = tbuild_mesh_steps(make_mesh(P, "cpu"), AGGS[reduce][1]("v"))[1]
    jout = jfire(tuple(_sharded(eight_device_mesh, [plane])),
                 _sharded(eight_device_mesh, sm))
    tout = tfire(from_jax_planes([plane], "cpu"), torch.from_numpy(sm))
    assert sorted(jout) == sorted(tout)
    for name in jout:
        _bits_equal(tout[name].numpy(), jout[name])


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_cpu_ordered_fold_matches_scatter(reduce):
    """The CPU path of the ordered fold against XLA's scatter, with many
    lanes per slot (hot slots included) and slot 0 hit by identity
    lanes."""
    import jax.numpy as jnp

    rng = np.random.default_rng({"sum": 1, "max": 2, "min": 3}[reduce])
    n, slots = 1 << 16, 4096
    hot = rng.random(n) < 0.3
    target = np.where(hot, rng.integers(1, 8, n),
                      rng.integers(0, slots, n)).astype(np.int64)
    v = _wide(rng, n)
    if reduce != "sum":
        v = _with_specials(rng, v)
    ident = np.float32({"sum": 0.0, "max": -np.inf, "min": np.inf}[reduce])
    v[target == 0] = ident
    acc = _wide(rng, slots)
    acc[0] = ident
    want = np.asarray(getattr(jnp.asarray(acc).at[target],
                              {"sum": "add"}.get(reduce, reduce))(v))
    got = ordered_scatter_reduce_plain(torch.from_numpy(acc.copy()),
                                       torch.from_numpy(target),
                                       torch.from_numpy(v), reduce)
    _bits_equal(got.numpy(), want)
    assert got[0].item() == ident
    # the wrapper takes the plain version for a CPU tensor
    before = ordered_scatter_add.launches
    wrapped = ordered_scatter_reduce(torch.from_numpy(acc.copy()),
                                     torch.from_numpy(target),
                                     torch.from_numpy(v), reduce)
    assert torch.equal(wrapped.view(torch.int32), got.view(torch.int32))
    assert ordered_scatter_add.launches == before


def test_cpu_ordered_scatter_add_is_index_add():
    rng = np.random.default_rng(4)
    target = torch.from_numpy(rng.integers(0, 64, 5000).astype(np.int64))
    v = torch.from_numpy(_wide(rng, 5000))
    want = ordered_scatter_add_plain(torch.zeros(64), target, v)
    got = ordered_scatter_add(torch.zeros(64), target, v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


EXCHANGE_AGGS = {
    "sum_f32": (lambda: jagg.SumAggregate("v"),
                lambda: tagg.SumAggregate("v")),
    "avg_f32": (lambda: jagg.AvgAggregate("v"),
                lambda: tagg.AvgAggregate("v")),
    "max_f32": (lambda: jagg.MaxAggregate("v"),
                lambda: tagg.MaxAggregate("v")),
    "min_f32": (lambda: jagg.MinAggregate("v"),
                lambda: tagg.MinAggregate("v")),
}


@pytest.mark.parametrize("kind", sorted(EXCHANGE_AGGS))
def test_exchange_scatter_float_bit_identical(eight_device_mesh, kind):
    """build_exchange_scatter at P = 8 against the reference's, over
    several batches of non-integer floats from a wide range, skewed keys
    included."""
    import jax

    jax_agg, torch_agg = (f() for f in EXCHANGE_AGGS[kind])
    rng = np.random.default_rng(sorted(EXCHANGE_AGGS).index(kind))
    cap, n = 2048, 6000
    planes = []
    for leaf in jax_agg.leaves:
        p = (_wide(rng, (P, cap)) if leaf.const is None
             else rng.integers(0, 9, (P, cap)).astype(leaf.dtype))
        p[:, 0] = leaf.identity
        planes.append(p)
    step = tshuffle.build_exchange_scatter(make_mesh(P, "cpu"), torch_agg)
    jstep = jshuffle.build_exchange_scatter(eight_device_mesh, jax_agg,
                                            valued=False)
    accs = from_jax_planes(planes, "cpu")
    for _ in range(3):
        keys = np.where(rng.random(n) < 0.4, rng.integers(0, 20, n),
                        rng.integers(0, 50_000, n)).astype(np.int64)
        shards = jshuffle.shard_records(keys, P, 128)
        slots = (keys % (cap - 1) + 1).astype(np.int32)
        vals = _wide(rng, n)
        if kind in ("max_f32", "min_f32"):
            vals = _with_specials(rng, vals)
        dst, staged, width = jshuffle.stage_device_exchange(
            shards, P, [slots, vals], fills=[0, jax_agg.leaves[0].identity])
        put = _sharded(eight_device_mesh, (dst, *staged))
        planes = [np.asarray(a) for a in jax.device_get(list(jstep(
            tuple(_sharded(eight_device_mesh, planes)), put[0], put[1],
            tuple(put[2:]), width)))]
        t = [torch.from_numpy(c) for c in (dst, *staged)]
        accs = step(accs, t[0], t[1], tuple(t[2:]), width)
        for a, p in zip(accs, planes):
            _bits_equal(a.numpy(), p)


def _flat_cases(seed=23, n_cases=30):
    rng = np.random.default_rng(seed)
    for _ in range(n_cases):
        D = int(rng.integers(1, 17))
        n = int(rng.integers(1, 700))
        W = int(rng.integers(1, 40))   # small: many ranks >= W
        yield D, W, rng.integers(-3, D + 4, size=n).astype(np.int32)


@pytest.mark.parametrize("case", range(30))
def test_flat_rank_plain_matches_reference(case):
    """exchange_rank_flat_plain against the reference's
    exchange_rank_flat: negative lanes, lanes at and above D, and ranks
    at or above W all included."""
    D, W, d = list(_flat_cases())[case]
    got = exchange_rank_flat_plain(torch.from_numpy(d), D, W)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_flat(d, D, W, "xla")))


def _revenue_rows(pkg: str, shorthand: str):
    """Revenue-style job through the public API's WindowedStream
    shorthands at parallelism 8 (the Q5-revenue shape, cut to size)."""
    if pkg == "torch":
        from flink_tpu_torch import Configuration, StreamExecutionEnvironment
        from flink_tpu_torch.benchmarks.nexmark import BidSource
        from flink_tpu_torch.connectors.sinks import CollectSink
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
        from flink_tpu_torch.windowing.assigners import (
            SlidingEventTimeWindows,
        )
        conf = {"execution.device": "cpu"}
    else:
        from flink_tpu.benchmarks.nexmark import BidSource
        from flink_tpu.connectors.sinks import CollectSink
        from flink_tpu.core.config import Configuration
        from flink_tpu.datastream.environment import (
            StreamExecutionEnvironment,
        )
        from flink_tpu.runtime.watermarks import WatermarkStrategy
        from flink_tpu.windowing.assigners import SlidingEventTimeWindows
        conf = {}
    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": 1 << 14, "parallelism.default": 8,
        **conf}))
    sink = CollectSink()
    windowed = (env.from_source(
        BidSource(total_records=60_000, num_auctions=2_000,
                  events_per_second_of_eventtime=20_000),
        WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(10_000, 2_000)))
    out = (windowed.count() if shorthand == "count"
           else getattr(windowed, shorthand)("price"))
    out.sink_to(sink)
    env.execute()
    return sorted(sink.rows(), key=lambda r: (r["window_end"], r["auction"]))


@pytest.mark.parametrize("shorthand", ["sum", "avg", "max", "min", "count"])
def test_revenue_job_shorthands_bit_identical(shorthand):
    """The slice as a whole: Q5-revenue's job (bids keyed by auction, HOP
    10 s / 2 s, a float aggregate of the non-integer price) through the
    ported shorthands equals the reference's run row for row, every value
    compared on its float64 bits."""
    got, want = _revenue_rows("torch", shorthand), _revenue_rows("jax",
                                                                 shorthand)
    assert len(got) == len(want) > 0
    cols = sorted(want[0])
    assert sorted(got[0]) == cols
    for c in cols:
        g = np.array([r[c] for r in got], dtype=np.float64)
        w = np.array([r[c] for r in want], dtype=np.float64)
        np.testing.assert_array_equal(g.view(np.int64), w.view(np.int64),
                                      err_msg=c)
