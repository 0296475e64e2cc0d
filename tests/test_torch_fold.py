"""Float folds of the port against the JAX reference, bit for bit.

- the slice merge of a fire (``build_mesh_steps``'s fire step) against the
  reference's, for float Sum over k slices and for float Max/Min;
- the CPU path of the ordered fold (``stateplane/fold.py``) against
  ``.at[].add/max/min``;
- the fused exchange+scatter at P = 8 against the reference's on the
  8-virtual-device mesh, with non-integer float values;
- the plain flat exchange rank against the reference's
  ``exchange_rank_flat``;
- the NaN bits of float sums (an ``inf - inf``, NaN payloads, a NaN in the
  accumulator) in the ingest scatter against ``.at[].add`` and in the
  slice merge against ``jnp.sum`` and the reference's fire step (float32
  and float64 Sum and Avg, every window of 1 to 27 slices) — the bits the
  card's kernel and merge are held to;
- the plane-layout fold's plain version against the reference's
  per-shard ``a.at[0, recv_s]``, padding lanes included.

Inputs come from numpy seeds: standard normals scaled by exp(U(-8, 8)), so
the float sums depend on their order. Tolerance: none — results are
compared on their raw bits, NaN payloads included.
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
from flink_tpu_torch.ops.segment_ops import MERGE_FN
from flink_tpu_torch.parallel import shuffle as tshuffle
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_windower import (
    build_mesh_steps as tbuild_mesh_steps,
)
from flink_tpu_torch.stateplane.fold import (
    ordered_fold_planes,
    ordered_scatter_add_plain,
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


def _sum_specials(rng, vals):
    """Sprinkle NaN payloads (signalling, quiet, negative), +inf and -inf
    over float32 values (sum cases: some slots meet inf - inf)."""
    vals = vals.copy()
    bits = vals.view(np.int32)
    pick = rng.random(vals.shape)
    for j, b in enumerate((0x7FA00001, 0x7FC0000A, -0x003FFFFB)):
        sel = (pick >= 0.01 * j) & (pick < 0.01 * (j + 1))
        bits[sel] = b + rng.integers(0, 1 << 12, int(sel.sum()))
    vals[(pick >= 0.03) & (pick < 0.06)] = np.inf
    vals[(pick >= 0.06) & (pick < 0.09)] = -np.inf
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
    # the wrapper, as one plane, takes the plain version for a CPU tensor
    before = ordered_fold_planes.launches
    wrapped = ordered_fold_planes(torch.from_numpy(acc.copy())[None],
                                  torch.from_numpy(target.astype(np.int32))
                                  [None], torch.from_numpy(v)[None], reduce)
    assert torch.equal(wrapped[0].view(torch.int32), got.view(torch.int32))
    assert ordered_fold_planes.launches == before


def test_cpu_ordered_scatter_add_is_index_add():
    """On the CPU the plane fold of a sum is index_add_, plane by plane."""
    rng = np.random.default_rng(4)
    target = torch.from_numpy(rng.integers(0, 64, (3, 5000)).astype(np.int32))
    v = torch.from_numpy(_wide(rng, (3, 5000)))
    got = ordered_fold_planes(torch.zeros(3, 64), target, v, "sum")
    for p in range(3):
        want = ordered_scatter_add_plain(torch.zeros(64),
                                         target[p].to(torch.int64), v[p])
        assert torch.equal(got[p].view(torch.int32), want.view(torch.int32))


EXCHANGE_AGGS = {
    "sum_f32": (lambda: jagg.SumAggregate("v"),
                lambda: tagg.SumAggregate("v")),
    "sum_f32_nan": (lambda: jagg.SumAggregate("v"),
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
        if kind == "sum_f32_nan":
            vals = _sum_specials(rng, vals)
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


# --------------------------------------------------- NaN bits of float sums

_PATTERNS = {
    np.float32: dict(
        zero=0, one=0x3F800000, two=0x40000000, inf=0x7F800000,
        ninf=0xFF800000, snan=0x7FA00001, snan_q=0x7FE00001,
        qa=0x7FC0000A, qb=0x7FC0000B, q3=0x7FC00003, nneg=0xFFC00005,
        default=0xFFC00000),
    np.float64: dict(
        zero=0, one=0x3FF0000000000000, two=0x4000000000000000,
        inf=0x7FF0000000000000, ninf=0xFFF0000000000000,
        snan=0x7FF4000000000001, snan_q=0x7FFC000000000001,
        qa=0x7FF800000000000A, qb=0x7FF800000000000B,
        q3=0x7FF8000000000003, nneg=0xFFF8000000000005,
        default=0xFFF8000000000000),
}
_UINT = {np.float32: np.uint32, np.float64: np.uint64}

#: (starting value, values in order, scatter result, merge result). The
#: scatter (lane order) takes the LAST NaN lane quieted, else the start's
#: NaN quieted, else the default NaN of an inf - inf; the merge (XLA's
#: reduce of the slice axis) keeps the NaN that came first.
NAN_CASES = {
    "inf_minus_inf": ("zero", ["inf", "ninf"], "default", "default"),
    "signalling_nan_quieted": ("zero", ["snan"], "snan_q", "snan_q"),
    "later_nan_lane": ("zero", ["qa", "qb"], "qb", "qa"),
    "nan_lane_after_nan_start": ("qa", ["qb"], "qb", "qa"),
    "nan_start_survives": ("snan", ["one", "two"], "snan_q", "snan_q"),
    "negative_nan_kept": ("zero", ["nneg"], "nneg", "nneg"),
    "nan_lane_after_inf_minus_inf": ("zero", ["inf", "ninf", "q3"], "q3",
                                     "default"),
    "inf_minus_inf_after_nan": ("zero", ["q3", "inf", "ninf"], "q3", "q3"),
}


def _pattern(dtype, names):
    return np.array([_PATTERNS[dtype][n] for n in names],
                    dtype=_UINT[dtype]).view(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_sum_nan_bits_match_scatter(case, dtype):
    """The ingest fold of a float sum gives .at[].add's NaN bits: plane 1's
    slot 3 takes the case's values, interleaved with lanes bound for
    other slots and a padding lane at slot 0."""
    import jax
    import jax.numpy as jnp

    start, lanes, want, _ = NAN_CASES[case]
    P, cap, L = 2, 8, 3 * len(lanes) + 2
    acc = np.zeros((P, cap), dtype)
    acc[1, 3] = _pattern(dtype, [start])[0]
    slots = np.full((P, L), 5, np.int32)
    vals = np.ones((P, L), dtype)
    slots[1, 1::3][:len(lanes)] = 3
    vals[1, 1::3][:len(lanes)] = _pattern(dtype, lanes)
    slots[0, -1], vals[0, -1] = 0, 0
    with jax.enable_x64(dtype == np.float64):
        ref = np.stack([np.asarray(jnp.asarray(acc[p:p + 1])
                                   .at[0, slots[p]].add(vals[p]))[0]
                        for p in range(P)])
    got = ordered_fold_planes(torch.from_numpy(acc.copy()),
                              torch.from_numpy(slots), torch.from_numpy(vals),
                              "sum").numpy()
    u = _UINT[dtype]
    assert ref.view(u)[1, 3] == _pattern(dtype, [want]).view(u)[0]
    np.testing.assert_array_equal(got.view(u), ref.view(u))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_sum_nan_bits_match_jnp_sum(case, dtype):
    """The slice merge of a float sum gives jnp.sum's NaN bits over the
    slice axis: the case's values are one row of k slices."""
    import jax
    import jax.numpy as jnp

    start, lanes, _, want = NAN_CASES[case]
    row = np.repeat(_pattern(dtype, [start] + lanes)[None], 3, axis=0)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jnp.sum(jnp.asarray(row), axis=-1))
    got = MERGE_FN["sum"](torch.from_numpy(row)).numpy()
    u = _UINT[dtype]
    assert ref.view(u)[0] == _pattern(dtype, [want]).view(u)[0]
    np.testing.assert_array_equal(got.view(u), ref.view(u))


FIRE_SUMS = {
    "sum_f32": (lambda: jagg.SumAggregate("v"),
                lambda: tagg.SumAggregate("v"), np.float32),
    "sum_f64": (lambda: jagg.SumAggregate("v", dtype=np.float64),
                lambda: tagg.SumAggregate("v", dtype=np.float64), np.float64),
    "avg_f32": (lambda: jagg.AvgAggregate("v"),
                lambda: tagg.AvgAggregate("v"), np.float32),
}


def _nan_specials(rng, shape, dtype):
    """Wide values of ``dtype`` with NaN payloads (signalling, quiet,
    negative), +-inf and -0.0 sprinkled in."""
    vals = _wide(rng, shape).astype(dtype)
    bits = vals.view(_UINT[dtype])
    pick = rng.random(shape)
    for j, name in enumerate(("snan", "qa", "nneg")):
        sel = (pick >= 0.01 * j) & (pick < 0.01 * (j + 1))
        bits[sel] = _pattern(dtype, [name]).view(_UINT[dtype])[0] \
            + rng.integers(0, 1 << 12, int(sel.sum())).astype(_UINT[dtype])
    vals[(pick >= 0.03) & (pick < 0.06)] = np.inf
    vals[(pick >= 0.06) & (pick < 0.09)] = -np.inf
    vals[(pick >= 0.09) & (pick < 0.14)] = -0.0
    return vals


#: (kind, k) whose reference fire keeps the earliest NaN in every row, as
#: the port does (measured): there rows with two or more NaN slices are
#: compared too
_FIRST_NAN_EVERYWHERE = {("sum_f32", 1), ("sum_f32", 2), ("sum_f32", 4),
                         ("sum_f32", 16)}


def _fire_nan_case(mesh, kind, k):
    """A fire of ``kind`` over k slices of planes full of NaN payloads,
    +-inf and -0.0, the reference's against the port's, bit for bit in
    every row whose result its data determine — a row where no add of the
    left fold meets two NaNs — and in every row where the reference keeps
    the earliest NaN throughout (:data:`_FIRST_NAN_EVERYWHERE`). Any other
    row is NaN in both: which of two NaNs an add keeps depends on the
    row's place in the reference's compiled loops (ROADMAP Queue C item
    6)."""
    import jax

    jmake, tmake, dtype = FIRE_SUMS[kind]
    rng = np.random.default_rng(300 + k)
    cap, W = 512, 512
    plane = _nan_specials(rng, (P, cap), dtype)
    plane[:, 0] = 0.0
    sm = rng.integers(0, cap, (P, W, k)).astype(np.int32)
    planes = [plane]
    if kind == "avg_f32":
        planes.append(rng.integers(0, 9, (P, cap)).astype(np.float32))
    with jax.enable_x64(dtype == np.float64):
        jfire = jbuild_mesh_steps(mesh, jmake())[1]
        jout = jfire(tuple(_sharded(mesh, planes)), _sharded(mesh, sm))
        jout = {n: np.asarray(a) for n, a in jout.items()}
    tfire = tbuild_mesh_steps(make_mesh(P, "cpu"), tmake())[1]
    tout = tfire(from_jax_planes(planes, "cpu"), torch.from_numpy(sm))
    assert sorted(jout) == sorted(tout)
    x = plane[np.arange(P)[:, None, None], sm]
    acc, two = np.zeros((P, W), dtype), np.zeros((P, W), bool)
    with np.errstate(invalid="ignore"):
        for j in range(k):
            two |= np.isnan(acc) & np.isnan(x[..., j])
            acc = acc + x[..., j]
    rows = ~two | ((kind, k) in _FIRST_NAN_EVERYWHERE)
    assert (rows & np.isnan(acc)).any()
    u = _UINT[dtype]
    for name in jout:
        got, want = tout[name].numpy(), jout[name]
        np.testing.assert_array_equal(got.view(u)[rows], want.view(u)[rows],
                                      err_msg=name)
        assert np.isnan(got[two]).all() and np.isnan(want[two]).all()


@pytest.mark.parametrize("k", range(1, 28))
def test_fire_merge_nan_bits_match_reference(eight_device_mesh, k):
    """The fire step's float32 Sum merge against the reference's: one slice
    is passed through as it is (a signalling NaN stays signalling, -0.0
    stays -0.0); more slices give the earliest NaN slice quieted, or the
    default NaN of an inf - inf met first (k = 5 is Q5-revenue's HOP
    10 s / 2 s)."""
    _fire_nan_case(eight_device_mesh, "sum_f32", k)


@pytest.mark.parametrize("k", range(1, 28))
@pytest.mark.parametrize("kind", ["sum_f64", "avg_f32"])
def test_fire_merge_nan_bits_match_reference_by_aggregate(
        eight_device_mesh, kind, k):
    """As above for float64 Sum and for Avg (a NaN sum divided by the
    count keeps its payload)."""
    _fire_nan_case(eight_device_mesh, kind, k)


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_fold_planes_plain_matches_reference_per_plane(reduce):
    """ordered_fold_planes (its plain version, on the CPU) against the
    reference's per-shard fold a.at[0, recv_s] on an exchange's received
    lanes: each plane's padding lanes at slot 0 with the identity, hot
    slots, and NaN payloads and +-inf for the sum."""
    import jax.numpy as jnp

    rng = np.random.default_rng({"sum": 31, "max": 32, "min": 33}[reduce])
    cap, L = 1024, 4096
    ident = np.float32({"sum": 0.0, "max": -np.inf, "min": np.inf}[reduce])
    slots = np.where(rng.random((P, L)) < 0.3, rng.integers(1, 6, (P, L)),
                     rng.integers(1, cap, (P, L))).astype(np.int32)
    slots[:, L // 2:][rng.random((P, L - L // 2)) < 0.5] = 0   # padding
    vals = _wide(rng, (P, L))
    vals = _sum_specials(rng, vals) if reduce == "sum" \
        else _with_specials(rng, vals)
    vals[slots == 0] = ident
    acc = _wide(rng, (P, cap))
    acc[:, 0] = ident
    op = {"sum": "add"}.get(reduce, reduce)
    ref = np.stack([np.asarray(getattr(jnp.asarray(acc[p:p + 1])
                                       .at[0, slots[p]], op)(vals[p]))[0]
                    for p in range(P)])
    got = ordered_fold_planes(torch.from_numpy(acc.copy()),
                              torch.from_numpy(slots), torch.from_numpy(vals),
                              reduce)
    _bits_equal(got.numpy(), ref)
