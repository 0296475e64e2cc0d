"""The fire's float sum over windows of 28 or more slices against the
reference's, in both of its fire programs: the single-device
``flat_segment_fire`` (``flink_tpu/stateplane/families.py``) and the mesh
fire step of ``build_mesh_steps`` (8 virtual CPU devices). Past 27 slices
XLA's CPU reduce adds the slice axis in vector lanes and chunks, not left
to right; ``_merge_sum`` emulates the order ``tests/reference_fire_order.py``
measured (ROADMAP Queue C item 7), also past 300 slices (item 4).

The pane layout's two merges of a window's ring rows — a reduce over the
LEADING axis of ``[k, C]`` — against the reference's ``pane_programs``:
``fire_rows`` (vector lanes from 25 rows for sums, and for max/min a NaN
kept in another order at 23 to 32 rows) and ``fold_rows`` (a left fold to
32 rows, chunks past it), at every k ``--program pane`` measured (ROADMAP
Queue C item 9).

Inputs: finite float values of wide dynamic range from numpy seeds, so
that any other order of the adds shows in the last bits; for max/min NaN
payloads, signed zeros and infinities. Tolerance: none — results are
compared on their raw bits.
"""

import numpy as np
import pytest
import torch

from flink_tpu.parallel.sharded_windower import (
    build_mesh_steps as jbuild_mesh_steps,
)
from flink_tpu.stateplane.families import flat_segment_fire as jfire_flat
from flink_tpu.stateplane.pane import pane_programs as jpane_programs
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.convert import from_jax_planes
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_windower import (
    build_mesh_steps as tbuild_mesh_steps,
)
from flink_tpu_torch.stateplane.families import flat_segment_fire
from flink_tpu_torch.stateplane.pane import pane_programs
from flink_tpu_torch.windowing import aggregates as tagg

P, CAP, ROWS = 8, 256, 64

#: every k from 28 (vector lanes) to 64, then the chunk layouts past it:
#: three chunks (65-96), four (97-128), five and more; past 300 slices
#: (ROADMAP Queue C item 4, measured with ``--ks 301,320,512`` for both
#: programs and all three kinds: 0 rows differing from the port)
KS = list(range(28, 65)) + [65, 80, 94, 95, 96, 97, 113, 126, 127, 128,
                            129, 160, 200, 301, 320, 512]

KINDS = {
    "sum_f32": (lambda: jagg.SumAggregate("v"),
                lambda: tagg.SumAggregate("v"), np.float32),
    "sum_f64": (lambda: jagg.SumAggregate("v", dtype=np.float64),
                lambda: tagg.SumAggregate("v", dtype=np.float64),
                np.float64),
    "avg_f32": (lambda: jagg.AvgAggregate("v"),
                lambda: tagg.AvgAggregate("v"), np.float32),
}


def _inputs(kind, k):
    """Planes ``[P, CAP]`` (Avg: with its count plane) and a slot matrix
    ``[P, ROWS, k]``."""
    dtype = KINDS[kind][2]
    rng = np.random.default_rng(1000 * len(kind) + k)
    plane = (rng.standard_normal((P, CAP))
             * np.exp(rng.uniform(-8, 8, (P, CAP)))).astype(dtype)
    planes = [plane]
    if kind == "avg_f32":
        planes.append(rng.integers(0, 9, (P, CAP)).astype(np.float32))
    for p in planes:
        p[:, 0] = 0
    sm = rng.integers(0, CAP, (P, ROWS, k)).astype(np.int32)
    return planes, sm


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    u = {4: np.uint32, 8: np.uint64}[got.dtype.itemsize]
    differ = int((got.view(u) != want.view(u)).sum())
    assert differ == 0, f"{differ} of {got.size} rows differ"


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_single_device_fire_sum_order_matches_reference(kind, k):
    """The P = 1 fire: every shard's planes and rows laid end to end in
    one flat table, as the single-device engine holds them."""
    import jax

    jmake, tmake, dtype = KINDS[kind]
    planes, sm = _inputs(kind, k)
    flat = (sm + (np.arange(P, dtype=np.int32) * CAP)[:, None, None]
            ).reshape(-1, k)
    with jax.enable_x64(dtype == np.float64):
        want = jfire_flat(jmake())(
            tuple(jax.numpy.asarray(p.reshape(-1)) for p in planes),
            jax.numpy.asarray(flat))
        want = {n: np.asarray(a) for n, a in want.items()}
    got = flat_segment_fire(tmake())(
        tuple(torch.from_numpy(p.reshape(-1)) for p in planes),
        torch.from_numpy(flat))
    assert sorted(got) == sorted(want)
    for name in want:
        _bits_equal(got[name].numpy(), want[name])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_mesh_fire_sum_order_matches_reference(eight_device_mesh, kind, k):
    """The P = 8 fire step, one plane and ROWS rows a shard."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from flink_tpu.parallel.mesh import KEY_AXIS

    jmake, tmake, dtype = KINDS[kind]
    planes, sm = _inputs(kind, k)
    put = NamedSharding(eight_device_mesh, PartitionSpec(KEY_AXIS))
    with jax.enable_x64(dtype == np.float64):
        want = jbuild_mesh_steps(eight_device_mesh, jmake())[1](
            tuple(jax.device_put(p, put) for p in planes),
            jax.device_put(sm, put))
        want = {n: np.asarray(a) for n, a in want.items()}
    got = tbuild_mesh_steps(make_mesh(P, "cpu"), tmake())[1](
        from_jax_planes(planes, "cpu"), torch.from_numpy(sm))
    assert sorted(got) == sorted(want)
    for name in want:
        _bits_equal(got[name].numpy(), want[name])


# ----------------------------------------------- slot fires' max / min

EXTREME_KINDS = {
    f"{r}_{d}": (lambda r=r, dt=dt: getattr(jagg, f"{r.title()}Aggregate")(
        "v", dtype=dt),
        lambda r=r, dt=dt: getattr(tagg, f"{r.title()}Aggregate")(
            "v", dtype=dt), dt)
    for r in ("max", "min")
    for d, dt in (("f32", np.float32), ("f64", np.float64))
}
_SPECIAL = {
    np.float32: np.array([0x7FA00001, 0x7FC00002, 0xFFC00003, 0xFFA00004,
                          0x3F800000, 0xBF800000, 0, 0x80000000,
                          0x7F800000, 0xFF800000], np.uint32),
    np.float64: np.array([0x7FF4000000000001, 0x7FF8000000000002,
                          0xFFF8000000000003, 0xFFF4000000000004,
                          0x3FF0000000000000, 0xBFF0000000000000, 0,
                          0x8000000000000000, 0x7FF0000000000000,
                          0xFFF0000000000000], np.uint64),
}



#: around the slices met in vector lanes (25-32), then past them
EXTREME_KS = list(range(16, 41)) + [64, 65, 100]


def _extreme_inputs(kind, k):
    dtype = EXTREME_KINDS[kind][2]
    rng = np.random.default_rng(3000 * len(kind) + k)
    plane = rng.choice(_SPECIAL[dtype], (P, CAP)).view(dtype)
    ident = EXTREME_KINDS[kind][0]().leaves[0].identity
    plane[:, 0] = ident
    return [plane], rng.integers(0, CAP, (P, ROWS, k)).astype(np.int32)


@pytest.mark.parametrize("k", EXTREME_KS)
@pytest.mark.parametrize("kind", sorted(EXTREME_KINDS))
def test_slot_fires_max_min_nan_order_matches_reference(
        eight_device_mesh, kind, k):
    """Max/min of the slot layout's two fires — single-device and mesh —
    over slices of NaN payloads, signed zeros and infinities: the NaN the
    reference keeps, the slices met in vector lanes from 25 to 32."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from flink_tpu.parallel.mesh import KEY_AXIS

    jmake, tmake, dtype = EXTREME_KINDS[kind]
    planes, sm = _extreme_inputs(kind, k)
    flat = (sm + (np.arange(P, dtype=np.int32) * CAP)[:, None, None]
            ).reshape(-1, k)
    put = NamedSharding(eight_device_mesh, PartitionSpec(KEY_AXIS))
    with jax.enable_x64(dtype == np.float64):
        single = jfire_flat(jmake())(
            tuple(jax.numpy.asarray(p.reshape(-1)) for p in planes),
            jax.numpy.asarray(flat))
        single = {n: np.asarray(a) for n, a in single.items()}
        mesh = jbuild_mesh_steps(eight_device_mesh, jmake())[1](
            tuple(jax.device_put(p, put) for p in planes),
            jax.device_put(sm, put))
        mesh = {n: np.asarray(a) for n, a in mesh.items()}
    got = flat_segment_fire(tmake())(
        tuple(torch.from_numpy(p.reshape(-1)) for p in planes),
        torch.from_numpy(flat))
    for name in single:
        _bits_equal(got[name].numpy(), single[name])
    got = tbuild_mesh_steps(make_mesh(P, "cpu"), tmake())[1](
        from_jax_planes(planes, "cpu"), torch.from_numpy(sm))
    for name in mesh:
        _bits_equal(got[name].numpy(), mesh[name])


# ------------------------------------------------------------ pane merges

#: every k to 64, then a sample to 300
PANE_KS = list(range(1, 65)) + [65, 80, 96, 97, 100, 128, 129, 160, 200,
                                255, 256, 257, 300]
#: max/min: around the rows met out of order (23-32; 23 in a tree of its
#: own, ``segment_ops._merge_pane_extreme_23``)
PANE_EXTREME_KS = list(range(16, 41)) + [64, 65, 100]
PANE_COLS = 64

def _pane_case(kinds, kind, k):
    """Leaf planes ``[k + 1, PANE_COLS]`` (row 0 the identity row) and the
    window's k rows in a seeded order."""
    dtype = kinds[kind][2]
    rng = np.random.default_rng(7000 * len(kind) + k)
    if kind in EXTREME_KINDS:
        planes = [rng.choice(_SPECIAL[dtype], (k + 1, PANE_COLS))
                  .view(dtype)]
    else:
        planes = [(rng.standard_normal((k + 1, PANE_COLS))
                   * np.exp(rng.uniform(-8, 8, (k + 1, PANE_COLS))))
                  .astype(dtype)]
        if kind == "avg_f32":
            planes.append(rng.integers(0, 9, (k + 1, PANE_COLS))
                          .astype(np.float32))
    rows = rng.permutation(np.arange(1, k + 1)).astype(np.int32)
    return planes, rows


def _pane_both(kinds, kind, k, program):
    """The reference's and the port's result of one pane program: the
    fire's finished columns, or the fold's partial row of every leaf."""
    import jax

    jmake, tmake, dtype = kinds[kind]
    planes, rows = _pane_case(kinds, kind, k)
    present = np.ones((k + 1, PANE_COLS), np.int8)
    with jax.enable_x64(dtype == np.float64):
        jprog = jpane_programs(jmake())
        accs = tuple(jax.numpy.asarray(p) for p in planes) + (
            jax.numpy.asarray(present),)
        if program == "fire_rows":
            want = jprog[2](accs, jax.numpy.asarray(rows), PANE_COLS)[0]
            want = {n: np.asarray(a) for n, a in want.items()}
        else:
            out = jprog[5](accs, 0, jax.numpy.asarray(rows))
            want = {f"leaf_{i}": np.asarray(a[0])
                    for i, a in enumerate(out[:len(planes)])}
    tprog = pane_programs(tmake())
    accs = tuple(torch.from_numpy(p.copy()) for p in planes) + (
        torch.from_numpy(present),)
    if program == "fire_rows":
        got = tprog[2](accs, torch.from_numpy(rows), PANE_COLS)[0]
        got = {n: a.numpy() for n, a in got.items()}
    else:
        out = tprog[5](accs, 0, torch.from_numpy(rows), PANE_COLS)
        got = {f"leaf_{i}": a[0].numpy()
               for i, a in enumerate(out[:len(planes)])}
    return got, want


@pytest.mark.parametrize("k", PANE_KS)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("program", ["fire_rows", "fold_rows"])
def test_pane_sum_order_matches_reference(program, kind, k):
    """The pane fire's and the window-partial fold's float sums of k ring
    rows: MERGE_ROWS_FN / FOLD_ROWS_FN against pane_programs."""
    got, want = _pane_both(KINDS, kind, k, program)
    assert sorted(got) == sorted(want)
    for name in want:
        _bits_equal(got[name], want[name])


@pytest.mark.parametrize("k", PANE_EXTREME_KS)
@pytest.mark.parametrize("kind", sorted(EXTREME_KINDS))
@pytest.mark.parametrize("program", ["fire_rows", "fold_rows"])
def test_pane_max_min_nan_order_matches_reference(program, kind, k):
    """Max/min over k ring rows of NaN payloads, signed zeros and
    infinities: which NaN survives, by the x86 rule over the rows in the
    order the reference's reduce meets them."""
    got, want = _pane_both(EXTREME_KINDS, kind, k, program)
    for name in want:
        _bits_equal(got[name], want[name])


# ------------------------------------------- which NaN a pane fire keeps

def _pane_nan_pairs(kind, k, cols=None):
    """Leaf planes ``[k + 1, n]`` holding in column c the c-th pair i < j
    of the window's k rows: quiet NaNs with payloads i + 1 and j + 1 in
    rows i + 1 and j + 1, ones elsewhere (Avg: counts of one); ``cols``
    repeats ONE pair (i, j) = cols[1:] over ``cols[0]`` columns."""
    dtype = KINDS[kind][2]
    u = {4: np.uint32, 8: np.uint64}[np.dtype(dtype).itemsize]
    quiet = np.array([np.nan], dtype).view(u)[0]
    pairs = ([cols[1:]] * cols[0] if cols is not None else
             [(i, j) for j in range(1, k) for i in range(j)])
    plane = np.ones((k + 1, len(pairs)), dtype)
    for c, (i, j) in enumerate(pairs):
        plane[i + 1, c] = np.asarray(quiet + u(i + 1)).view(dtype)
        plane[j + 1, c] = np.asarray(quiet + u(j + 1)).view(dtype)
    planes = [plane] + ([np.ones(plane.shape, np.float32)]
                        if kind == "avg_f32" else [])
    return planes, np.arange(1, k + 1, dtype=np.int32)


def _pane_fire_both(kind, planes, rows):
    """The reference's and the port's fire_rows of ``planes`` over
    ``rows``: one finished column each."""
    import jax

    jmake, tmake, dtype = KINDS[kind]
    R, C = planes[0].shape
    present = np.ones((R, C), np.int8)
    with jax.enable_x64(dtype == np.float64):
        accs = tuple(jax.numpy.asarray(p) for p in planes) + (
            jax.numpy.asarray(present),)
        want = jpane_programs(jmake())[2](accs, jax.numpy.asarray(rows), C)[0]
        want = np.asarray(next(iter(want.values())))
    accs = tuple(torch.from_numpy(p.copy()) for p in planes) + (
        torch.from_numpy(present),)
    got = pane_programs(tmake())[2](accs, torch.from_numpy(rows), C)[0]
    return next(iter(got.values())).numpy(), want


@pytest.mark.parametrize("k", list(range(22, 35)))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pane_sum_nan_pair_choice_matches_reference(kind, k):
    """Which of two NaN rows the pane fire's sum keeps, every pair of the
    window's rows at once (one pair a column): in the lanes form the
    reference keeps the LATER one where float64 joins two vectors and
    where float32 adds a lane's rows at 32 rows (``_lanes``'s ``pane``;
    ROADMAP Queue C item 2)."""
    got, want = _pane_fire_both(kind, *_pane_nan_pairs(kind, k))
    _bits_equal(got, want)


def test_pane_sum_f32_nan_choice_at_24_rows_follows_column_count():
    """Not a function of the data: over 24 rows of float32 Sum the
    reference's fire keeps the later of two NaNs in rows 8-15 when the
    ring has 7 columns, and the earlier with 64 or more — the same pair,
    the same values. The port keeps the earlier (the left fold) at every
    width, so it matches the reference from 64 columns (recorded in
    ROADMAP Queue C item 2 as item 3 is)."""
    got7, want7 = _pane_fire_both("sum_f32",
                                  *_pane_nan_pairs("sum_f32", 24, (7, 0, 8)))
    got64, want64 = _pane_fire_both(
        "sum_f32", *_pane_nan_pairs("sum_f32", 24, (64, 0, 8)))
    payload = {int(v) & 0xFF for v in want7.view(np.uint32)}
    assert payload == {9}, "7 columns: the reference keeps row 8's NaN"
    assert {int(v) & 0xFF for v in want64.view(np.uint32)} == {1}
    assert {int(v) & 0xFF for v in got7.view(np.uint32)} == {1}
    _bits_equal(got64, want64)
