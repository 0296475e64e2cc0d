"""The fire's float sum over windows of 28 or more slices against the
reference's, in both of its fire programs: the single-device
``flat_segment_fire`` (``flink_tpu/stateplane/families.py``) and the mesh
fire step of ``build_mesh_steps`` (8 virtual CPU devices). Past 27 slices
XLA's CPU reduce adds the slice axis in vector lanes and chunks, not left
to right; ``_merge_sum`` emulates the order ``tests/reference_fire_order.py``
measured (ROADMAP Queue C item 7).

Inputs: finite float values of wide dynamic range from numpy seeds, so
that any other order of the adds shows in the last bits. Tolerance: none
— sums are compared on their raw bits.
"""

import numpy as np
import pytest
import torch

from flink_tpu.parallel.sharded_windower import (
    build_mesh_steps as jbuild_mesh_steps,
)
from flink_tpu.stateplane.families import flat_segment_fire as jfire_flat
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.convert import from_jax_planes
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_windower import (
    build_mesh_steps as tbuild_mesh_steps,
)
from flink_tpu_torch.stateplane.families import flat_segment_fire
from flink_tpu_torch.windowing import aggregates as tagg

P, CAP, ROWS = 8, 256, 64

#: every k from 28 (vector lanes) to 64, then the chunk layouts past it:
#: three chunks (65-96), four (97-128), five and more
KS = list(range(28, 65)) + [65, 80, 94, 95, 96, 97, 113, 126, 127, 128,
                            129, 160, 200]

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
