"""Measure the order in which the reference's fire adds a window's slices
on the CPU — what ``_merge_sum`` of the port must give. Two programs:
``mesh`` is the fire step of ``flink_tpu.parallel.sharded_windower.
build_mesh_steps`` (8 virtual devices, W rows a shard), ``single`` the
single-device fire ``flink_tpu.stateplane.families.flat_segment_fire``
(8 * W rows). For each:

- per window size k: for each pair of slice positions i < j of a row,
  which of two NaN slices the sum keeps (``a``: the earlier, ``l``: the
  later), and whether that depends on the row's place in the shard;
- whether the sum of finite wide-range values is the left fold
  ``((0 + x0) + x1) + ...``, counted in rows that differ from it, and
  whether it is the port's sum (``flink_tpu_torch.ops.segment_ops.
  MERGE_FN["sum"]``, finished by the port's aggregate), likewise;
  ``--seeds`` draws that many planes per k.

    python tests/reference_fire_order.py [--program mesh|single]
        [--kmin 1] [--kmax 32] [--rows 512] [--cap 1024] [--seeds 1]
        [--kinds sum_f32,sum_f64,avg_f32] [--no-nan]

Not a test (pytest does not collect it); ROADMAP Queue C items 6 and 7
cite its output.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

import torch  # noqa: E402

from flink_tpu.parallel.mesh import KEY_AXIS, make_mesh  # noqa: E402
from flink_tpu.parallel.sharded_windower import build_mesh_steps  # noqa: E402
from flink_tpu.stateplane.families import flat_segment_fire  # noqa: E402
from flink_tpu.windowing import aggregates as jagg  # noqa: E402
from flink_tpu_torch.ops.segment_ops import MERGE_FN  # noqa: E402
from flink_tpu_torch.windowing import aggregates as tagg  # noqa: E402

P = 8
AGGS = {
    "sum_f32": (lambda: jagg.SumAggregate("v"), np.float32, np.uint32),
    "sum_f64": (lambda: jagg.SumAggregate("v", dtype=np.float64),
                np.float64, np.uint64),
    "avg_f32": (lambda: jagg.AvgAggregate("v"), np.float32, np.uint32),
}
PORT_AGGS = {
    "sum_f32": lambda: tagg.SumAggregate("v"),
    "sum_f64": lambda: tagg.SumAggregate("v", dtype=np.float64),
    "avg_f32": lambda: tagg.AvgAggregate("v"),
}
PROGRAM = "mesh"


def _planes(kind, plane):
    return [plane] + ([np.ones(plane.shape, np.float32)]
                      if kind == "avg_f32" else [])


def fire(mesh, kind, plane, sm):
    """The reference's fire of ``plane [P, cap]`` (Avg: counts of 1) over
    ``sm [P, rows, k]``: the mesh step, or the single-device program
    over the planes and rows laid end to end."""
    make, dtype, _ = AGGS[kind]
    planes = _planes(kind, plane)
    with jax.enable_x64(dtype == np.float64):
        if PROGRAM == "single":
            cap = plane.shape[1]
            flat = sm + (np.arange(P, dtype=np.int32) * cap)[:, None, None]
            out = flat_segment_fire(make())(
                tuple(jax.numpy.asarray(p.reshape(-1)) for p in planes),
                jax.numpy.asarray(flat.reshape(-1, sm.shape[-1])))
            return np.asarray(next(iter(out.values()))).reshape(sm.shape[:2])
        put = NamedSharding(mesh, PartitionSpec(KEY_AXIS))
        out = build_mesh_steps(mesh, make())[1](
            tuple(jax.device_put(p, put) for p in planes),
            jax.device_put(sm, put))
        return np.asarray(next(iter(out.values())))


def port_fire(kind, plane, sm):
    """The port's merge and finish of the same rows, on the CPU."""
    agg = PORT_AGGS[kind]()
    planes = [torch.from_numpy(p) for p in _planes(kind, plane)]
    idx = torch.from_numpy(sm).to(torch.int64)
    merged = tuple(
        MERGE_FN[leaf.reduce](torch.stack([a[p][idx[p]] for p in range(P)]))
        for a, leaf in zip(planes, agg.leaves))
    return next(iter(agg.finish(merged).values())).numpy()


def nan_order(mesh, kind, k, rows, cap):
    """{j: {winner letter: [row ranges]}} for every slice position j > 0,
    over rows holding NaN payloads i + 1 and j + 1 at positions i < j."""
    _, dtype, u = AGGS[kind]
    plane = np.ones((P, cap), dtype)
    quiet = np.array([np.nan], dtype).view(u)[0]
    plane[:, 1:k + 1] = (quiet + np.arange(1, k + 1, dtype=u)).view(dtype)
    out = {}
    for j in range(1, k):
        for i in range(j):
            sm = np.full((P, rows, k), k + 1, np.int32)
            sm[:, :, i], sm[:, :, j] = i + 1, j + 1
            won = fire(mesh, kind, plane, sm)[0].astype(dtype).view(u) & 0xFF
            letters = np.where(won == i + 1, "a",
                               np.where(won == j + 1, "l", "?"))
            for letter in np.unique(letters):
                r = np.nonzero(letters == letter)[0]
                cuts = np.nonzero(np.diff(r) > 1)[0]
                spans = [f"{r[a]}-{r[b]}" for a, b in zip(
                    np.r_[0, cuts + 1], np.r_[cuts, len(r) - 1])]
                out.setdefault(j, {}).setdefault(letter, set()).update(spans)
    return out


def sum_misses(mesh, kind, k, rows, cap, seed=0):
    """(rows differing from the left fold, rows differing from the
    port) of one fire of finite wide-range values."""
    _, dtype, u = AGGS[kind]
    rng = np.random.default_rng(seed)
    plane = (rng.standard_normal((P, cap))
             * np.exp(rng.uniform(-8, 8, (P, cap)))).astype(dtype)
    sm = rng.integers(0, cap, (P, rows, k)).astype(np.int32)
    got = fire(mesh, kind, plane, sm).astype(dtype).view(u)
    x = plane[np.arange(P)[:, None, None], sm]
    acc = np.zeros((P, rows), dtype)
    for j in range(k):
        acc = acc + x[..., j]
    if kind == "avg_f32":
        acc = acc / np.float32(k)
    port = port_fire(kind, plane, sm).astype(dtype).view(u)
    return int((acc.view(u) != got).sum()), int((port != got).sum())


def main():
    global PROGRAM
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program", choices=("mesh", "single"), default="mesh")
    ap.add_argument("--kmin", type=int, default=1)
    ap.add_argument("--kmax", type=int, default=32)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--kinds", default=",".join(AGGS))
    ap.add_argument("--no-nan", action="store_true",
                    help="skip the NaN-order measurement")
    args = ap.parse_args()
    PROGRAM = args.program
    jax.config.update("jax_platforms", "cpu")
    mesh = make_mesh(P)
    for kind in args.kinds.split(","):
        for k in range(args.kmin, args.kmax + 1):
            later = "not measured"
            if not args.no_nan:
                order = nan_order(mesh, kind, k, args.rows, args.cap)
                later = {j: sorted(v["l"]) for j, v in order.items()
                         if "l" in v} or "-"
            misses = [sum_misses(mesh, kind, k, args.rows, args.cap, seed)
                      for seed in range(args.seeds)]
            print(f"{PROGRAM} {kind} k={k}: rows differing from the left "
                  f"fold {[m[0] for m in misses]}, from the port "
                  f"{[m[1] for m in misses]}, of {P * args.rows}; later NaN "
                  f"kept at {later}", flush=True)


if __name__ == "__main__":
    main()
