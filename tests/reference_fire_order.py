"""Measure the order in which the reference's fire step adds a window's
slices (``flink_tpu.parallel.sharded_windower.build_mesh_steps``, on the
CPU with 8 virtual devices) — what ``_merge_sum`` of the port must give:

- per window size k: for each pair of slice positions i < j of a row,
  which of two NaN slices the sum keeps (``a``: the earlier, ``l``: the
  later), and whether that depends on the row's place in the shard;
- whether the sum of finite wide-range values is the left fold
  ``((0 + x0) + x1) + ...``, counted in rows that differ from it.

    python tests/reference_fire_order.py [--kmax 32] [--rows 512] [--cap 1024]

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

from flink_tpu.parallel.mesh import KEY_AXIS, make_mesh  # noqa: E402
from flink_tpu.parallel.sharded_windower import build_mesh_steps  # noqa: E402
from flink_tpu.windowing import aggregates as jagg  # noqa: E402

P = 8
AGGS = {
    "sum_f32": (lambda: jagg.SumAggregate("v"), np.float32, np.uint32),
    "sum_f64": (lambda: jagg.SumAggregate("v", dtype=np.float64),
                np.float64, np.uint64),
    "avg_f32": (lambda: jagg.AvgAggregate("v"), np.float32, np.uint32),
}


def fire(mesh, kind, plane, sm):
    make, dtype, _ = AGGS[kind]
    planes = [plane] + ([np.ones(plane.shape, np.float32)]
                        if kind == "avg_f32" else [])
    put = NamedSharding(mesh, PartitionSpec(KEY_AXIS))
    with jax.enable_x64(dtype == np.float64):
        out = build_mesh_steps(mesh, make())[1](
            tuple(jax.device_put(p, put) for p in planes),
            jax.device_put(sm, put))
        return np.asarray(next(iter(out.values())))


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


def left_fold_misses(mesh, kind, k, rows, cap, seed=0):
    _, dtype, u = AGGS[kind]
    rng = np.random.default_rng(seed)
    plane = (rng.standard_normal((P, cap))
             * np.exp(rng.uniform(-8, 8, (P, cap)))).astype(dtype)
    sm = rng.integers(0, cap, (P, rows, k)).astype(np.int32)
    got = fire(mesh, kind, plane, sm)
    x = plane[np.arange(P)[:, None, None], sm]
    acc = np.zeros((P, rows), dtype)
    for j in range(k):
        acc = acc + x[..., j]
    if kind == "avg_f32":
        acc = acc / np.float32(k)
    return int((acc.view(u) != got.astype(dtype).view(u)).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kmax", type=int, default=32)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--kinds", default=",".join(AGGS))
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    mesh = make_mesh(P)
    for kind in args.kinds.split(","):
        for k in range(1, args.kmax + 1):
            order = nan_order(mesh, kind, k, args.rows, args.cap)
            later = {j: sorted(v["l"]) for j, v in order.items() if "l" in v}
            misses = left_fold_misses(mesh, kind, k, args.rows, args.cap)
            print(f"{kind} k={k}: left-fold misses {misses} of "
                  f"{P * args.rows} rows; later NaN kept at {later or '-'}",
                  flush=True)


if __name__ == "__main__":
    main()
