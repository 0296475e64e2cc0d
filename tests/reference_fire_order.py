"""Measure the order in which the reference's fire adds a window's slices
on the CPU — what ``_merge_sum`` of the port must give. Three programs:
``mesh`` is the fire step of ``flink_tpu.parallel.sharded_windower.
build_mesh_steps`` (8 virtual devices, W rows a shard), ``single`` the
single-device fire ``flink_tpu.stateplane.families.flat_segment_fire``
(8 * W rows), ``pane`` the pane layout's ``fire_rows`` and ``fold_rows``
of ``flink_tpu.stateplane.pane.pane_programs`` (a reduce over the LEADING
axis of ``[k, C]`` ring rows, see :func:`pane_main`). For the first two:

- per window size k: for each pair of slice positions i < j of a row,
  which of two NaN slices the sum keeps (``a``: the earlier, ``l``: the
  later), and whether that depends on the row's place in the shard;
- whether the sum of finite wide-range values is the left fold
  ``((0 + x0) + x1) + ...``, counted in rows that differ from it, and
  whether it is the port's sum (``flink_tpu_torch.ops.segment_ops.
  MERGE_FN["sum"]``, finished by the port's aggregate), likewise;
  ``--seeds`` draws that many planes per k.

    python tests/reference_fire_order.py [--program mesh|single|pane]
        [--kmin 1] [--kmax 32] [--ks 40,64,300] [--rows 512] [--cap 1024]
        [--cols 4096,7] [--seeds 1] [--kinds sum_f32,sum_f64,avg_f32]
        [--no-nan]

Not a test (pytest does not collect it); ROADMAP Queue C items 6, 7 and 9
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
from flink_tpu.stateplane.pane import pane_programs  # noqa: E402
from flink_tpu.windowing import aggregates as jagg  # noqa: E402
from flink_tpu_torch.ops.segment_ops import MERGE_FN  # noqa: E402
from flink_tpu_torch.stateplane.pane import (  # noqa: E402
    pane_programs as port_pane_programs,
)
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


# ------------------------------------------------------------ pane programs

PANE_KINDS = {
    **{kind: v[:2] for kind, v in AGGS.items()},
    "max_f32": (lambda: jagg.MaxAggregate("v"), np.float32),
    "min_f32": (lambda: jagg.MinAggregate("v"), np.float32),
    "max_f64": (lambda: jagg.MaxAggregate("v", dtype=np.float64),
                np.float64),
    "min_f64": (lambda: jagg.MinAggregate("v", dtype=np.float64),
                np.float64),
}
PORT_PANE_AGGS = {
    **PORT_AGGS,
    "max_f32": lambda: tagg.MaxAggregate("v"),
    "min_f32": lambda: tagg.MinAggregate("v"),
    "max_f64": lambda: tagg.MaxAggregate("v", dtype=np.float64),
    "min_f64": lambda: tagg.MinAggregate("v", dtype=np.float64),
}
#: max/min planes draw from signalling, quiet and negative NaN payloads,
#: +-1, +-0 and +-inf
_SPECIAL = {
    np.float32: np.array([0x7fa00001, 0x7fc00002, 0xffc00003, 0xffa00004,
                          0x3f800000, 0xbf800000, 0, 0x80000000,
                          0x7f800000, 0xff800000], np.uint32),
    np.float64: np.array([0x7ff4000000000001, 0x7ff8000000000002,
                          0xfff8000000000003, 0xfff4000000000004,
                          0x3ff0000000000000, 0xbff0000000000000, 0,
                          0x8000000000000000, 0x7ff0000000000000,
                          0xfff0000000000000], np.uint64),
}
_U = {4: np.uint32, 8: np.uint64}


def pane_planes(kind, k, cols, seed):
    """The leaf planes ``[k + 1, cols]`` (row 0 the identity row) of one
    measurement: wide-range finite values for sum and Avg (Avg: counts of
    1), special values for max/min."""
    _, dtype = PANE_KINDS[kind]
    rng = np.random.default_rng(1000 * seed + k)
    if kind.startswith(("max", "min")):
        return [rng.choice(_SPECIAL[dtype], (k + 1, cols)).view(dtype)]
    plane = (rng.standard_normal((k + 1, cols))
             * np.exp(rng.uniform(-8, 8, (k + 1, cols)))).astype(dtype)
    return _planes(kind, plane)


def pane_rows(k, seed):
    """The window's k ring rows, in a seeded order (not 1..k)."""
    return np.random.default_rng(seed).permutation(
        np.arange(1, k + 1)).astype(np.int32)


def pane_reference(kind, planes, rows):
    """(fire result column, fold_rows' first leaf) of the reference's
    pane programs over every column."""
    make, dtype = PANE_KINDS[kind]
    progs = pane_programs(make())
    R, C = planes[0].shape
    with jax.enable_x64(dtype == np.float64):
        accs = tuple(jax.numpy.asarray(p) for p in planes) + (
            jax.numpy.ones((R, C), jax.numpy.int8),)
        cols, _ = progs[2](accs, jax.numpy.asarray(rows), C)
        fire_col = np.asarray(next(iter(cols.values())))
        fold = np.asarray(progs[5](accs, 0, jax.numpy.asarray(rows))[0][0])
    return fire_col, fold


def pane_port(kind, planes, rows):
    """The same two results from the port's pane programs."""
    progs = port_pane_programs(PORT_PANE_AGGS[kind]())
    R, C = planes[0].shape
    accs = tuple(torch.from_numpy(p.copy()) for p in planes) + (
        torch.ones((R, C), dtype=torch.int8),)
    idx = torch.from_numpy(rows)
    cols, _ = progs[2](accs, idx, C)
    fire_col = next(iter(cols.values())).numpy()
    fold = progs[5](accs, 0, idx, C)[0][0].numpy()
    return fire_col, fold


def pane_misses(kind, k, cols, seed):
    """Columns of the fire and of the fold differing from the left fold
    (sum and Avg only) and from the port."""
    _, dtype = PANE_KINDS[kind]
    u = _U[np.dtype(dtype).itemsize]
    planes = pane_planes(kind, k, cols, seed)
    rows = pane_rows(k, seed)
    fire_col, fold = pane_reference(kind, planes, rows)
    pfire, pfold = pane_port(kind, planes, rows)
    out = {"fire/port": int((fire_col.view(u) != pfire.view(u)).sum()),
           "fold/port": int((fold.view(u) != pfold.view(u)).sum())}
    if not kind.startswith(("max", "min")):
        acc = np.zeros(cols, dtype)
        for r in rows:
            acc = acc + planes[0][r]
        out["fold/left"] = int((fold.view(u) != acc.view(u)).sum())
        if kind == "avg_f32":
            acc = acc / np.float32(k)
        out["fire/left"] = int(
            (fire_col.astype(dtype).view(u) != acc.view(u)).sum())
    return out


def pane_nan_order(kind, k, cols):
    """{program: {j: letter}}: which of two NaN rows at positions i < j
    of the window (payloads i + 1, j + 1 in every column, ones elsewhere)
    a sum keeps — ``a`` the earlier, ``l`` the later, ``?`` neither or a
    mix over the columns — and, under ``port:<program>``, the pairs where
    the port keeps another NaN than the reference."""
    _, dtype = PANE_KINDS[kind]
    u = _U[np.dtype(dtype).itemsize]
    quiet = np.array([np.nan], dtype).view(u)[0]
    out = {"fire": {}, "fold": {}, "port:fire": {}, "port:fold": {}}
    for j in range(1, k):
        for i in range(j):
            planes = [np.ones((k + 1, cols), dtype)]
            planes[0][i + 1] = np.asarray(quiet + u(i + 1)).view(dtype)
            planes[0][j + 1] = np.asarray(quiet + u(j + 1)).view(dtype)
            if kind == "avg_f32":
                planes.append(np.ones((k + 1, cols), np.float32))
            rows = np.arange(1, k + 1, dtype=np.int32)
            res = pane_reference(kind, planes, rows)
            port = pane_port(kind, planes, rows)
            for name, got, mine in zip(("fire", "fold"), res, port):
                if (got.astype(dtype).view(u) != mine.view(u)).any():
                    out["port:" + name].setdefault(j, set()).add(str(i))
                won = set(np.unique(got.astype(dtype).view(u) & 0xFF))
                letter = "a" if won == {i + 1} else \
                    "l" if won == {j + 1} else "?"
                if letter != "a":
                    out[name].setdefault(j, set()).add(f"{i}{letter}")
    return out


def extreme_order(kind, k, program, priority=True):
    """The order in which the reference's max/min fire meets k slices,
    read off pairs: two NaNs at positions i < j, ones elsewhere. Of the
    priority sign (negative for max, positive for min) the rule keeps
    the first NaN met, so ranking the positions by pairs won gives the
    order; of the other sign (``priority=False``) it keeps the last met,
    so the positions ranked by pairs LOST give it (``mixed``: pairs
    where neither or a mix won). The two orders differ where the reduce
    joins partials in a tree (the pane fire at 23 rows). ``program``:
    ``pane`` (``fire_rows`` over ``[k, 16]`` rows) or ``single``
    (``flat_segment_fire`` over a ``[64, k]`` slot matrix)."""
    make, dtype = PANE_KINDS[kind]
    u = _U[np.dtype(dtype).itemsize]
    base = np.array([np.nan], dtype).view(u)[0]
    if kind.startswith("max") == priority:
        base = base | (u(1) << u(8 * np.dtype(dtype).itemsize - 1))
    wins, mixed = [0] * k, 0
    fire_flat = flat_segment_fire(make())
    for i in range(k):
        for j in range(i + 1, k):
            plane = np.ones(k + 2, dtype)
            plane.view(u)[i + 1] = base + u(i + 1)
            plane.view(u)[j + 1] = base + u(j + 1)
            if program == "pane":
                got, _ = pane_reference(kind, [np.repeat(
                    plane[:k + 1, None], 16, axis=1)],
                    np.arange(1, k + 1, dtype=np.int32))
            else:
                sm = np.full((64, k), k + 1, np.int32)
                sm[:, i], sm[:, j] = i + 1, j + 1
                with jax.enable_x64(dtype == np.float64):
                    got = np.asarray(next(iter(fire_flat(
                        (jax.numpy.asarray(plane),),
                        jax.numpy.asarray(sm)).values())))
            won = set(np.unique(got.view(u) & u(0xFF)).tolist())
            if won == {i + 1}:
                wins[i] += 1
            elif won == {j + 1}:
                wins[j] += 1
            else:
                mixed += 1
    sign = -1 if priority else 1
    return sorted(range(k), key=lambda r: sign * wins[r]), mixed


def pane_main(args):
    """Per kind, k and column count: columns of the fire and of the
    window-partial fold that differ from the left fold and from the port
    (one count per seed); for sums the positions where a later NaN wins,
    for max/min the orders in which the pane fire and the single-device
    slot fire meet the slices — read off NaNs of the priority sign
    (``first``) and of the other sign (``last``) — with the pairs that
    fit no order (``--no-nan`` skips both)."""
    ks = list(range(args.kmin, args.kmax + 1)) + [
        int(k) for k in args.ks.split(",") if k]
    for kind in args.kinds.split(","):
        for cols in (int(c) for c in args.cols.split(",")):
            for k in ks:
                misses = [pane_misses(kind, k, cols, seed)
                          for seed in range(args.seeds)]
                summary = {name: [m[name] for m in misses]
                           for name in misses[0]}
                later = "not measured"
                if args.no_nan:
                    pass
                elif kind.startswith(("max", "min")):
                    later = {f"{prog} {which}": extreme_order(
                        kind, k, prog, priority=which == "first")
                        for prog in ("pane", "single")
                        for which in ("first", "last")}
                else:
                    later = {n: {j: sorted(v) for j, v in o.items()} or "-"
                             for n, o in pane_nan_order(kind, k,
                                                        cols).items()}
                print(f"pane {kind} C={cols} k={k}: columns differing "
                      f"{summary}; NaN order {later}", flush=True)


def main():
    global PROGRAM
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program", choices=("mesh", "single", "pane"),
                    default="mesh")
    ap.add_argument("--kmin", type=int, default=1)
    ap.add_argument("--kmax", type=int, default=32)
    ap.add_argument("--ks", default="",
                    help="further window sizes, comma-separated")
    ap.add_argument("--cols", default="4096,7",
                    help="pane: column counts, comma-separated")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--kinds", default=None,
                    help="default: sum_f32,sum_f64,avg_f32; with --program "
                    "pane also max_f32,min_f32,max_f64,min_f64")
    ap.add_argument("--no-nan", action="store_true",
                    help="skip the NaN-order measurement")
    args = ap.parse_args()
    PROGRAM = args.program
    jax.config.update("jax_platforms", "cpu")
    if PROGRAM == "pane":
        if args.kinds is None:
            args.kinds = ",".join(PANE_KINDS)
        return pane_main(args)
    args.kinds = args.kinds or ",".join(AGGS)
    mesh = make_mesh(P)
    for kind in args.kinds.split(","):
        for k in list(range(args.kmin, args.kmax + 1)) + [
                int(k) for k in args.ks.split(",") if k]:
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
