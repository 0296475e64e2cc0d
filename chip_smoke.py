#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flink_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--records N] [--revenue-records N]

Phases, each fatal on failure (no result line is printed then):

1. build both kernels from the checkout with nvcc, one process each, in
   parallel: the exchange rank (flink_tpu_torch/csrc/rank.cu) and the
   ordered fold (flink_tpu_torch/csrc/ordered_fold.cu);
2. hold the rank kernel bit-identical to its plain PyTorch versions on the
   card (rank_plain, exchange_rank_flat_plain) over 20 random shapes (D
   1..64, R 1..8, C up to 1<<20, with negative and out-of-range lanes and
   ranks past the bucket width), one launch per call;
3. time the flat rank at the shapes Nexmark Q5 gives it (R=8 shards,
   C=131072 lanes, D=8): per wrapper call by CUDA events, per launch by
   torch.profiler, beside its plain version and its memory bound (12 B per
   lane at 3.35 TB/s);
4. run the exchange+scatter step on the card and on the CPU over Q5's
   first 1<<20 bids (P=8, cap=1<<16, one slot per (auction, slice) as the
   engine stages them) for Count, float32 Sum over values with NaN
   payloads and +inf/-inf lanes (so that the CPU's NaN bits are checked),
   and float32 Max/Min with NaN, +0.0 and -0.0 in shared slots: every
   plane equal bit for bit; then fire the Sum plane (its NaN payloads
   and infinities included) over windows of 5 slices, Q5-revenue's, on the
   card and on the CPU: every merged sum equal bit for bit. Then (4b)
   hold the ordered fold's grouping
   (group_planes) against a stable sort on the CPU and its fold against
   its plain version on the CPU, bit for bit, at four shapes: the fold's
   shapes in that step (Q5's keys), Zipf(1.1) over 100k keys in float32
   and in float64 (one plane of 100001 slots, three radix passes, long
   runs), and the step's shapes with planes of 1<<17 slots (three
   passes); time each (wrapper call, device us per stage, the plain
   version, torch.sort(stable=True) alone on the int64 flat targets, and
   index_add_), beside the bytes bound and the dependent-add chain bound
   at the card's top SM clock; and compare torch's own scatter_reduce_
   amax/amin on the card with the CPU (recorded, not gated);
5. run Nexmark Q5 through the public API at parallelism.default=8 (100k
   auctions, 100k events/s of event time, 10 s / 2 s HOP, top-k 16,
   micro-batches of 1<<20 records) and check every fired window's winners
   against a NumPy oracle computed here;
6. run "Q5-revenue" the same way — the same bids, keyed by auction, HOP
   10 s / 2 s, ``.sum("price")`` in float32, 10M bids — and check EVERY
   fired (window, auction) sum bit for bit against a NumPy oracle that
   sums each slice in stream order (np.add.at) and folds each window's
   five slices left to right, as the engine merges them.

The launch counts of both kernels are set to 0 just before each of phases
5 and 6 and read just after; each phase fails if a kernel of its path did
not launch (the rank in both; the ordered fold in phase 6, Count being an
integer fold).

Prints the card's name and power limit early, one JSON line describing
every kernel, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Exits non-zero without a CUDA card, and when run without the repository.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
Q5_SHAPE = (8, 131072, 8)   # (R shards, C lanes per shard, D dests)
Q5_WIDTH = 32768            # a bucket width Q5's batches stage at
# Nexmark Q5 as bench.py runs it: auctions, events/s of event time, HOP
# size and slide (ms), top-k
AUCTIONS, RATE, SIZE, SLIDE, TOP_K = 100_000, 100_000, 10_000, 2_000, 16


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events, after a
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us_per_call(fn, iters: int, names) -> dict:
    """Device time per call of ``fn`` spent in the kernels whose names
    contain each of ``names``, by torch.profiler over ``iters`` calls; a
    name the profiler did not see reads None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    tot = {n: None for n in names}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.name:
                tot[n] = (tot[n] or 0.0) + ev.time_range.elapsed_us() / iters
    return tot


def reset_counts():
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank

    rank.launches = 0
    ordered_fold_planes.launches = 0


def read_counts() -> dict:
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank

    return {"exchange_rank": rank.launches,
            "ordered_fold": ordered_fold_planes.launches}


def phase_rank_parity(torch):
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
        rank,
        rank_plain,
    )

    rng = np.random.default_rng(2024)
    cases = [(1, 1, 1), (1, 1024, 1), (2, 1025, 7), (8, 131072, 8),
             (8, 1 << 20, 64), (3, 4097, 33)]
    for _ in range(14):
        cases.append((int(rng.integers(1, 9)),
                      int(rng.integers(1, (1 << 20) + 1)),
                      int(rng.integers(1, 65))))
    for R, C, D in cases:
        d = torch.from_numpy(rng.integers(-3, D + 4, size=(R, C))
                             .astype(np.int32)).cuda()
        W = int(rng.integers(1, max(C // D, 1) + 2))
        before = rank.launches
        got = rank(d, D)
        got_flat = exchange_rank_flat(d, D, W)
        if rank.launches != before + 2:
            raise AssertionError(f"rank: {rank.launches - before} launches "
                                 "for two calls")
        want = rank_plain(d, D)
        want_flat = exchange_rank_flat_plain(d, D, W)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"rank kernel != rank_plain at R={R} C={C} D={D}: "
                f"{bad} lanes differ")
        if not torch.equal(got_flat, want_flat):
            bad = int((got_flat != want_flat).sum())
            raise AssertionError(
                f"flat rank != exchange_rank_flat_plain at R={R} C={C} "
                f"D={D} W={W}: {bad} lanes differ")
        if R == 1:  # the [C] form too
            if not torch.equal(rank(d[0], D), want[0]):
                raise AssertionError(f"1-D rank differs at C={C} D={D}")
        del want, want_flat
    print(f"phase 2: rank kernel (int32 and flat int64) bit-identical to "
          f"its plain versions on {len(cases)} shapes (D 1..64, R 1..8, C "
          f"up to {1 << 20}); one launch per call")


def phase_rank_timing(torch):
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
    )

    R, C, D = Q5_SHAPE
    W = Q5_WIDTH
    rng = np.random.default_rng(7)
    d = torch.from_numpy(rng.integers(0, D + 1, size=(R, C))
                         .astype(np.int32)).cuda()
    err = (exchange_rank_flat(d, D, W)
           - exchange_rank_flat_plain(d, D, W)).abs().max().item()
    ms = cuda_ms(lambda: exchange_rank_flat(d, D, W), 200)
    plain_ms = cuda_ms(lambda: exchange_rank_flat_plain(d, D, W), 50)
    dev = device_us_per_call(lambda: exchange_rank_flat(d, D, W), 50,
                             ["rank_onepass"])["rank_onepass"]
    # the same bytes moved by torch's own elementwise cast (read int32,
    # write int64): what a memory-bound pass of this size takes here
    cast = device_us_per_call(lambda: d.to(torch.int64), 50,
                              ["elementwise"])["elementwise"]
    nbytes = (4 + 8) * R * C      # each lane read once, its int64 written
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    def ms_or_none(us):
        return "not measured" if us is None else f"{us / 1e3:.4f} ms"

    print(f"phase 3: flat rank at R={R} C={C} D={D} W={W}: wrapper call "
          f"{ms:.4f} ms, kernel device time {ms_or_none(dev)}, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); torch's int32->int64 cast of "
          f"the same lanes (same bytes) {ms_or_none(cast)} of device time")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "device_ms": None if dev is None else dev / 1e3,
            "cast_device_ms": None if cast is None else cast / 1e3,
            "max_abs_err": float(err)}


def _with_specials(rng, vals):
    vals = vals.copy()
    pick = rng.random(vals.shape)
    vals[pick < 0.02] = np.nan
    vals[(pick >= 0.02) & (pick < 0.2)] = 0.0
    vals[(pick >= 0.2) & (pick < 0.4)] = -0.0
    return vals


def _sum_specials(rng, vals):
    """float32 values with NaN payloads (signalling, quiet, negative) and
    +inf / -inf lanes, so that some slots meet inf - inf: the cases where
    the CPU's NaN bits differ from a plain card add."""
    vals = vals.copy()
    bits = vals.view(np.int32)
    pick = rng.random(vals.shape)
    for j, b in enumerate((0x7FA00001, 0x7FC0000A, -0x003FFFFB)):
        sel = (pick >= 0.001 * j) & (pick < 0.001 * (j + 1))
        bits[sel] = b + rng.integers(0, 1 << 12, int(sel.sum()))
    vals[(pick >= 0.003) & (pick < 0.013)] = np.inf
    vals[(pick >= 0.013) & (pick < 0.023)] = -np.inf
    return vals


def _bits(t):
    import torch

    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _q5_lanes(n: int, P: int):
    """(shard, slot) of each of Q5's first n bids, as the engine stages
    them: shards by key group, and per shard one slot (from 1; slot 0 is
    the identity) for each (auction, slice) pair, in first-seen order."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.parallel.shuffle import shard_records

    src = BidSource(total_records=n, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    b = src.poll_batch(n)
    keys = np.asarray(b["auction"], dtype=np.int64)
    pair = keys * (int(b.timestamps.max()) // SLIDE + 1) \
        + b.timestamps // SLIDE
    shards = shard_records(keys, P, 128)
    span = int(pair.max()) + 1
    u, first, inv = np.unique(shards * span + pair, return_index=True,
                              return_inverse=True)
    # number each shard's pairs 1, 2, ... in the order they first appear
    rank_in_shard = np.empty(len(u), dtype=np.int64)
    for p in range(P):
        mine = np.nonzero(u // span == p)[0]
        rank_in_shard[mine[np.argsort(first[mine], kind="stable")]] = \
            np.arange(1, len(mine) + 1)
    return shards, rank_in_shard[inv].astype(np.int32)


def phase_exchange_scatter(torch):
    from flink_tpu_torch.ops.segment_ops import torch_dtype
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import build_mesh_steps
    from flink_tpu_torch.parallel.shuffle import (
        build_exchange_scatter,
        stage_device_exchange,
    )
    from flink_tpu_torch.windowing.aggregates import (
        CountAggregate,
        MaxAggregate,
        MinAggregate,
        SumAggregate,
    )

    P, cap, n = 8, 1 << 16, 1 << 20
    shards, slots = _q5_lanes(n, P)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(n).astype(np.float32)
    special = _with_specials(rng, vals)
    sum_special = _sum_specials(rng, vals)
    report = {}
    for name, agg, v in (("count", CountAggregate(), None),
                         ("sum_f32", SumAggregate("v"), sum_special),
                         ("max_f32", MaxAggregate("v"), special),
                         ("min_f32", MinAggregate("v"), special)):
        leaf = agg.leaves[0]
        cols = [slots] + ([v] if agg.input_leaves else [])
        dst, staged, width = stage_device_exchange(
            shards, P, cols, fills=[0] + [leaf.identity] * len(
                agg.input_leaves))
        outs = {}
        for dev in ("cpu", "cuda"):
            step = build_exchange_scatter(make_mesh(P, dev), agg)
            accs = (torch.full((P, cap), np.asarray(leaf.identity).item(),
                               dtype=torch_dtype(leaf.dtype), device=dev),)
            t = [torch.from_numpy(c).to(dev) for c in (dst, *staged)]
            accs = step(accs, t[0], t[1], tuple(t[2:]), width)
            outs[dev] = accs[0].cpu()
        differ = int((_bits(outs["cpu"]) != _bits(outs["cuda"])).sum())
        report[name] = {"slots_differing": differ}
        if name == "sum_f32":
            report[name]["nan_slots"] = int(torch.isnan(outs["cpu"]).sum())
            sum_plane = outs["cpu"]
        if differ:
            raise AssertionError(f"exchange+scatter {name}: card != CPU in "
                                 f"{differ} of {P * cap} slots")
    # the fire's slice merge of those sums, windows of 5 slices
    sm = torch.from_numpy(rng.integers(0, cap, (P, 4096, SIZE // SLIDE))
                          .astype(np.int32))
    fired = {}
    for dev in ("cpu", "cuda"):
        fire = build_mesh_steps(make_mesh(P, dev), SumAggregate("v"))[1]
        fired[dev] = fire((sum_plane.to(dev),), sm.to(dev))["sum_v"].cpu()
    differ = int((_bits(fired["cpu"]) != _bits(fired["cuda"])).sum())
    report["fire_sum_k5"] = {"rows_differing": differ,
                             "nan_rows": int(torch.isnan(fired["cpu"]).sum())}
    if differ:
        raise AssertionError(f"fire merge of float32 sums: card != CPU in "
                             f"{differ} of {fired['cpu'].numel()} rows")
    print("phase 4: exchange+scatter card == CPU bit for bit over Q5's first"
          f" 1<<20 bids (P=8, cap=1<<16; Sum with NaN payloads and +-inf), "
          f"and its fire over windows of 5 slices: {json.dumps(report)}")
    fold = phase_fold(torch, P, cap, shards, slots, vals, special)
    return report, fold


def _received(torch, P, dst, slots, vals, width):
    """The (slots [P, L] int32, values [P, L]) the exchange step hands its
    fold: the step's own rank, bucket scatter and transpose, on the
    card."""
    from flink_tpu_torch.stateplane.rank import exchange_rank_flat

    d = torch.from_numpy(dst).cuda()
    C = d.numel() // P
    W = int(width)
    flat = exchange_rank_flat(d.view(P, C), P, W)

    def exchange(col, fill):
        buf = torch.full((P, P * W + 1), fill, dtype=col.dtype,
                         device="cuda")
        buf.scatter_(1, flat, col.view(P, C))
        return (buf[:, :P * W].reshape(P, P, W).transpose(0, 1)
                .reshape(P, P * W))

    return (exchange(torch.from_numpy(slots).cuda(), 0),
            exchange(torch.from_numpy(vals).cuda(), 0.0))


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


FADD_CYCLES = 4   # dependent FP32/FP64 add latency assumed for the chain


def fold_case(torch, name, acc, slots, v, clock_hz, stages=True):
    """Hold the fold's grouping and its fold on the card against their
    plain versions on the CPU (bit for bit), and time them: the wrapper
    call, device µs per stage, torch.sort(stable=True) alone on the
    int64 flat targets p * cap + slot (the stage a sort-based grouping runs),
    the plain version and index_add_ on the card, and both bounds."""
    from flink_tpu_torch.stateplane.fold import (
        group_planes,
        group_planes_plain,
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    P, cap = acc.shape
    got_g = group_planes(slots, v, cap)
    want_g = group_planes_plain(slots.cpu(), v.cpu(), cap)
    for p, ((gk, gv), (wk, wv)) in enumerate(zip(got_g, want_g)):
        if not (torch.equal(gk.cpu(), wk)
                and torch.equal(_bits(gv.cpu()), _bits(wv))):
            raise AssertionError(f"{name}: grouping != stable sort, plane "
                                 f"{p}")
    del got_g
    got = ordered_fold_planes(acc.clone(), slots, v, "sum")
    want = ordered_fold_planes_plain(acc.cpu(), slots.cpu(), v.cpu(), "sum")
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        bad = int((_bits(got.cpu()) != _bits(want)).sum())
        raise AssertionError(f"{name}: ordered fold != its plain version "
                             f"in {bad} slots")
    err = float((got.cpu() - want).abs().nan_to_num().max())
    kept = [wk for wk, _ in want_g]
    real = sum(int(k.numel()) for k in kept)
    touched = sum(int(torch.unique(k).numel()) for k in kept)
    longest = max(int(torch.bincount(k.to(torch.int64)).max())
                  if k.numel() else 0
                  for k in kept)
    eb = v.element_size()
    nbytes = 4 * slots.numel() + eb * real + 2 * eb * touched
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = longest * FADD_CYCLES / clock_hz * 1e3
    target = (slots.to(torch.int64) + torch.arange(
        P, device="cuda", dtype=torch.int64)[:, None] * cap).reshape(-1)
    flat_v = v.reshape(-1)
    work = acc.clone()
    ms = cuda_ms(lambda: ordered_fold_planes(work, slots, v, "sum"), 20)
    sort_ms = cuda_ms(lambda: torch.sort(target, stable=True), 20)
    plain_ms = cuda_ms(lambda: ordered_fold_planes_plain(work, slots, v,
                                                         "sum"), 20)
    flat_acc = work.view(-1)
    index_add_ms = cuda_ms(lambda: flat_acc.index_add_(0, target, flat_v),
                           20)
    dev = device_us_per_call(
        lambda: ordered_fold_planes(work, slots, v, "sum"), 10,
        ["Memset", "histogram", "sort_pass", "fold_runs", "fold_long"]) \
        if stages else None
    # the hot run's measured pace, when the long-run stage was timed
    cycles_per_add = (dev["fold_long"] * 1e-6 * clock_hz / longest
                      if dev and dev.get("fold_long") and longest >= 1024
                      else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        ordered_fold_planes(work, slots, v, "sum")
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    out = {"planes": P, "cap": cap, "lanes": slots.numel(),
           "real_lanes": real, "targets": touched, "longest_run": longest,
           "dtype": str(v.dtype).replace("torch.", ""),
           "ms": ms, "torch_sort_stable_ms": sort_ms, "plain_ms": plain_ms,
           "index_add_ms": index_add_ms, "device_us": dev,
           "host_enqueue_ms": host_ms, "long_run_cycles_per_add":
               cycles_per_add,
           "bytes_bound_ms": bytes_ms, "chain_bound_ms": chain_ms,
           "bound_ms": max(bytes_ms, chain_ms),
           "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
           "max_abs_err": err}
    print(f"phase 4b {name}: P={P} cap={cap} {slots.numel()} lanes ({real} "
          f"kept, {touched} targets, longest run {longest}, "
          f"{out['dtype']}): grouping and fold bit-identical to their "
          f"plain versions; wrapper {ms:.4f} ms, torch.sort(stable) of the "
          f"flat targets alone {sort_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ (not order-preserving) {index_add_ms:.4f} ms; "
          f"bound {out['bound_ms']:.5f} ms (bytes {bytes_ms:.5f}, chain "
          f"{chain_ms:.5f} at {clock_hz / 1e6:.0f} MHz, {FADD_CYCLES} "
          f"cycles an add); device us per stage {dev}; host enqueue "
          f"{host_ms:.4f} ms per call; long run at {cycles_per_add} "
          "cycles per add")
    return out


def phase_fold(torch, P, cap, shards, slots, vals, special):
    from flink_tpu_torch.parallel.shuffle import stage_device_exchange
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    clock = sm_clock_hz()
    dst, (s_slots, s_vals), width = stage_device_exchange(
        shards, P, [slots, vals], fills=[0, 0.0])
    recv_s, v = _received(torch, P, dst, s_slots, s_vals, width)
    cases = {"q5": fold_case(torch, "q5", torch.zeros(P, cap,
                                                       device="cuda"),
                             recv_s, v, clock)}

    # Zipf(1.1) over 100k keys, one plane of cap 100001 (3 radix passes):
    # the hot key makes one long run
    n = recv_s.numel()
    rng = np.random.default_rng(11)
    p = np.arange(1, 100_001, dtype=np.float64) ** -1.1
    zkeys = rng.choice(100_000, size=n, p=p / p.sum())
    z_slots = torch.from_numpy((zkeys + 1).astype(np.int32)).cuda()[None]
    for dt, name in ((np.float32, "zipf_f32"), (np.float64, "zipf_f64")):
        z_v = torch.from_numpy(rng.standard_normal(n).astype(dt)).cuda()
        cases[name] = fold_case(
            torch, name, torch.zeros(1, 100_001, dtype=z_v.dtype,
                                     device="cuda"), z_slots, z_v[None],
            clock)

    # the exchange's shapes with planes of 1<<17 slots (3 passes)
    w_slots = torch.from_numpy(np.where(
        rng.random(recv_s.shape) < 0.5, 0,
        rng.integers(1, 1 << 17, recv_s.shape)).astype(np.int32)).cuda()
    w_v = torch.from_numpy(rng.standard_normal(recv_s.shape)
                           .astype(np.float32)).cuda()
    w_v[w_slots == 0] = 0.0
    cases["cap_1<<17"] = fold_case(
        torch, "cap_1<<17", torch.zeros(P, 1 << 17, device="cuda"),
        w_slots, w_v, clock, stages=False)

    # float max/min: torch's scatter_reduce_ on the card vs the CPU, and
    # the port's fold (the kernel's max/min modes) vs its plain one
    sp_dst, (sp_slots, sp_vals), sp_w = stage_device_exchange(
        shards, P, [slots, special], fills=[0, 0.0])
    sp_s, sp_v = _received(torch, P, sp_dst, sp_slots, sp_vals, sp_w)
    sp_t = (sp_s.to(torch.int64) + torch.arange(
        P, device="cuda", dtype=torch.int64)[:, None] * cap).reshape(-1)
    torch_diff, port_diff = {}, {}
    for reduce, ident in (("amax", -np.inf), ("amin", np.inf)):
        acc = torch.full((P, cap), float(ident))
        on_card = acc.cuda().view(-1).scatter_reduce_(
            0, sp_t, sp_v.reshape(-1), reduce=reduce)
        on_cpu = acc.clone().view(-1).scatter_reduce_(
            0, sp_t.cpu(), sp_v.reshape(-1).cpu(), reduce=reduce)
        torch_diff[reduce] = int((_bits(on_card.cpu()) != _bits(on_cpu))
                                 .sum())
        r = reduce[1:]
        # the exchange's padding lanes carry the identity (slot 0)
        v_r = sp_v.masked_fill(sp_s == 0, float(ident))
        card = ordered_fold_planes(acc.cuda(), sp_s, v_r, r)
        plain = ordered_fold_planes_plain(acc.clone(), sp_s.cpu(),
                                          v_r.cpu(), r)
        port_diff[r] = int((_bits(card.cpu()) != _bits(plain)).sum())
    if any(port_diff.values()):
        raise AssertionError(f"ordered fold max/min card != plain: "
                             f"{port_diff}")
    q5 = cases["q5"]
    out = {"cases": cases, "sm_clock_max_hz": clock,
           "fadd_cycles_assumed": FADD_CYCLES,
           "ms": q5["ms"], "plain_ms": q5["plain_ms"],
           "bound_ms": q5["bound_ms"], "bound_by": q5["bound_by"],
           "max_abs_err": q5["max_abs_err"],
           "torch_scatter_reduce_card_vs_cpu_slots_differing": torch_diff,
           "port_max_min_card_vs_plain_slots_differing": port_diff}
    print(f"phase 4b: max/min card == plain ({port_diff}); torch's own "
          f"scatter_reduce_ card vs CPU differs in {torch_diff} slots "
          "(recorded, not gated)")
    print("fold " + json.dumps(out))
    return out


def _run_job(torch, build, device):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8,
        "execution.micro-batch.size": 1 << 20,
        "execution.device": device,
    }))
    sink = CollectSink()
    build(env).sink_to(sink)
    reset_counts()
    t0 = time.perf_counter()
    result = env.execute()
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    lat = result.metrics.get("window_fire_latency_ms", {})
    return sink, elapsed, counts, lat


def q5_oracle(source_cls, total, num_auctions, rate, size_ms, slide_ms):
    """{window_end: (max count, set of auctions with it)} by NumPy:
    per-slice bid counts, then each window sums its size/slide slices."""
    src = source_cls(total_records=total, num_auctions=num_auctions,
                     events_per_second_of_eventtime=rate)
    src.open()
    n_slices = ((total - 1) * 1000 // rate) // slide_ms + 1
    counts = np.zeros((n_slices, num_auctions), dtype=np.int64)
    while (b := src.poll_batch(1 << 22)) is not None:
        j = b.timestamps // slide_ms
        lo, hi = int(j.min()), int(j.max()) + 1
        counts[lo:hi] += np.bincount(
            (j - lo) * num_auctions + b["auction"],
            minlength=(hi - lo) * num_auctions).reshape(hi - lo, -1)
    k = size_ms // slide_ms
    csum = np.cumsum(np.concatenate(
        [counts, np.zeros((k - 1, num_auctions), np.int64)]), axis=0)
    out = {}
    for e in range(n_slices + k - 1):   # the window ending with slice e
        win = csum[e] - (csum[e - k] if e >= k else 0)
        best = int(win.max())
        if best:
            out[(e + 1) * slide_ms] = (
                best, set(np.nonzero(win == best)[0].tolist()))
    return out


def phase_q5(torch, records: int):
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5

    sink, elapsed, counts, lat = _run_job(torch, lambda env: build_q5(
        env, BidSource(total_records=records, num_auctions=AUCTIONS,
                       events_per_second_of_eventtime=RATE),
        size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K), "cuda")
    batches = -(-records // (1 << 20))
    if counts["exchange_rank"] <= 0:
        raise AssertionError("Q5 ran without launching the rank kernel")
    got = {}
    for r in sink.rows():
        got.setdefault(r["window_end"], (r["count"], set()))[1].add(
            int(r["auction"]))
    t1 = time.perf_counter()
    want = q5_oracle(BidSource, records, AUCTIONS, RATE, SIZE, SLIDE)
    oracle_s = time.perf_counter() - t1
    if set(got) != set(want):
        raise AssertionError(f"Q5 fired {len(got)} windows, oracle "
                             f"{len(want)}")
    for w, (best, winners) in want.items():
        g_best, g_winners = got[w]
        if g_best != best or not g_winners <= winners or \
                len(g_winners) != min(len(winners), TOP_K):
            raise AssertionError(f"Q5 window {w}: got ({g_best}, "
                                 f"{sorted(g_winners)[:5]}...), oracle "
                                 f"({best}, {sorted(winners)[:5]}...)")
    q5 = {"records": records, "elapsed_s": elapsed,
          "events_per_s": records / elapsed, "windows": len(got),
          "batches": batches, "launches": counts,
          "fire_latency_ms": lat, "oracle_s": oracle_s}
    print(f"phase 5: Q5 P=8 {records} records in {elapsed:.3f} s = "
          f"{records / elapsed:.0f} events/s; {len(got)} windows match the "
          f"oracle; launches {counts} over {batches} batches; fire latency "
          f"p50 {lat.get('p50')} ms p99 {lat.get('p99')} ms")
    print("Q5 " + json.dumps(q5))
    return q5


def build_revenue(env, source):
    """Q5-revenue through the public API: float32 revenue per auction per
    sliding window."""
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    return (env.from_source(source,
                            WatermarkStrategy.for_bounded_out_of_orderness(0))
            .key_by("auction")
            .window(SlidingEventTimeWindows.of(SIZE, SLIDE))
            .sum("price"))


def revenue_oracle(source_cls, total, num_auctions, rate, size_ms,
                   slide_ms):
    """(sums [windows, auctions] float32, counts [windows, auctions]) by
    NumPy, window e ending with slice e: per-slice sums by np.add.at in
    stream order, then each window's slices folded left to right from 0."""
    src = source_cls(total_records=total, num_auctions=num_auctions,
                     events_per_second_of_eventtime=rate)
    src.open()
    k = size_ms // slide_ms
    n_slices = ((total - 1) * 1000 // rate) // slide_ms + 1
    sums = np.zeros((n_slices + 2 * (k - 1), num_auctions), np.float32)
    counts = np.zeros((n_slices + 2 * (k - 1), num_auctions), np.int64)
    flat_s, flat_c = sums.reshape(-1), counts.reshape(-1)
    while (b := src.poll_batch(1 << 22)) is not None:
        idx = ((b.timestamps // slide_ms) + (k - 1)) * num_auctions \
            + b["auction"]
        np.add.at(flat_s, idx, b["price"])
        flat_c += np.bincount(idx, minlength=flat_c.size)
    n_windows = n_slices + k - 1
    win = np.zeros((n_windows, num_auctions), np.float32)
    cnt = np.zeros((n_windows, num_auctions), np.int64)
    for j in range(k):                 # ((0 + s0) + s1) + ... + s(k-1)
        win = win + sums[j:j + n_windows]
        cnt += counts[j:j + n_windows]
    return win, cnt


def phase_revenue(torch, records: int):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    sink, elapsed, counts, lat = _run_job(torch, lambda env: build_revenue(
        env, BidSource(total_records=records, num_auctions=AUCTIONS,
                       events_per_second_of_eventtime=RATE)), "cuda")
    for name in ("exchange_rank", "ordered_fold"):
        if counts[name] <= 0:
            raise AssertionError(f"Q5-revenue ran without launching {name}")
    res = sink.result()
    t1 = time.perf_counter()
    want, cnt = revenue_oracle(BidSource, records, AUCTIONS, RATE, SIZE,
                               SLIDE)
    oracle_s = time.perf_counter() - t1
    e = np.asarray(res["window_end"]) // SLIDE - 1
    a = np.asarray(res["auction"]).astype(np.int64)
    s = np.asarray(res["sum_price"], dtype=np.float32)
    if e.min() < 0 or e.max() >= len(want):
        raise AssertionError("Q5-revenue fired a window the oracle lacks")
    pair = e * AUCTIONS + a
    if len(np.unique(pair)) != len(pair):
        raise AssertionError("Q5-revenue fired a (window, auction) twice")
    present = cnt > 0
    if len(pair) != int(present.sum()) or not present.reshape(-1)[pair].all():
        raise AssertionError(f"Q5-revenue fired {len(pair)} rows, oracle "
                             f"{int(present.sum())}")
    bad = int((want[e, a].view(np.int32) != s.view(np.int32)).sum())
    if bad:
        raise AssertionError(f"Q5-revenue: {bad} of {len(s)} fired sums "
                             "differ from the stream-order oracle")
    windows = int(present.any(axis=1).sum())
    rev = {"records": records, "elapsed_s": elapsed,
           "events_per_s": records / elapsed, "windows": windows,
           "rows": len(s), "rows_differing": bad, "launches": counts,
           "fire_latency_ms": lat, "oracle_s": oracle_s}
    print(f"phase 6: Q5-revenue P=8 {records} records in {elapsed:.3f} s = "
          f"{records / elapsed:.0f} events/s; all {len(s)} fired (window, "
          f"auction) sums over {windows} windows equal the stream-order "
          f"oracle bit for bit; launches {counts}; fire latency p50 "
          f"{lat.get('p50')} ms p99 {lat.get('p99')} ms")
    print("revenue " + json.dumps(rev))
    return rev


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=40_000_000,
                    help="Q5 records (40M: the size of bench.py's run)")
    ap.add_argument("--revenue-records", type=int, default=10_000_000,
                    help="Q5-revenue records")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from flink_tpu_torch.stateplane import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the flink_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "Compiling" in line:
                print(f"  ptxas {src}: {line.strip()}")

    phase_rank_parity(torch)
    timing = phase_rank_timing(torch)
    print("rank " + json.dumps(timing))
    _, fold = phase_exchange_scatter(torch)
    q5 = phase_q5(torch, args.records)
    rev = phase_revenue(torch, args.revenue_records)

    kernels = [{
        "name": "exchange_rank",
        "route": "cuda",
        "source": "flink_tpu_torch/csrc/rank.cu",
        "replaces": "flink_tpu/stateplane/rank.py:75",
        "launches": q5["launches"]["exchange_rank"]
        + rev["launches"]["exchange_rank"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "ordered_fold",
        "route": "cuda",
        "source": "flink_tpu_torch/csrc/ordered_fold.cu",
        "replaces": "flink_tpu/parallel/shuffle.py:396",
        "launches": q5["launches"]["ordered_fold"]
        + rev["launches"]["ordered_fold"],
        "max_abs_err": fold["max_abs_err"],
        "ms": fold["ms"],
        "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"],
        "bound_by": fold["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
