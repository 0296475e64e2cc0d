#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flink_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--records N] [--revenue-records N]
        [--session-records N]

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
   and float32 Max/Min with NaN payloads (signalling, quiet, negative),
   +0.0 and -0.0 in shared slots: every plane equal bit for bit; then fire the Sum plane (its NaN payloads
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
   at the card's top SM clock; hold the fold's max/min modes on the card
   against their plain version on the CPU over the NaN-payload lanes
   (0 slots differing) and time them; and compare torch's own
   scatter_reduce_ amax/amin on the card with the CPU (recorded, not
   gated);
5. run Nexmark Q5 through the public API at parallelism.default=8 (100k
   auctions, 100k events/s of event time, 10 s / 2 s HOP, top-k 16,
   micro-batches of 1<<20 records) and check every fired window's winners
   against a NumPy oracle computed here;
6. run "Q5-revenue" the same way — the same bids, keyed by auction, HOP
   10 s / 2 s, ``.sum("price")`` in float32, 10M bids — and check EVERY
   fired (window, auction) sum bit for bit against a NumPy oracle that
   sums each slice in stream order (np.add.at) and folds each window's
   five slices left to right, as the engine merges them;
7. run Q5 as phase 5 at parallelism.default=1 with bench.py's settings
   (the single-device slot table: capacity 1<<22, the slot layout,
   dispatch-ahead 8, micro-batches of 1<<20, 40M bids): every window's
   winners against the oracle, and the number of windows with more tied
   winners than k (the device top-k decides which of those survive);
8. run Q5-revenue as phase 6 at parallelism 1 (10M bids): every fired sum
   equal to the oracle; then time one call of the ordered fold at that
   engine's shape — one plane of 1<<22 slots, 1<<20 lanes of Q5's first
   bids — against its plain version and its bytes bound;
9. a forced-eviction run: a float32 Sum over Q5's first 3M bids with the
   values of phase 4 (NaN payloads, +inf and -inf), HOP 10 s / 2 s, on the
   single-device engine with a device budget of 1<<17 slots (far below
   its live rows, so slices spill to the host and reload), on the card
   and on the CPU: every fired batch equal bit for bit, and the spill
   counters equal;
10. run Q5 as phase 7 in the pane layout (state.window-layout=panes,
    latency.pane-preagg on: the delta fire), 40M bids: every window's
    winners against the oracle; print the ring's rows R and the pane
    state's bytes on the card;
11. run Q5-revenue in the pane layout: over the first 2M bids the card's
    sink rows equal, in order and bit for bit, the same job through the
    port on the CPU; over 10M bids every (window, auction) with bids fires
    once and no other, and every sum is within 2 (n - 1) 2^-24 of the
    stream-order oracle's relative to it (n: the row's bids; prices are
    positive, so that bounds any two orders of the adds: pre-aggregation
    folds a window's partial in record order, not slice by slice); then
    time one call of the ordered fold at the run's [1, R*C] shape with the
    lanes of its largest combined scatter, against its plain version;
12. run BASELINE row 5 through the public API at parallelism 1 (sessions
    with a 2 s gap over DataGenSource's 12M records and 10M keys, float32
    ``.sum("value")``, micro-batches of 1<<16, a 1<<19-row device budget:
    the paged spill tier evicts and reloads), not cut: (a) the sessions'
    (key, start, end) multiset equals a NumPy oracle's exactly and every
    sum is within 2 (n - 1) 2^-24 of its stream-order float32 sum; 0 late
    records; the native session plane ran; print events/s, fire latency,
    the spill counters and the state's bytes on the card; (b) the same job
    over the first 2M records on the card and on the CPU: rows equal in
    order, bit for bit, spill counters equal; (c) a float32 Max over phase
    4's NaN payloads and signed zeros, 1M records over 100k keys with
    timestamps moved back by up to 3 s so that sessions merge, under a
    1<<15-row budget, card == CPU likewise; (d) one flat_merge_pairs call
    at row 5's [1<<19] table with the lanes of (c)'s largest merge group
    (row 5's own stream, in order, merges nothing), and one ordered fold
    at row 5's ingest shape ([1, 1<<19], the lanes of the last full
    batch that (b)'s card run folded, equal bit for bit to its plain version on
    the CPU):
    for each, wrapper and device ms, its plain version, its bytes bound
    (real lanes only: padded lanes are the program's own).

13. run BASELINE row 5 on the mesh session engine at parallelism 8: (a)
    the reference's mesh-sessions shape (``tools/bench_mesh_sessions.py``
    as ``tools/bench_suite.py:247-265`` runs it: 4M records, keys uniform
    over 10M from ``default_rng(3)``, 400k events/s of event time, batches
    of 1<<16, float32 Sum of ones, gap 2,000 ms, 1<<16 rows a shard, a
    25 ms fire deadline) through ``flink_tpu_torch/benchmarks/
    mesh_sessions.py``: every fired (key, start, end, sum) equal to a
    NumPy oracle that places each ingest split's watermark; rows evicted
    and reloaded both > 0; events/s, fire p50/p99, the spill counters and
    the page-rewrite amplification printed; (b) row 5's job
    (``DataGenSource``) at ``parallelism.default: 8`` through
    ``env.execute()`` over its first 2M records under 1<<16 rows a shard,
    on the card and on the CPU: rows equal in order, bit for bit, spill
    counters equal; (c) phase 12(c)'s out-of-order float32 Max job at P=8
    under 1<<12 rows a shard, card == CPU likewise, with merge groups,
    evictions and ordered-fold launches inside the merges; (d) the mesh
    merge step alone at (c)'s largest group, float32 Sum and Max: card ==
    CPU, wrapper ms, device ms (torch.profiler), its plain version's ms and
    the bytes bound (16 B a real pair, 8 B a destination, 3.35 TB/s).

The launch counts of both kernels are set to 0 just before each of phases
5 to 8, 10, 11, 12(a), 13(a), 13(b) and 13(c) and read just after; each
phase fails if a kernel of its path did not launch (the rank at
parallelism 8; the ordered fold in phases 6, 8, 11, 12 and 13, Count
being an integer fold).

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
    """float32 values with NaN payloads (signalling, quiet, negative) and
    signed zeros: the max/min cases."""
    vals = vals.copy()
    pick = rng.random(vals.shape)
    vals[(pick >= 0.02) & (pick < 0.2)] = 0.0
    vals[(pick >= 0.2) & (pick < 0.4)] = -0.0
    bits = vals.view(np.int32)
    for j, b in enumerate((0x7FA00001, 0x7FC0000A, -0x003FFFFB,
                           -0x005FFFF0)):
        sel = (pick >= 0.005 * j) & (pick < 0.005 * (j + 1))
        bits[sel] = b + rng.integers(0, 1 << 12, int(sel.sum()))
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
    torch_diff, port_diff, minmax_ms = {}, {}, {}
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
        work = acc.cuda()
        minmax_ms[r] = cuda_ms(
            lambda: ordered_fold_planes(work, sp_s, v_r, r), 20)
    if any(port_diff.values()):
        raise AssertionError(f"ordered fold max/min card != plain: "
                             f"{port_diff}")
    nan_lanes = int(torch.isnan(sp_v).sum())
    q5 = cases["q5"]
    out = {"cases": cases, "sm_clock_max_hz": clock,
           "fadd_cycles_assumed": FADD_CYCLES,
           "ms": q5["ms"], "plain_ms": q5["plain_ms"],
           "bound_ms": q5["bound_ms"], "bound_by": q5["bound_by"],
           "max_abs_err": q5["max_abs_err"],
           "torch_scatter_reduce_card_vs_cpu_slots_differing": torch_diff,
           "port_max_min_card_vs_plain_slots_differing": port_diff,
           "max_min_ms": minmax_ms, "max_min_nan_lanes": nan_lanes}
    print(f"phase 4b: max/min over {sp_v.numel()} lanes ({nan_lanes} NaN "
          f"payloads) card == plain ({port_diff}); {minmax_ms} ms a call "
          f"(sum at the same shapes {q5['ms']:.4f} ms); torch's own "
          f"scatter_reduce_ card vs CPU differs in {torch_diff} slots "
          "(recorded, not gated)")
    print("fold " + json.dumps(out))
    return out


def _run_job(torch, build, device, parallelism=8, layout="slots"):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.q5_profile import P1_SETTINGS
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": parallelism,
        "execution.micro-batch.size": 1 << 20,
        "execution.device": device,
        **(P1_SETTINGS if parallelism == 1 else {}),
        **({"state.window-layout": layout} if parallelism == 1 else {}),
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


class PaneTables:
    """Records the pane tables a run opens, and the lanes of the largest
    scatter each folds (flat index and values, on the host)."""

    def __init__(self):
        from flink_tpu_torch.state.pane_table import PaneTable

        self.cls, self.tables, self.largest = PaneTable, [], None
        self._init, self._scatter = PaneTable.__init__, PaneTable.scatter_flat
        rec = self

        def init(table, *a, **k):
            rec._init(table, *a, **k)
            rec.tables.append(table)

        def scatter(table, flat, values, valued=False):
            if rec.largest is None or len(flat) > len(rec.largest[0]):
                rec.largest = (np.asarray(flat).copy(),
                               tuple(np.asarray(v).copy() for v in values))
            return rec._scatter(table, flat, values, valued)

        PaneTable.__init__, PaneTable.scatter_flat = init, scatter

    def close(self):
        self.cls.__init__, self.cls.scatter_flat = self._init, self._scatter

    def state(self) -> dict:
        t = self.tables[-1]
        return {"ring_rows": t.R, "capacity": t.capacity,
                "used_cols": t.used_cols, "state_bytes": t.device_bytes}


def phase_q5(torch, records: int, parallelism: int = 8, layout="slots"):
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5

    phase = 5 if parallelism == 8 else 7 if layout == "slots" else 10
    panes = PaneTables() if layout == "panes" else None
    try:
        sink, elapsed, counts, lat = _run_job(torch, lambda env: build_q5(
            env, BidSource(total_records=records, num_auctions=AUCTIONS,
                           events_per_second_of_eventtime=RATE),
            size_ms=SIZE, slide_ms=SLIDE, device_top_k=TOP_K), "cuda",
            parallelism, layout)
    finally:
        if panes is not None:
            panes.close()
    batches = -(-records // (1 << 20))
    if parallelism > 1 and counts["exchange_rank"] <= 0:
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
    # windows where the top-k chose among more tied winners than k
    over_k = sum(len(winners) > TOP_K for _, winners in want.values())
    q5 = {"parallelism": parallelism, "layout": layout, "records": records,
          "elapsed_s": elapsed, "events_per_s": records / elapsed,
          "windows": len(got), "windows_with_more_ties_than_k": over_k,
          "batches": batches, "launches": counts,
          "fire_latency_ms": lat, "oracle_s": oracle_s}
    if panes is not None:
        q5["pane_state"] = panes.state()
    print(f"phase {phase}: Q5 P={parallelism} ({layout}) {records} records "
          f"in {elapsed:.3f} s = {records / elapsed:.0f} events/s; "
          f"{len(got)} windows match the oracle ({over_k} with more tied "
          f"winners than k={TOP_K}); launches {counts} over {batches} "
          f"batches; fire latency p50 {lat.get('p50')} ms p99 "
          f"{lat.get('p99')} ms" + (f"; pane state {q5['pane_state']}"
                                    if panes is not None else ""))
    print(f"Q5 P={parallelism} {layout} " + json.dumps(q5))
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


def phase_revenue(torch, records: int, parallelism: int = 8):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    phase = 6 if parallelism == 8 else 8
    sink, elapsed, counts, lat = _run_job(torch, lambda env: build_revenue(
        env, BidSource(total_records=records, num_auctions=AUCTIONS,
                       events_per_second_of_eventtime=RATE)), "cuda",
        parallelism)
    path = ("exchange_rank", "ordered_fold") if parallelism > 1 \
        else ("ordered_fold",)
    for name in path:
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
    rev = {"parallelism": parallelism, "records": records,
           "elapsed_s": elapsed, "events_per_s": records / elapsed,
           "windows": windows, "rows": len(s), "rows_differing": bad,
           "launches": counts, "fire_latency_ms": lat, "oracle_s": oracle_s}
    print(f"phase {phase}: Q5-revenue P={parallelism} {records} records in "
          f"{elapsed:.3f} s = {records / elapsed:.0f} events/s; all {len(s)} "
          f"fired (window, auction) sums over {windows} windows equal the "
          f"stream-order oracle bit for bit; launches {counts}; fire "
          f"latency p50 {lat.get('p50')} ms p99 {lat.get('p99')} ms")
    print(f"revenue P={parallelism} " + json.dumps(rev))
    return rev


def phase_fold_p1(torch):
    """One timed call of the ordered fold at the single-device engine's
    shape: a [1, 1<<22] float32 plane, 1<<20 lanes of Q5's first bids
    (one slot per (auction, slice) in first-seen order, prices as values),
    against its plain version on the same inputs; bound by the bytes it
    must move (4 B a lane of slots, 4 B a lane of values, a read and a
    write of each touched slot)."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    n, cap = 1 << 20, 1 << 22
    _, slots = _q5_lanes(n, 1)
    src = BidSource(total_records=n, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    price = np.asarray(src.poll_batch(n)["price"], dtype=np.float32)
    s = torch.from_numpy(slots).cuda()[None]
    v = torch.from_numpy(price).cuda()[None]
    acc = torch.zeros(1, cap, device="cuda")
    got = ordered_fold_planes(acc.clone(), s, v, "sum")
    want = ordered_fold_planes_plain(acc.cpu(), s.cpu(), v.cpu(), "sum")
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError("ordered fold at [1, 1<<22] != its plain "
                             "version")
    touched = int(torch.unique(s).numel())
    nbytes = 8 * n + 8 * touched
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    work = acc.clone()
    ms = cuda_ms(lambda: ordered_fold_planes(work, s, v, "sum"), 20)
    plain_ms = cuda_ms(lambda: ordered_fold_planes_plain(work, s, v, "sum"),
                       20)
    out = {"planes": 1, "cap": cap, "lanes": n, "targets": touched,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "max_abs_err": 0.0}
    print(f"phase 8: ordered fold at [1, 1<<22] with {n} lanes ({touched} "
          f"targets): bit-identical to its plain version; {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bytes bound {bound_ms:.5f} ms")
    print("fold P=1 " + json.dumps(out))
    return out


def _revenue_rows(torch, records, device):
    """The sink rows of Q5-revenue in the pane layout on ``device``."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    sink, elapsed, counts, _ = _run_job(torch, lambda env: build_revenue(
        env, BidSource(total_records=records, num_auctions=AUCTIONS,
                       events_per_second_of_eventtime=RATE)), device, 1,
        "panes")
    return sink, elapsed, counts


def phase_revenue_panes(torch, records: int, equal_records: int = 2_000_000):
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    # (a) the card equals the CPU, rows in order, bit for bit
    card, _, _ = _revenue_rows(torch, equal_records, "cuda")
    cpu, cpu_s, _ = _revenue_rows(torch, equal_records, "cpu")
    card_rows, cpu_rows = card.result(), cpu.result()
    if sorted(card_rows.names()) != sorted(cpu_rows.names()):
        raise AssertionError("Q5-revenue panes: card and CPU columns differ")
    n_equal = len(cpu_rows)
    for name in cpu_rows.names():
        g, w = np.asarray(card_rows[name]), np.asarray(cpu_rows[name])
        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
            raise AssertionError(f"Q5-revenue panes: column {name} of the "
                                 f"card's {len(g)} rows != the CPU's "
                                 f"{len(w)}")

    # (b) the main run: rows against the oracle
    panes = PaneTables()
    try:
        sink, elapsed, counts, lat = _run_job(torch, lambda env: build_revenue(
            env, BidSource(total_records=records, num_auctions=AUCTIONS,
                           events_per_second_of_eventtime=RATE)), "cuda", 1,
            "panes")
    finally:
        panes.close()
    if counts["ordered_fold"] <= 0:
        raise AssertionError("Q5-revenue panes ran without the ordered fold")
    res = sink.result()
    want, cnt = revenue_oracle(BidSource, records, AUCTIONS, RATE, SIZE,
                               SLIDE)
    e = np.asarray(res["window_end"]) // SLIDE - 1
    a = np.asarray(res["auction"]).astype(np.int64)
    s = np.asarray(res["sum_price"], dtype=np.float32)
    pair = e * AUCTIONS + a
    present = cnt > 0
    if e.min() < 0 or e.max() >= len(want) or \
            len(np.unique(pair)) != len(pair) or \
            len(pair) != int(present.sum()) or \
            not present.reshape(-1)[pair].all():
        raise AssertionError(f"Q5-revenue panes fired {len(pair)} rows, the "
                             f"oracle's windows hold {int(present.sum())}")
    w, n = want[e, a].astype(np.float64), cnt[e, a]
    if (w <= 0).any():
        raise AssertionError("Q5-revenue panes: a non-positive oracle sum")
    rel = np.abs(s.astype(np.float64) - w) / w
    bound = 2.0 * np.maximum(n - 1, 0) * 2.0 ** -24
    over = int((rel > bound).sum())
    if over:
        raise AssertionError(f"Q5-revenue panes: {over} sums beyond "
                             "2 (n - 1) 2^-24 of the oracle's")
    differ = int((want[e, a].view(np.int32) != s.view(np.int32)).sum())

    # (d) one timed fold at the run's [1, R*C] shape
    table = panes.tables[-1]
    flat, values = panes.largest
    R, C = table.R, table.capacity
    slots = torch.from_numpy(flat.astype(np.int32)).cuda()[None]
    vals = torch.from_numpy(values[0].astype(np.float32)).cuda()[None]
    acc = torch.zeros(1, R * C, device="cuda")
    got = ordered_fold_planes(acc.clone(), slots, vals, "sum")
    ref = ordered_fold_planes_plain(acc.cpu(), slots.cpu(), vals.cpu(),
                                    "sum")
    if not torch.equal(_bits(got.cpu()), _bits(ref)):
        raise AssertionError("ordered fold at [1, R*C] != its plain version")
    del got, ref
    real = int((slots != 0).sum())
    touched = int(torch.unique(slots[slots != 0]).numel())
    nbytes = 4 * slots.numel() + 4 * real + 8 * touched
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    work = acc.clone()
    ms = cuda_ms(lambda: ordered_fold_planes(work, slots, vals, "sum"), 20)
    plain_ms = cuda_ms(lambda: ordered_fold_planes_plain(work, slots, vals,
                                                         "sum"), 20)
    fold = {"planes": 1, "width": R * C, "ring_rows": R, "capacity": C,
            "lanes": slots.numel(), "real_lanes": real, "targets": touched,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "max_abs_err": 0.0}
    del work, acc
    out = {"parallelism": 1, "layout": "panes", "records": records,
           "elapsed_s": elapsed, "events_per_s": records / elapsed,
           "rows": len(s), "rows_bitwise_differing_from_slot_order": differ,
           "max_rel_err": float(rel.max()), "launches": counts,
           "fire_latency_ms": lat, "pane_state": panes.state(),
           "card_equals_cpu_rows": n_equal, "cpu_s": cpu_s,
           "fold_at_ring_shape": fold}
    print(f"phase 11: Q5-revenue P=1 (panes) — first {equal_records} bids: "
          f"all {n_equal} rows equal on the card and the CPU in order, bit "
          f"for bit; {records} bids in {elapsed:.3f} s = "
          f"{records / elapsed:.0f} events/s, {len(s)} rows fired as the "
          f"oracle's, every sum within 2 (n - 1) 2^-24 of it (max rel "
          f"{rel.max():.3g}; {differ} differ from the slot-order sum in "
          f"bits); launches {counts}; fire latency p50 {lat.get('p50')} ms "
          f"p99 {lat.get('p99')} ms; pane state {panes.state()}; ordered "
          f"fold at [1, {R}*{C}] with {slots.numel()} lanes ({touched} "
          f"targets): {ms:.4f} ms, plain {plain_ms:.4f} ms, bytes bound "
          f"{bound_ms:.5f} ms")
    print("revenue P=1 panes " + json.dumps(out))
    return out


def _spill_run(torch, device, bids, budget):
    """Fired batches and spill counters of a float32 Sum over ``bids`` on
    the single-device engine with a device budget of ``budget`` slots, and
    the most slices its spill tier held."""
    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.windower import SliceSharedWindower

    w = SliceSharedWindower(
        SlidingEventTimeWindows.of(SIZE, SLIDE), SumAggregate("v"),
        capacity=budget, spill={"device": device, "max_device_slots": budget})
    fired, peak = [], 0
    for keys, vals, ts in bids:
        w.process_batch(RecordBatch.from_pydict(
            {KEY_ID_FIELD: keys, "v": vals}, timestamps=ts))
        peak = max(peak, len(w.table.spill))
        fired.extend(w.on_watermark(int(ts.max()) - 1))
    fired.extend(w.on_watermark(1 << 62))
    return fired, w.spill_counters(), peak


def phase_spill(torch, records: int = 3_000_000, budget: int = 1 << 17):
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    src = BidSource(total_records=records, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=RATE)
    src.open()
    rng = np.random.default_rng(3)
    bids = []
    while (b := src.poll_batch(1 << 18)) is not None:
        vals = _sum_specials(rng, rng.standard_normal(len(b))
                             .astype(np.float32))
        bids.append((np.asarray(b["auction"], dtype=np.int64), vals,
                     np.asarray(b.timestamps, dtype=np.int64)))
    t0 = time.perf_counter()
    card, card_counters, peak = _spill_run(torch, "cuda", bids, budget)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu, cpu_counters, _ = _spill_run(torch, "cpu", bids, budget)
    if peak == 0:
        raise AssertionError("forced-eviction run: nothing spilled")
    if len(card) != len(cpu):
        raise AssertionError(f"forced-eviction run: {len(card)} fired "
                             f"batches on the card, {len(cpu)} on the CPU")
    rows = nan_rows = 0
    for g, w in zip(card, cpu):
        for name in w.columns:
            gc, wc = np.asarray(g[name]), np.asarray(w[name])
            if gc.dtype.kind == "f":
                nan_rows += int(np.isnan(wc).sum())
                gc, wc = gc.view(np.int32), wc.view(np.int32)
            if gc.dtype != wc.dtype or not np.array_equal(gc, wc):
                raise AssertionError(f"forced-eviction run: column {name} "
                                     "differs between the card and the CPU")
        rows += len(w)
    if card_counters != cpu_counters:
        raise AssertionError(f"spill counters differ: card {card_counters},"
                             f" CPU {cpu_counters}")
    out = {"records": records, "max_device_slots": budget,
           "fired_batches": len(card), "rows": rows, "nan_rows": nan_rows,
           "peak_spilled_slices": peak, "spill_counters": card_counters,
           "card_s": card_s}
    print(f"phase 9: forced eviction (budget {budget} slots, up to {peak} "
          f"slices spilled): {len(card)} fired batches, {rows} rows "
          f"({nan_rows} NaN) equal on the card and the CPU bit for bit; "
          f"spill counters equal")
    print("spill " + json.dumps(out))
    return out


def sessions_of_stream(keys, vals, ts, split_of, wm_before):
    """Sessions by NumPy over a stream in arrival order: records sorted by
    (key, timestamp), stable; a new session where the key changes, where
    the gap to the key's previous record is above 2,000 ms, and where it
    is exactly 2,000 ms and the previous session had fired before the
    record arrived: the record lies in a later ingest split than its
    predecessor and the watermark before its split (``wm_before[split]``)
    reached the session's last millisecond (``t - 1``). ``split_of[i]``:
    the ingest split of record i. Returns ``(keys, starts, ends, float32
    stream-order sums, record counts)``, sorted by key and start."""
    from flink_tpu_torch.benchmarks.session_profile import ROW5_GAP

    order = np.lexsort((ts, keys))
    k, t, v = keys[order], ts[order], vals[order]
    sq = split_of[order]
    new = np.ones(len(k), dtype=bool)
    same = k[1:] == k[:-1]
    diff = t[1:] - t[:-1]
    closed = ((diff == ROW5_GAP) & (sq[1:] > sq[:-1])
              & (wm_before[sq[1:]] >= t[1:] - 1))
    new[1:] = ~same | (diff > ROW5_GAP) | closed
    first = np.nonzero(new)[0]
    n = np.diff(np.append(first, len(k)))
    sums = np.zeros(len(first), np.float32)
    for j in range(int(n.max())):   # stream order, in float32
        live = n > j
        sums[live] += v[first[live] + j]
    return k[first], t[first], t[first + n - 1] + ROW5_GAP, sums, n


def mesh_oracle(records: int, split_starts):
    """Phase 13(a)'s sessions by NumPy: the stream of
    ``benchmarks/mesh_sessions.py`` over ``records`` records, sums of
    ones, each record in the ingest split that the loop's
    ``split_starts`` (the first record of each split) place it in, the
    watermark before a split that of the record before it."""
    from flink_tpu_torch.benchmarks import mesh_sessions as ms

    starts = np.asarray(split_starts)
    keys, ts = (np.concatenate(c) for c in zip(*ms.stream_batches(records)))
    split_of = np.searchsorted(starts, np.arange(records), side="right") - 1
    wm_before = np.where(starts > 0, ts[np.maximum(starts - 1, 0)],
                         np.iinfo(np.int64).min // 2)
    return sessions_of_stream(keys, np.ones(records, np.float32), ts,
                              split_of, wm_before)


def session_oracle(records: int, batch: int):
    """Row 5's sessions by NumPy over the same stream, fed to the executor
    in micro-batches of ``batch``: the watermark before a batch is the
    previous batch's largest timestamp less 1 (bounded out-of-orderness
    0)."""
    from flink_tpu_torch.benchmarks.session_profile import row5_source

    src = row5_source(records)
    src.open()
    parts = []
    while (b := src.poll_batch(1 << 22)) is not None:
        parts.append((np.asarray(b["key"], np.int64),
                      np.asarray(b["value"], np.float32),
                      np.asarray(b.timestamps, np.int64)))
    keys, vals, ts = (np.concatenate(c) for c in zip(*parts))
    split_of = np.arange(records) // batch
    last = ts[np.minimum((np.arange(split_of[-1] + 1)) * batch,
                         records) - 1]
    wm_before = np.where(np.arange(len(last)) > 0, last - 1,
                         np.iinfo(np.int64).min // 2)
    return sessions_of_stream(keys, vals, ts, split_of, wm_before)


def _jittered_specials(base_cls, jitter: int):
    """A DataGenSource whose timestamps move back by up to ``jitter`` ms and
    whose values carry phase 4's max/min specials (NaN payloads, signed
    zeros), both fixed by the record indices: out of order, so sessions
    merge."""
    from flink_tpu_torch.connectors.sources import _splitmix64

    class Jittered(base_cls):
        def _generate(self, idx):
            b = super()._generate(idx)
            late = (_splitmix64(idx, 99) % np.uint64(jitter)).astype(np.int64)
            vals = _with_specials(np.random.default_rng(int(idx[0])),
                                  np.asarray(b["value"], np.float32))
            return b.with_column("value", vals).with_timestamps(
                b.timestamps - late)

    return Jittered


def _rows_equal(what, got, want):
    """Sink rows equal in order, every column bit for bit."""
    g, w = got.result(), want.result()
    if len(g) != len(w) or sorted(g.names()) != sorted(w.names()):
        raise AssertionError(f"{what}: {len(g)} rows on the card, {len(w)} "
                             "on the CPU")
    for name in w.names():
        a, b = np.asarray(g[name]), np.asarray(w[name])
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{what}: column {name} differs between "
                                 "the card and the CPU")
    return len(w)


def merge_plain(torch, acc, dst, src):
    """flat_merge_pairs' plain version on one float32 leaf: the moved
    values gathered first, folded by the ordered fold's plain version
    (``index_add_``: on the card its atomics give other bits), the sources
    reset."""
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes_plain

    idx = src.to(torch.int64)
    moved = acc[idx]
    ordered_fold_planes_plain(acc.view(1, -1), dst.view(1, -1),
                              moved.view(1, -1), "sum")
    return acc.index_fill_(0, idx, 0.0)


def fold_at_ingest(torch, seen):
    """One timed ordered fold at row 5's ingest shape, on the inputs that
    the card's session run gave its last ingest fold with the most real
    lanes (``seen``: acc, slots, values, reduce): equal bit for bit to its plain
    version on the CPU (on the card the plain version's ``index_add_``
    atomics give other bits), then the wrapper's host ms, the device ms by
    CUDA events, the plain version's ms and the bytes bound (4 B of slot
    and 4 B of value per real lane, a read and a write of each touched
    slot; the lanes at slot 0 are padding)."""
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    if not seen:
        raise AssertionError("phase 12(d): the session run made no ingest "
                             "fold to time")
    acc, s, v, reduce = seen["acc"], seen["slots"], seen["values"], \
        seen["reduce"]
    got = ordered_fold_planes(acc.clone(), s, v, reduce)
    want = ordered_fold_planes_plain(acc.cpu(), s.cpu(), v.cpu(), reduce)
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError("phase 12(d): the ordered fold at the ingest "
                             "shape != its plain version")
    real = s[s != 0]
    n, touched = int(real.numel()), int(torch.unique(real).numel())
    bound_ms = (8 * n + 8 * touched) / HBM_BYTES_PER_S * 1e3
    work = acc.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        ordered_fold_planes(work, s, v, reduce)
    wrapper_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: ordered_fold_planes(work, s, v, reduce), 50)
    plain_ms = cuda_ms(
        lambda: ordered_fold_planes_plain(work, s, v, reduce), 50)
    return {"planes": int(s.shape[0]), "cap": int(acc.shape[1]),
            "lanes": int(s.shape[1]), "real_lanes": n, "targets": touched,
            "wrapper_ms": wrapper_ms, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "max_abs_err": 0.0}


def phase_sessions(torch, records: int, equal_records: int = 2_000_000,
                   merge_records: int = 1_000_000):
    """Phase 12: BASELINE row 5 (sessions, 10M keys, the paged spill tier)
    through the public API at parallelism 1."""
    import flink_tpu_torch.native as native
    from flink_tpu_torch.benchmarks.session_profile import (
        ROW5_KEYS,
        ROW5_SETTINGS,
        row5_source,
        run_sessions,
    )
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.ops.segment_ops import pad_bucket_size
    from flink_tpu_torch.stateplane.families import flat_merge_pairs
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    # (a) the full run, against the NumPy oracle
    fallbacks = native.native_fallbacks()
    reset_counts()
    sink, wall, result, eng = run_sessions(row5_source(records))
    counts = read_counts()
    if counts["ordered_fold"] <= 0:
        raise AssertionError("phase 12: the session run made no ordered-fold "
                             "launch")
    native_plane = (type(eng.meta).__name__ == "NativeSessionIntervalSet"
                    and eng.meta.native_sweep_s > 0
                    and native.native_fallbacks() == fallbacks)
    if not native_plane:
        raise AssertionError("phase 12: the native session plane did not run")
    spill = eng.spill_counters()
    if eng.late_records_dropped:
        raise AssertionError(f"phase 12: {eng.late_records_dropped} late "
                             "records dropped from a stream in order")
    if spill["rows_evicted"] <= 0 or spill["rows_reloaded"] <= 0:
        raise AssertionError(f"phase 12: the paged tier did not evict and "
                             f"reload ({spill})")
    lat = result.metrics.get("window_fire_latency_ms", {})
    state_bytes = sum(a.numel() * a.element_size() for a in eng.table.accs)
    res = sink.result()
    got_k = np.asarray(res["key"], np.int64)
    got_s = np.asarray(res["window_start"], np.int64)
    got_e = np.asarray(res["window_end"], np.int64)
    got_v = np.asarray(res["sum_value"], np.float32)
    o = np.lexsort((got_s, got_k))
    got_k, got_s, got_e, got_v = got_k[o], got_s[o], got_e[o], got_v[o]
    t0 = time.perf_counter()
    wk, ws, we, wv, wn = session_oracle(
        records, ROW5_SETTINGS["execution.micro-batch.size"])
    oracle_s = time.perf_counter() - t0
    if not (np.array_equal(got_k, wk) and np.array_equal(got_s, ws)
            and np.array_equal(got_e, we)):
        raise AssertionError(f"phase 12: {len(got_k)} session rows, the "
                             f"oracle's {len(wk)}: the (key, start, end) "
                             "multisets differ")
    rel = np.abs(got_v.astype(np.float64) - wv) / np.maximum(
        np.abs(wv.astype(np.float64)), np.finfo(np.float32).tiny)
    bound = 2.0 * (wn - 1) * 2.0 ** -24
    over = int((rel > bound).sum())
    if over:
        raise AssertionError(f"phase 12: {over} session sums beyond "
                             "2 (n - 1) 2^-24 of the oracle's")
    differ = int((got_v.view(np.int32) != wv.view(np.int32)).sum())

    # (b) the card against the CPU over the first 2M records; the card's
    # run keeps the inputs of its last ingest fold with the most real
    # (non-padding) lanes — a full batch, mid-stream, the table full — for
    # (d)
    import flink_tpu_torch.stateplane.fold as fold_mod

    launch, seen = fold_mod._launch, {}

    def capture(acc, slots, values, reduce, cap, fold):
        real = int((slots != 0).sum()) if fold else -1
        if fold and real >= seen.get("real", 0):
            seen.update(real=real, acc=acc.clone(), slots=slots.clone(),
                        values=values.clone(), reduce=reduce)
        return launch(acc, slots, values, reduce, cap, fold)

    fold_mod._launch = capture
    try:
        card, _, _, ceng = run_sessions(row5_source(equal_records))
    finally:
        fold_mod._launch = launch
    cpu, cpu_s, _, peng = run_sessions(row5_source(equal_records), "cpu")
    n_equal = _rows_equal("phase 12(b)", card, cpu)
    if ceng.spill_counters() != peng.spill_counters():
        raise AssertionError(f"phase 12(b): spill counters differ: card "
                             f"{ceng.spill_counters()}, CPU "
                             f"{peng.spill_counters()}")

    # (c) float32 Max over NaN payloads and signed zeros, out of order so
    # that sessions merge, under a budget of 1<<15 rows
    merge_settings = {"execution.micro-batch.size": 1 << 13,
                      "state.slot-table.capacity": 1 << 15,
                      "state.slot-table.max-device-slots": 1 << 15}
    src_cls = _jittered_specials(DataGenSource, 3_000)
    reset_counts()
    mcard, _, _, meng = run_sessions(
        src_cls(merge_records, 100_000, 400_000, seed=3), "cuda",
        merge_settings, agg="max", out_of_orderness=3_000)
    mcounts = read_counts()
    mcpu, _, _, mpeng = run_sessions(
        src_cls(merge_records, 100_000, 400_000, seed=3), "cpu",
        merge_settings, agg="max", out_of_orderness=3_000)
    m_equal = _rows_equal("phase 12(c)", mcard, mcpu)
    if meng.spill_counters() != mpeng.spill_counters() \
            or meng.merge_groups != mpeng.merge_groups:
        raise AssertionError("phase 12(c): spill counters or merges differ")
    if meng.merge_groups <= 0 or meng.spill_counters()["rows_evicted"] <= 0:
        raise AssertionError("phase 12(c): no merge or no eviction")

    # (d) one flat_merge_pairs at the largest merge group's lanes, on row
    # 5's table ([1<<19] float32); run (a) merges nothing (its timestamps
    # rise with the record index), so the group is run (c)'s
    cap = ROW5_SETTINGS["state.slot-table.capacity"]
    pairs = meng.merge_pairs_max
    size = pad_bucket_size(pairs)
    rng = np.random.default_rng(12)
    perm = rng.permutation(np.arange(1, cap))
    dst = np.zeros(size, np.int32)
    src = np.zeros(size, np.int32)
    dst[:pairs] = rng.choice(perm[:max(pairs // 2, 1)], pairs)
    src[:pairs] = perm[cap // 2:cap // 2 + pairs]
    d, s_ = torch.from_numpy(dst).cuda(), torch.from_numpy(src).cuda()
    acc0 = torch.from_numpy(rng.random(cap).astype(np.float32)).cuda()
    acc0[0] = 0.0
    prog = flat_merge_pairs(SumAggregate("value").leaves)
    got = prog((acc0.clone(),), d, s_)[0]
    want = prog((acc0.cpu(),), d.cpu(), s_.cpu())[0]
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError("phase 12(d): flat_merge_pairs on the card != "
                             "the CPU")
    work = acc0.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        prog((work,), d, s_)
    wrapper_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: prog((work,), d, s_), 50)
    plain_ms = cuda_ms(lambda: merge_plain(torch, work, d, s_), 50)
    touched = len(np.unique(dst[:pairs]))
    # per real pair: its dst and src, the moved value read and the source
    # reset; per dst slot a read and a write (padded lanes are the
    # program's own padding, not work)
    nbytes = 16 * pairs + 8 * touched
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    merge = {"table": cap, "pairs": pairs, "lanes": size,
             "dst_targets": touched, "wrapper_ms": wrapper_ms, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": "bytes"}
    ingest = fold_at_ingest(torch, seen)

    out = {"records": records, "keys": ROW5_KEYS, "elapsed_s": wall,
           "events_per_s": records / wall, "fire_latency_ms": lat,
           "spill_counters": spill,
           "late_records_dropped": eng.late_records_dropped,
           "state_bytes": state_bytes, "native_plane": native_plane,
           "native_sweep_s": eng.meta.native_sweep_s,
           "merge_groups": eng.merge_groups, "launches": counts,
           "sessions": len(wk), "sums_bitwise_differing": differ,
           "max_rel_err": float(rel.max()), "oracle_s": oracle_s,
           "card_equals_cpu_rows": n_equal, "cpu_s": cpu_s,
           "card_equals_cpu_max_rows": m_equal,
           "max_job": {"records": merge_records, "keys": 100_000,
                       "merge_groups": meng.merge_groups,
                       "merge_pairs_max": pairs,
                       "spill_counters": meng.spill_counters(),
                       "launches": mcounts},
           "merge_timing": merge, "ingest_fold_timing": ingest}
    print(f"phase 12: BASELINE row 5 sessions P=1, {records} records over "
          f"{ROW5_KEYS} keys in {wall:.3f} s = {records / wall:.0f} events/s; fire "
          f"latency p50 {lat.get('p50')} ms p99 {lat.get('p99')} ms; "
          f"{len(wk)} sessions equal to the oracle's (key, start, end) and "
          f"every sum within 2 (n - 1) 2^-24 ({differ} differ in bits); "
          f"spill {spill}; late records dropped "
          f"{eng.late_records_dropped}; state {state_bytes} B on the card; "
          f"native plane ran ({eng.meta.native_sweep_s:.3f} s in sweeps); "
          f"launches {counts}; (b) first {equal_records} records: "
          f"{n_equal} rows equal on the card and the CPU, spill counters "
          f"equal; (c) Max with NaN payloads, out of order: {m_equal} rows "
          f"equal, {meng.merge_groups} merge groups (largest {pairs} "
          f"pairs); (d) flat_merge_pairs at [{cap}] with {size} lanes: "
          f"wrapper {wrapper_ms:.4f} ms, device {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bytes bound {bound_ms:.5f} ms; the ingest "
          f"fold at [1, {cap}] with {ingest['lanes']} lanes "
          f"({ingest['real_lanes']} real, {ingest['targets']} targets): "
          f"wrapper {ingest['wrapper_ms']:.4f} ms, device "
          f"{ingest['ms']:.4f} ms, plain {ingest['plain_ms']:.4f} ms, bytes "
          f"bound {ingest['bound_ms']:.5f} ms")
    print("sessions " + json.dumps(out))
    return out


def mesh_merge_timing(torch, captured, reduce):
    """Phase 13(d): the mesh merge step alone at (c)'s largest merge group
    (its [P, M] blocks on (c)'s [P, cap] planes) for one float32 leaf of
    ``reduce``: the card equal to the CPU bit for bit, then the wrapper's
    host ms, the device ms by torch.profiler, the plain version's ms on
    the card (a gather, the ordered fold's plain version — ``index_add_``
    for sums, ``scatter_reduce_`` with the NaN rule for max —, a reset)
    and the bytes bound: 16 B per real pair (its dst and src, the moved
    value read, the source reset) plus 8 B per destination slot (a read
    and a write) at 3.35 TB/s."""
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import (
        build_session_merge_step,
    )
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes_plain
    from flink_tpu_torch.windowing import aggregates as tagg

    agg = tagg.SumAggregate("value") if reduce == "sum" \
        else tagg.MaxAggregate("value")
    acc, d, s_ = captured["acc"], captured["dst"], captured["src"]
    P = int(acc.shape[0])
    if reduce == "sum":   # (c) is a Max job: Sum folds finite values
        rng = np.random.default_rng(13)
        acc = torch.from_numpy(rng.standard_normal(tuple(acc.shape))
                               .astype(np.float32)).cuda()
        acc[:, 0] = 0.0
    step = build_session_merge_step(make_mesh(P, "cuda"), agg)
    got = step((acc.clone(),), d, s_)[0]
    want = build_session_merge_step(make_mesh(P, "cpu"), agg)(
        (acc.cpu(),), d.cpu(), s_.cpu())[0]
    if not torch.equal(_bits(got.cpu()), _bits(want)):
        raise AssertionError(f"phase 13(d): the mesh merge step ({reduce}) "
                             "on the card != the CPU")
    work = acc.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        step((work,), d, s_)
    wrapper_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    ms = device_us_per_call(lambda: step((work,), d, s_), 50, [""])[""]
    ms = None if ms is None else ms / 1e3
    event_ms = cuda_ms(lambda: step((work,), d, s_), 50)

    def plain():
        idx = s_.to(torch.int64)
        moved = torch.gather(work, 1, idx)
        ordered_fold_planes_plain(work, d, moved, reduce)
        work.scatter_(1, idx, float(agg.leaves[0].identity))

    plain_ms = cuda_ms(plain, 50)
    real = s_ != 0
    pairs = int(real.sum())
    dests = sum(int(torch.unique(d[p][real[p]]).numel()) for p in range(P))
    bound_ms = (16 * pairs + 8 * dests) / HBM_BYTES_PER_S * 1e3
    return {"reduce": reduce, "planes": P, "cap": int(acc.shape[1]),
            "lanes": int(d.shape[1]), "real_pairs": pairs,
            "dst_targets": dests, "wrapper_ms": wrapper_ms,
            "device_ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def phase_mesh_sessions(torch, equal_records: int = 2_000_000,
                        merge_records: int = 1_000_000):
    """Phase 13: BASELINE row 5 on the mesh session engine at P=8."""
    import flink_tpu_torch.native as native
    import flink_tpu_torch.parallel.sharded_sessions as ss
    import flink_tpu_torch.stateplane.fold as fold_mod
    from flink_tpu_torch.benchmarks import mesh_sessions as ms
    from flink_tpu_torch.benchmarks.session_profile import (
        row5_source,
        run_sessions,
    )
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.core.records import KEY_ID_FIELD

    # (a) the reference's mesh-sessions shape through the benchmark loop,
    # every fired session against the NumPy oracle; never cut
    records = ms.RECORDS
    ms.load_libraries("cuda")
    fallbacks = native.native_fallbacks()
    reset_counts()
    r = ms.run(records, "cuda", collect=True)
    counts = read_counts()
    eng = r.pop("engine")
    batches, starts = r.pop("batches"), r.pop("split_starts")
    if counts["exchange_rank"] <= 0 or counts["ordered_fold"] <= 0:
        raise AssertionError(f"phase 13(a): a kernel did not launch "
                             f"({counts})")
    if not (type(eng.meta).__name__ == "NativeSessionIntervalSet"
            and native.native_fallbacks() == fallbacks):
        raise AssertionError("phase 13(a): the native session plane did "
                             "not run")
    spill = r["spill"]
    if spill["rows_evicted"] <= 0 or spill["rows_reloaded"] <= 0:
        raise AssertionError(f"phase 13(a): the paged tier did not evict "
                             f"and reload ({spill})")
    if eng.late_records_dropped:
        raise AssertionError("phase 13(a): late records dropped from a "
                             "stream in order")
    got_k = np.concatenate([np.asarray(b[KEY_ID_FIELD], np.int64)
                            for b in batches])
    got_s = np.concatenate([np.asarray(b["window_start"], np.int64)
                            for b in batches])
    got_e = np.concatenate([np.asarray(b["window_end"], np.int64)
                            for b in batches])
    got_v = np.concatenate([np.asarray(b["sum_v"], np.float32)
                            for b in batches])
    o = np.lexsort((got_s, got_k))
    got_k, got_s, got_e, got_v = got_k[o], got_s[o], got_e[o], got_v[o]
    t0 = time.perf_counter()
    wk, ws, we, wv, wn = mesh_oracle(records, starts)
    oracle_s = time.perf_counter() - t0
    if not (np.array_equal(got_k, wk) and np.array_equal(got_s, ws)
            and np.array_equal(got_e, we)
            and got_v.tobytes() == wv.tobytes()):
        raise AssertionError(f"phase 13(a): {len(got_k)} sessions fired, the "
                             f"oracle's {len(wk)}: (key, start, end, sum) "
                             "differ")

    # (b) row 5's job at P=8 through env.execute, card against CPU, a
    # 1<<16-row budget per shard (eviction starts), deadline off
    p8 = {"parallelism.default": 8, "state.slot-table.capacity": 1 << 16,
          "state.slot-table.max-device-slots": 1 << 16}
    reset_counts()
    card, card_s, _, ceng = run_sessions(row5_source(equal_records), "cuda",
                                         p8)
    b_counts = read_counts()
    cpu, cpu_s, _, peng = run_sessions(row5_source(equal_records), "cpu", p8)
    n_equal = _rows_equal("phase 13(b)", card, cpu)
    if ceng.spill_counters() != peng.spill_counters():
        raise AssertionError(f"phase 13(b): spill counters differ: card "
                             f"{ceng.spill_counters()}, CPU "
                             f"{peng.spill_counters()}")
    if ceng.spill_counters()["rows_evicted"] <= 0:
        raise AssertionError("phase 13(b): no eviction")

    # (c) phase 12(c)'s out-of-order float32 Max with NaN payloads and
    # signed zeros at P=8 under 1<<12 rows a shard; the merges' ordered-
    # fold launches are counted and the largest merge group kept for (d)
    merge_settings = {"parallelism.default": 8,
                      "execution.micro-batch.size": 1 << 13,
                      "state.slot-table.capacity": 1 << 12,
                      "state.slot-table.max-device-slots": 1 << 12}
    build, merge = ss.build_session_merge_step, {"launches": 0, "real": -1}

    def counted_build(mesh, agg):
        step = build(mesh, agg)
        if mesh.device.type != "cuda":
            return step

        def counted(accs, dst, src):
            real = int((src != 0).sum())
            if real > merge["real"]:
                merge.update(real=real, acc=accs[0].clone(),
                             dst=dst.clone(), src=src.clone())
            before = fold_mod.ordered_fold_planes.launches
            out = step(accs, dst, src)
            merge["launches"] += (fold_mod.ordered_fold_planes.launches
                                  - before)
            return out
        return counted

    src_cls = _jittered_specials(DataGenSource, 3_000)
    ss.build_session_merge_step = counted_build
    try:
        reset_counts()
        mcard, _, _, meng = run_sessions(
            src_cls(merge_records, 100_000, 400_000, seed=3), "cuda",
            merge_settings, agg="max", out_of_orderness=3_000)
        c_counts = read_counts()
    finally:
        ss.build_session_merge_step = build
    mcpu, _, _, mpeng = run_sessions(
        src_cls(merge_records, 100_000, 400_000, seed=3), "cpu",
        merge_settings, agg="max", out_of_orderness=3_000)
    m_equal = _rows_equal("phase 13(c)", mcard, mcpu)
    if meng.spill_counters() != mpeng.spill_counters() \
            or meng.merge_groups != mpeng.merge_groups:
        raise AssertionError("phase 13(c): spill counters or merges differ")
    if meng.merge_groups <= 0 or meng.spill_counters()["rows_evicted"] <= 0 \
            or merge["launches"] <= 0:
        raise AssertionError(f"phase 13(c): no merge, no eviction or no "
                             f"ordered fold in merges ({merge['launches']})")

    # (d) the mesh merge step alone at (c)'s largest group
    timing = [mesh_merge_timing(torch, merge, red) for red in ("sum", "max")]

    for what, c in (("13(b)", b_counts), ("13(c)", c_counts)):
        if c["exchange_rank"] <= 0 or c["ordered_fold"] <= 0:
            raise AssertionError(f"phase {what}: a kernel did not launch "
                                 f"({c})")
    launches = {k: counts[k] + b_counts[k] + c_counts[k] for k in counts}
    lat = r["fire_latency_ms"]
    out = {"records": records, "events_per_s": r["events_per_s"],
           "wall_s": r["wall_s"], "fire_latency_ms": lat, "spill": spill,
           "rewrite_amplification": r["rewrite_amplification"],
           "breakdown": r["breakdown"], "sessions": len(wk),
           "oracle_s": oracle_s, "launches_a": counts,
           "launches": launches,
           "card_equals_cpu_rows": n_equal, "b_card_s": card_s,
           "b_cpu_s": cpu_s, "b_spill": ceng.spill_counters(),
           "card_equals_cpu_max_rows": m_equal,
           "max_job": {"records": merge_records,
                       "merge_groups": meng.merge_groups,
                       "merge_pairs_max": meng.merge_pairs_max,
                       "merge_fold_launches": merge["launches"],
                       "spill": meng.spill_counters()},
           "merge_timing": timing}
    print(f"phase 13: BASELINE row 5 on the mesh engine P=8, {records} "
          f"records: {r['events_per_s']:.0f} events/s, fire p50 "
          f"{lat['p50']:.2f} ms p99 {lat['p99']:.2f} ms ({lat['count']} "
          f"fires); {len(wk)} sessions equal to the oracle (key, start, "
          f"end, sum bits); spill {spill}; amplification "
          f"{r['rewrite_amplification']:.4f}; launches {counts}; (b) first "
          f"{equal_records} records at P=8 through env.execute: {n_equal} "
          f"rows equal on the card and the CPU, spill counters equal "
          f"({ceng.spill_counters()}); (c) Max with NaN payloads, out of "
          f"order, P=8: {m_equal} rows equal, {meng.merge_groups} merge "
          f"groups (largest {meng.merge_pairs_max} pairs a shard), "
          f"{merge['launches']} ordered-fold launches in merges; (d) "
          + "; ".join(f"{t['reduce']}: wrapper {t['wrapper_ms']:.4f} ms, "
                      f"device {t['device_ms']} ms, events "
                      f"{t['event_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                      f"ms, bound {t['bound_ms']:.7f} ms"
                      for t in timing))
    print("mesh_sessions " + json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=40_000_000,
                    help="Q5 records (40M: the size of bench.py's run)")
    ap.add_argument("--revenue-records", type=int, default=10_000_000,
                    help="Q5-revenue records")
    ap.add_argument("--session-records", type=int, default=12_000_000,
                    help="BASELINE row 5 session records (12M: its size)")
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
    q5_p1 = phase_q5(torch, args.records, parallelism=1)
    rev_p1 = phase_revenue(torch, args.revenue_records, parallelism=1)
    phase_fold_p1(torch)
    phase_spill(torch)
    q5_panes = phase_q5(torch, args.records, parallelism=1, layout="panes")
    rev_panes = phase_revenue_panes(torch, args.revenue_records)
    sessions = phase_sessions(torch, args.session_records)
    mesh_sessions = phase_mesh_sessions(torch)
    runs = (q5, rev, q5_p1, rev_p1, q5_panes, rev_panes, sessions,
            mesh_sessions)

    kernels = [{
        "name": "exchange_rank",
        "route": "cuda",
        "source": "flink_tpu_torch/csrc/rank.cu",
        "replaces": "flink_tpu/stateplane/rank.py:75",
        "launches": sum(r["launches"]["exchange_rank"] for r in runs),
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
        "launches": sum(r["launches"]["ordered_fold"] for r in runs),
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
