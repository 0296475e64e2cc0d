#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flink_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--records N]

Phases, each fatal on failure (no result line is printed then):

1. build the exchange-rank kernel (flink_tpu_torch/csrc/rank.cu) with nvcc;
2. hold it bit-identical to its plain PyTorch version on the card, over
   random shapes (D 1..64, R 1..8, C up to 1<<20, with negative and
   out-of-range lanes);
3. time it at the shapes Nexmark Q5 gives it (R=8 shards, C=131072 lanes,
   D=8), beside its plain version and its memory bound (bytes at
   3.35 TB/s);
4. run the exchange+scatter step on the card and on the CPU for Count
   (exact) and float32 Sum (within a stated atomics-reordering bound);
5. run Nexmark Q5 through the public API at parallelism.default=8 (100k
   auctions, 100k events/s of event time, 10 s / 2 s HOP, top-k 16,
   micro-batches of 1<<20 records) and check every fired window's winners
   against a NumPy oracle computed here; the rank kernel's launch count
   over that run must be > 0.

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


def phase_rank_parity(torch, rank, rank_plain):
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
        got = rank(d, D)
        want = rank_plain(d, D)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"rank kernel != rank_plain at R={R} C={C} D={D}: "
                f"{bad} lanes differ")
        if R == 1:  # the [C] form too
            if not torch.equal(rank(d[0], D), want[0]):
                raise AssertionError(f"1-D rank differs at C={C} D={D}")
    print(f"phase 2: rank kernel bit-identical to rank_plain on "
          f"{len(cases)} shapes (D 1..64, R 1..8, C up to {1 << 20})")


def phase_rank_timing(torch, rank, rank_plain):
    R, C, D = Q5_SHAPE
    rng = np.random.default_rng(7)
    d = torch.from_numpy(rng.integers(0, D + 1, size=(R, C))
                         .astype(np.int32)).cuda()
    err = (rank(d, D) - rank_plain(d, D)).abs().max().item()
    ms = cuda_ms(lambda: rank(d, D), 200)
    plain_ms = cuda_ms(lambda: rank_plain(d, D), 50)
    nbytes = 2 * 4 * R * C          # each lane read once, written once
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 3: rank at R={R} C={C} D={D}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "max_abs_err": float(err)}


def phase_exchange_scatter(torch):
    from flink_tpu_torch.ops.segment_ops import torch_dtype
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.shuffle import (
        build_exchange_scatter,
        shard_records,
        stage_device_exchange,
    )
    from flink_tpu_torch.windowing.aggregates import (
        CountAggregate,
        SumAggregate,
    )

    P, cap, n = 8, 1 << 15, 1 << 20
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 100_000, n).astype(np.int64)
    shards = shard_records(keys, P, 128)
    slots = rng.integers(1, cap, n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    report = {}
    for name, agg in (("count", CountAggregate()),
                      ("sum_f32", SumAggregate("v"))):
        cols = [slots] + ([vals] if agg.input_leaves else [])
        dst, staged, width = stage_device_exchange(
            shards, P, cols, fills=[0] + [0.0] * len(agg.input_leaves))
        outs = {}
        for dev in ("cpu", "cuda"):
            step = build_exchange_scatter(make_mesh(P, dev), agg)
            leaf = agg.leaves[0]
            accs = (torch.full((P, cap), np.asarray(leaf.identity).item(),
                               dtype=torch_dtype(leaf.dtype), device=dev),)
            t = [torch.from_numpy(c).to(dev) for c in (dst, *staged)]
            accs = step(accs, t[0], t[1], tuple(t[2:]), width)
            outs[dev] = accs[0].cpu()
        cpu, gpu = outs["cpu"], outs["cuda"]
        if name == "count":
            if not torch.equal(cpu, gpu):
                raise AssertionError("exchange+scatter Count: card != CPU")
            report[name] = {"exact": True}
        else:
            # CUDA index_add_ folds with atomics, in no fixed order: each
            # slot's sum may differ from the CPU's stream-order fold by
            # the reordering bound m * 2^-23 * sum|v| (m = its records)
            abs_sum = torch.zeros(P * cap).index_add_(
                0, _targets(torch, dst, staged[0], P, cap),
                torch.from_numpy(np.abs(staged[1]))).view(P, cap)
            m = torch.zeros(P * cap).index_add_(
                0, _targets(torch, dst, staged[0], P, cap),
                torch.ones(len(dst))).view(P, cap)
            bound = m * 2.0 ** -23 * abs_sum
            diff = (cpu - gpu).abs()
            if bool((diff > bound).any()):
                raise AssertionError("exchange+scatter Sum beyond the "
                                     "atomics-reordering bound")
            report[name] = {"exact": bool(torch.equal(cpu, gpu)),
                            "max_abs_err": float(diff.max()),
                            "slots_differing": int((diff > 0).sum())}
    print("phase 4: exchange+scatter card vs CPU (n=1<<20, P=8, cap=1<<15):"
          f" {json.dumps(report)}")
    return report


def _targets(torch, dst, slots, P, cap):
    """Flat plane index each staged record lands on (its destination
    shard's row), padded lanes to slot 0 of shard 0."""
    d = np.where(dst < P, dst, 0).astype(np.int64)
    return torch.from_numpy(d * cap + slots.astype(np.int64))


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


def phase_q5(torch, records: int, device: str = "cuda"):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.stateplane.rank import rank

    auctions, rate, size, slide, top_k = 100_000, 100_000, 10_000, 2_000, 16
    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8,
        "execution.micro-batch.size": 1 << 20,
        "execution.device": device,
    }))
    sink = CollectSink()
    build_q5(env, BidSource(total_records=records, num_auctions=auctions,
                            events_per_second_of_eventtime=rate),
             size_ms=size, slide_ms=slide,
             device_top_k=top_k).sink_to(sink)
    rank.launches = 0
    t0 = time.perf_counter()
    result = env.execute("nexmark-q5")
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = rank.launches
    batches = -(-records // (1 << 20))
    if launches <= 0:
        raise AssertionError("Q5 ran without launching the rank kernel")
    got = {}
    for r in sink.rows():
        got.setdefault(r["window_end"], (r["count"], set()))[1].add(
            int(r["auction"]))
    t1 = time.perf_counter()
    want = q5_oracle(BidSource, records, auctions, rate, size, slide)
    oracle_s = time.perf_counter() - t1
    if set(got) != set(want):
        raise AssertionError(f"Q5 fired {len(got)} windows, oracle "
                             f"{len(want)}")
    for w, (best, winners) in want.items():
        g_best, g_winners = got[w]
        if g_best != best or not g_winners <= winners or \
                len(g_winners) != min(len(winners), top_k):
            raise AssertionError(f"Q5 window {w}: got ({g_best}, "
                                 f"{sorted(g_winners)[:5]}...), oracle "
                                 f"({best}, {sorted(winners)[:5]}...)")
    lat = result.metrics.get("window_fire_latency_ms", {})
    q5 = {"records": records, "elapsed_s": elapsed,
          "events_per_s": records / elapsed, "windows": len(got),
          "batches": batches, "rank_launches": launches,
          "fire_latency_ms": lat, "oracle_s": oracle_s}
    print(f"phase 5: Q5 P=8 {records} records in {elapsed:.3f} s = "
          f"{records / elapsed:.0f} events/s; {len(got)} windows match the "
          f"oracle; rank launches {launches} over {batches} batches; "
          f"fire latency p50 {lat.get('p50')} ms p99 {lat.get('p99')} ms")
    print("Q5 " + json.dumps(q5))
    return q5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=40_000_000,
                    help="Q5 records (40M: the size of bench.py's run)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from flink_tpu_torch.stateplane.rank import (
            build_rank_kernel,
            rank,
            rank_plain,
        )
    except ImportError as e:
        print(f"chip_smoke: the flink_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _, log = build_rank_kernel()
    print(f"phase 1: built rank kernel in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    phase_rank_parity(torch, rank, rank_plain)
    timing = phase_rank_timing(torch, rank, rank_plain)
    phase_exchange_scatter(torch)
    q5 = phase_q5(torch, args.records)

    kernels = [{
        "name": "exchange_rank",
        "route": "cuda",
        "source": "flink_tpu_torch/csrc/rank.cu",
        "replaces": "flink_tpu/stateplane/rank.py:75",
        "launches": q5["rank_launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
