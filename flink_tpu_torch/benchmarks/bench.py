"""The port's headline benchmark: Nexmark Q5 — hot items over a sliding
window — as the repository's ``bench.py`` runs it, through
``flink_tpu_torch`` on the card.

    python3 -m flink_tpu_torch.benchmarks.bench

keyBy(auction) -> HOP(10 s size, 2 s slide) -> COUNT -> per-window
arg-max (top-k 16 on the device) at parallelism 1, with ``bench.py``'s
accelerator settings: micro-batches of 1<<20, ``state.slot-table.capacity``
1<<22, dispatch-ahead 8. For each of the two layouts (``panes``,
``slots``): a warm-up pass of 1<<21 records (``BENCH_RECORDS`` if that is
fewer), then ``BENCH_REPS`` reps of ``BENCH_RECORDS`` records, the median
rep kept; the better layout is reported.

Prints ONE JSON line with ``bench.py``'s fields — ``metric``, ``value``,
``unit``, ``vs_baseline`` (against the same 500,000 events/s proxy),
``rep_events_per_s``, ``best_events_per_s`` — plus the chosen ``layout``,
its ``fire_latency_ms`` and the ``device`` it ran on. Diagnostics go to
stderr. Environment: ``BENCH_RECORDS`` (40M), ``BENCH_REPS`` (3) and
``BENCH_DEVICE`` (``cuda``: a host without a card raises; ``cpu`` runs the
plain versions on the host).
"""

from __future__ import annotations

import json
import os
import sys
import time

#: bench.py's proxy for Flink's RocksDB-backed windowed aggregation
PROXY_BASELINE_EVENTS_PER_S = 500_000.0
LAYOUTS = ("panes", "slots")


def run(total_records: int, layout: str, device: str,
        num_auctions: int = 100_000) -> dict:
    """One pass of Q5 over ``total_records`` bids in ``layout``."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": 1 << 20,
        "state.slot-table.capacity": 1 << 22,
        "state.window-layout": layout,
        "execution.pipeline.max-dispatch-batches": 8,
        "execution.device": device,
    }))
    sink = CollectSink()
    src = BidSource(total_records=total_records, num_auctions=num_auctions,
                    events_per_second_of_eventtime=100_000)
    build_q5(env, src, size_ms=10_000, slide_ms=2_000,
             device_top_k=16).sink_to(sink)
    t0 = time.perf_counter()
    result = env.execute("nexmark-q5-hot-items")
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return {"events_per_s": total_records / elapsed, "elapsed_s": elapsed,
            "results": len(sink.result()),
            "fire_latency_ms": result.metrics.get("window_fire_latency_ms")}


def measure(total: int, reps: int, warmup: int, device: str) -> dict:
    """Both layouts, warm-up then ``reps`` reps each; the median rep of the
    better layout, with every rep's rate and the best."""
    best = None
    for layout in LAYOUTS:
        run(warmup, layout, device)
        results = []
        for rep in range(max(reps, 1)):
            r = run(total, layout, device)
            print(f"# layout={layout} rep {rep}: {r['events_per_s']:.0f} "
                  f"events/s, fire_latency={r['fire_latency_ms']}",
                  file=sys.stderr)
            results.append(r)
        by_rate = sorted(results, key=lambda r: r["events_per_s"])
        s = dict(by_rate[len(by_rate) // 2])   # median (upper-mid if even)
        s["layout"] = layout
        s["rep_events_per_s"] = [round(r["events_per_s"], 1)
                                 for r in results]
        s["best_events_per_s"] = round(by_rate[-1]["events_per_s"], 1)
        if best is None or s["events_per_s"] > best["events_per_s"]:
            best = s
    return best


def line(stats: dict, device: str) -> dict:
    value = stats["events_per_s"]
    if device.startswith("cuda"):
        import torch

        device = torch.cuda.get_device_name(0)
    return {
        "metric": "nexmark_q5_hop_hot_items_events_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "events/s",
        "vs_baseline": round(value / PROXY_BASELINE_EVENTS_PER_S, 3),
        "rep_events_per_s": stats["rep_events_per_s"],
        "best_events_per_s": stats["best_events_per_s"],
        "layout": stats["layout"],
        "fire_latency_ms": stats["fire_latency_ms"],
        "device": device,
    }


def main() -> None:
    device = os.environ.get("BENCH_DEVICE", "cuda")
    total = int(os.environ.get("BENCH_RECORDS", 40_000_000))
    stats = measure(total, int(os.environ.get("BENCH_REPS", 3)),
                    min(1 << 21, total), device)
    print(f"# q5 best layout={stats['layout']}: {stats['results']} winner "
          f"rows, fire_latency={stats['fire_latency_ms']}", file=sys.stderr)
    print(json.dumps(line(stats, device)))


if __name__ == "__main__":
    main()
