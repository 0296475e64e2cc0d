"""Where Q5's time goes on the port: a breakdown of one Nexmark Q5 run at
parallelism 8 on the card.

    python3 -m flink_tpu_torch.benchmarks.q5_profile [--records N]

Runs the job chip_smoke.py runs (100k auctions, 100k events/s of event
time, 10 s / 2 s HOP, top-k 16, micro-batches of 1<<20) twice: once plain
for the wall time, once under ``torch.profiler`` with host wall-clock
accumulators wrapped around the engine's stages (source, slot lookup,
staging, exchange+scatter dispatch, fence waits, fires, frees). Prints one
JSON line: wall time and events/s of the plain run, host seconds per stage
and device kernel time by kernel of the profiled run, and the device's busy
and idle share of that run's wall time.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from collections import defaultdict


def _timed(acc, key, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[key] += time.perf_counter() - t0
    return wrapper


def run_q5(records: int):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8,
        "execution.micro-batch.size": 1 << 20,
        "execution.device": "cuda",
    }))
    sink = CollectSink()
    build_q5(env, BidSource(total_records=records, num_auctions=100_000,
                            events_per_second_of_eventtime=100_000),
             size_ms=10_000, slide_ms=2_000, device_top_k=16).sink_to(sink)
    t0 = time.perf_counter()
    result = env.execute("nexmark-q5")
    import torch

    torch.cuda.synchronize()
    return time.perf_counter() - t0, result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=40_000_000)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.benchmarks import nexmark
    from flink_tpu_torch.parallel import sharded_windower as sw
    from flink_tpu_torch.state import slot_table

    wall, result = run_q5(args.records)
    plain = {"wall_s": wall, "events_per_s": args.records / wall,
             "fire_latency_ms": result.metrics.get("window_fire_latency_ms")}

    acc = defaultdict(float)
    E = sw.MeshWindowEngine
    patches = [
        (nexmark.BidSource, "poll_batch", "source.poll"),
        (E, "process_batch", "engine.process_batch (all ingest)"),
        (slot_table.NativeSlotIndex, "lookup_or_insert",
         "ingest.slot_lookup"),
        (sw, "stage_device_exchange", "ingest.stage"),
        (E, "_to_device", "h2d copies (ingest + fire + free)"),
        (E, "_await_dispatch_slot", "ingest.fence_wait"),
        (E, "on_watermark", "engine.on_watermark (fires + frees)"),
        (E, "_free_slices", "fire.free_slices"),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, key in patches:
        setattr(obj, name, _timed(acc, key, getattr(obj, name)))
    orig_init = E.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        self._exchange_scatter_step = _timed(
            acc, "ingest.exchange_scatter_dispatch",
            self._exchange_scatter_step)

    E.__init__ = init
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pwall, _ = run_q5(args.records)
    finally:
        E.__init__ = orig_init
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    # device activity only (kernels and copies as the device ran them):
    # the host-side aten:: ops that launched them carry the same time
    kernels = defaultdict(lambda: {"device_ms": 0.0, "calls": 0})
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        k = kernels[ev.name[:120]]
        k["device_ms"] += us / 1e3
        k["calls"] += 1
        busy_us += us
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])
               [:12])
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "records": args.records,
        "plain_run": plain,
        "profiled_wall_s": pwall,
        "host_s": dict(sorted(acc.items())),
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / pwall,
        "device_idle_share": 1 - busy_us / 1e6 / pwall,
        "top_device_ops": top,
    }))


if __name__ == "__main__":
    main()
