"""Where Q5's time goes on the port: a breakdown of one Nexmark Q5 run on
the card.

    python3 -m flink_tpu_torch.benchmarks.q5_profile [--records N]
        [--parallelism 8|1] [--layout slots|panes]
        [--max-device-slots N]

Runs the job chip_smoke.py runs (100k auctions, 100k events/s of event
time, 10 s / 2 s HOP, top-k 16, micro-batches of 1<<20) twice: once plain
for the wall time, once under ``torch.profiler`` with host wall-clock
accumulators wrapped around the engine's stages. At parallelism 8 (the
mesh engine): source, slot lookup, staging, exchange+scatter dispatch,
fence waits, fires, frees; with ``--max-device-slots`` (a per-shard
budget, ``state.slot-table.max-device-slots``) also the namespace-group
splits' planning, reloads, evictions and hybrid fires. At parallelism 1 (the single-device slot
table, with bench.py's settings: capacity 1<<22, the slot layout,
dispatch-ahead 8): source, slot lookup, the scatter's padding and
dispatch, H2D copies, fence waits, the fire's slot matrix, the fire
dispatch and harvest, frees. With ``--layout panes`` (parallelism 1, the
pane layout with pre-aggregation, the other layout bench.py measures):
source, the fused native ingest, the window-partial lanes
(``window_flat``), the combined scatter, the partial rebuilds
(``rebuild_window_partials``), H2D copies, fence waits, the fire dispatch
and harvest, frees. Prints one JSON line: wall time, events/s
and fire latency of the plain run, host seconds per stage and device
kernel time by kernel of the profiled run, and the device's busy and idle
share of that run's wall time.
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


#: bench.py's settings of the parallelism-1 run (on an accelerator)
P1_SETTINGS = {
    "state.slot-table.capacity": 1 << 22,
    "state.window-layout": "slots",
    "execution.pipeline.max-dispatch-batches": 8,
}


def run_q5(records: int, parallelism: int = 8, layout: str = "slots",
           max_device_slots: int = 0):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": parallelism,
        "execution.micro-batch.size": 1 << 20,
        "execution.device": "cuda",
        **(P1_SETTINGS if parallelism == 1 else {}),
        **({"state.window-layout": layout} if parallelism == 1 else {}),
        **({"state.slot-table.max-device-slots": max_device_slots}
           if max_device_slots else {}),
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


def _mesh_patches(acc):
    """(object, attribute, stage) wrapped at parallelism 8, and the undo."""
    from flink_tpu_torch.benchmarks import nexmark
    from flink_tpu_torch.parallel import sharded_windower as sw
    from flink_tpu_torch.state import slot_table

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
        (E, "_ns_group_plan", "ingest.ns_group_plan (budget)"),
        (E, "_ensure_resident", "ingest.reloads (budget)"),
        (E, "_evict_cold", "evictions (gather, D2H, spill; budget)"),
        (E, "_fire_window_hybrid", "fire.hybrid (budget)"),
    ]
    orig_init = E.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        self._exchange_scatter_step = _timed(
            acc, "ingest.exchange_scatter_dispatch",
            self._exchange_scatter_step)

    E.__init__ = init
    return patches, lambda: setattr(E, "__init__", orig_init)


def _single_device_patches(acc):
    """(object, attribute, stage) wrapped at parallelism 1, and the
    undo."""
    from flink_tpu_torch.benchmarks import nexmark
    from flink_tpu_torch.runtime import pending
    from flink_tpu_torch.state import slot_table
    from flink_tpu_torch.windowing import windower

    W, T = windower.SliceSharedWindower, slot_table.SlotTable
    return [
        (nexmark.BidSource, "poll_batch", "source.poll"),
        (W, "process_batch", "engine.process_batch (all ingest)"),
        (slot_table.NativeSlotIndex, "lookup_or_insert",
         "ingest.slot_lookup"),
        (T, "scatter", "ingest.scatter (pad + dispatch)"),
        (T, "_to_device", "h2d copies (ingest + fire + free)"),
        (pending.Fence, "block_until_ready",
         "fence waits (dispatch bound + fire harvest)"),
        (W, "on_watermark", "engine.on_watermark (fires + frees)"),
        (T, "build_slice_matrix", "fire.slice_matrix (host grouping)"),
        (T, "fire_projected_async", "fire.dispatch"),
        (pending.PendingFire, "harvest", "fire.harvest"),
        (T, "free_namespaces", "fire.free_slices"),
    ], lambda: None


def _pane_patches(acc):
    """(object, attribute, stage) wrapped at parallelism 1 in the pane
    layout, and the undo."""
    from flink_tpu_torch.benchmarks import nexmark
    from flink_tpu_torch.runtime import pending
    from flink_tpu_torch.state import pane_table, slot_table
    from flink_tpu_torch.windowing import windower

    W, T = windower.PaneWindower, pane_table.PaneTable
    return [
        (nexmark.BidSource, "poll_batch", "source.poll"),
        (W, "process_batch", "engine.process_batch (all ingest)"),
        (slot_table.NativeSlotIndex, "pane_ingest",
         "ingest.fused_native_ingest"),
        (T, "window_flat", "ingest.window_flat (partial lanes, host)"),
        (T, "scatter_combined", "ingest.scatter_combined (concat + dispatch)"),
        (T, "rebuild_window_partials", "ingest.rebuild_window_partials"),
        (T, "_to_device", "h2d copies (ingest + fire + free)"),
        (pending.Fence, "block_until_ready",
         "fence waits (dispatch bound + fire harvest)"),
        (W, "on_watermark", "engine.on_watermark (fires + frees)"),
        (T, "fire_partial_async", "fire.dispatch (delta)"),
        (T, "fire_window_async", "fire.dispatch (full window)"),
        (pending.PendingFire, "harvest", "fire.harvest"),
        (T, "free_slices", "fire.free_slices"),
    ], lambda: None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=40_000_000)
    ap.add_argument("--parallelism", type=int, default=8,
                    help="8: the mesh engine; 1: the single-device engine")
    ap.add_argument("--layout", choices=("slots", "panes"), default="slots",
                    help="state.window-layout at parallelism 1")
    ap.add_argument("--max-device-slots", type=int, default=0,
                    help="state.slot-table.max-device-slots (per shard at "
                    "parallelism 8); 0: no budget")
    args = ap.parse_args()
    import torch

    layout = args.layout if args.parallelism == 1 else None
    budget = args.max_device_slots
    wall, result = run_q5(args.records, args.parallelism, layout, budget)
    plain = {"wall_s": wall, "events_per_s": args.records / wall,
             "fire_latency_ms": result.metrics.get("window_fire_latency_ms")}

    acc = defaultdict(float)
    patches, undo = (_mesh_patches if layout is None
                     else _pane_patches if layout == "panes"
                     else _single_device_patches)(acc)
    try:
        (pwall, _), host_s, prof = profile_patched(
            patches, lambda: run_q5(args.records, args.parallelism, layout,
                                    budget),
            acc)
    finally:
        undo()

    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "records": args.records,
        "parallelism": args.parallelism,
        "layout": layout,
        "max_device_slots": budget,
        "plain_run": plain,
        "profiled_wall_s": pwall,
        "host_s": host_s,
        **device_summary(prof, pwall),
    }))


def device_summary(prof, wall_s: float) -> dict:
    """The device's busy and idle share of ``wall_s`` and its largest
    items, from a torch.profiler trace: device activity only (kernels and
    copies as the device ran them; the host-side aten:: ops that launched
    them carry the same time; a ``record_function`` range mirrored onto
    the device timeline is a span over its kernels, not work, and is
    left out)."""
    import torch

    kernels = defaultdict(lambda: {"device_ms": 0.0, "calls": 0})
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        us = ev.time_range.elapsed_us()
        k = kernels[ev.name[:120]]
        k["device_ms"] += us / 1e3
        k["calls"] += 1
        busy_us += us
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])
               [:12])
    return {"device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "device_idle_share": 1 - busy_us / 1e6 / wall_s,
            "top_device_ops": top}


def profile_patched(patches, run, acc=None):
    """``run()`` under torch.profiler with each ``(object, attribute,
    stage)`` of ``patches`` wrapped in a host wall-clock accumulator
    (``acc``, restored after). Returns ``(run's result, host s per stage,
    prof)``."""
    from torch.profiler import ProfilerActivity, profile

    acc = defaultdict(float) if acc is None else acc
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, key in patches:
        setattr(obj, name, _timed(acc, key, getattr(obj, name)))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return out, dict(sorted(acc.items())), prof


if __name__ == "__main__":
    main()
