"""BASELINE row 5 on the port, and where its time goes on the card.

    python3 -m flink_tpu_torch.benchmarks.session_profile [--records N]

Row 5 is "Session-window clickstream, 10M distinct keys"
(``BASELINE.json`` ``configs[4]``) as ``tools/bench_suite.py:198-245`` runs
it: ``DataGenSource`` (10M keys, 400k events/s of event time, seed 3),
``EventTimeSessionWindows.with_gap(2_000)``, ``.sum("value")`` in float32,
micro-batches of 1<<16, ``state.slot-table.capacity`` and
``max-device-slots`` both 1<<19 — about 800k live sessions against 524,288
device rows, so the paged spill tier evicts and reloads all the time.

The profile runs the job (12M records by default) twice at parallelism 1:
once plain for the wall time, once under ``torch.profiler`` with host
wall-clock accumulators around the session engine's stages (nested
stages are inside their parents): the source, the native absorb, merge
groups, the state lookups with the eviction and reload inside them, the
records' fold, H2D copies, fence waits, the fires (the native pop, the
fire dispatch, the frees) and the harvests. Prints one JSON line: wall
time, events/s and fire latency of the plain run, the spill counters,
host seconds per stage and the device's busy and idle share with its
largest items.
"""

from __future__ import annotations

import argparse
import json
import time

#: BASELINE row 5's configuration (tools/bench_suite.py:198-245)
ROW5_SETTINGS = {
    "execution.micro-batch.size": 1 << 16,
    "state.slot-table.capacity": 1 << 19,
    "state.slot-table.max-device-slots": 1 << 19,
}
ROW5_RECORDS, ROW5_KEYS, ROW5_RATE, ROW5_GAP, ROW5_SEED = \
    12_000_000, 10_000_000, 400_000, 2_000, 3


def row5_source(records: int = ROW5_RECORDS, keys: int = ROW5_KEYS):
    from flink_tpu_torch.connectors.sources import DataGenSource

    return DataGenSource(records, keys, ROW5_RATE, seed=ROW5_SEED)


def run_sessions(source, device: str = "cuda", settings=None,
                 agg: str = "sum", out_of_orderness: int = 0):
    """Row 5's job over ``source`` through the public API on ``device``:
    ``(sink, wall s, job result, the session windower)``. The wall time
    holds no library build."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    env = StreamExecutionEnvironment(Configuration({
        **ROW5_SETTINGS, **(settings or {}), "execution.device": device}))
    sink = CollectSink()
    stream = getattr(
        env.from_source(source, WatermarkStrategy.for_bounded_out_of_orderness(
            out_of_orderness))
        .key_by("key").window(EventTimeSessionWindows.with_gap(ROW5_GAP)),
        agg)("value")
    # keep the operator the executor opens, to read its engine afterwards
    ops = []
    make = stream.transformation.operator_factory

    def keep():
        ops.append(make())
        return ops[-1]

    stream.transformation.operator_factory = keep
    stream.sink_to(sink)
    _load_libraries(device)
    t0 = time.perf_counter()
    result = env.execute("sessions")
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return sink, time.perf_counter() - t0, result, ops[0].windower


def _load_libraries(device: str) -> None:
    """Build (if stale) and load every library the job calls, so that a
    cold checkout's g++ / nvcc builds fall outside the timed window: the
    native session plane, the native slot index and, on the card, the
    ordered fold."""
    from flink_tpu_torch.native import load_sessions, load_slotmap

    load_sessions()
    load_slotmap()
    if device.startswith("cuda"):
        from flink_tpu_torch.stateplane.fold import build_fold_kernel

        build_fold_kernel()


def _session_patches():
    """(object, attribute, stage) wrapped in the profiled run."""
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.runtime import pending
    from flink_tpu_torch.state.slot_table import SlotTable as T
    from flink_tpu_torch.windowing.session_native import (
        NativeSessionIntervalSet as M,
    )
    from flink_tpu_torch.windowing.sessions import SessionWindower as W

    return [
        (DataGenSource, "poll_batch", "source.poll"),
        (W, "process_batch", "engine.process_batch (all ingest)"),
        (M, "absorb_batch_ex", "ingest.native_absorb"),
        (W, "_run_merge_group", "ingest.merge_groups"),
        (T, "lookup_or_insert", "state.lookup (ingest + merges + fires)"),
        (T, "_evict_cold_paged", "state.lookup > evict (gather, D2H, page)"),
        (T, "_reload_pages_for", "state.lookup > reload (pages, put)"),
        (T, "scatter", "ingest.scatter (pad + dispatch)"),
        (T, "_to_device", "h2d copies (all)"),
        (pending.Fence, "block_until_ready",
         "fence waits (dispatch bound + fire harvest)"),
        (W, "on_watermark", "engine.on_watermark (fires + frees)"),
        (M, "pop_fired_ex", "fire.native_pop"),
        (T, "fire_async", "fire.dispatch"),
        (T, "free_rows", "fire.free_rows"),
        (pending.PendingFire, "harvest", "fire.harvest"),
    ]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=ROW5_RECORDS)
    args = ap.parse_args()
    import torch

    from flink_tpu_torch.benchmarks.q5_profile import (
        device_summary,
        profile_patched,
    )

    _, wall, result, eng = run_sessions(row5_source(args.records))
    plain = {"wall_s": wall, "events_per_s": args.records / wall,
             "fire_latency_ms": result.metrics.get("window_fire_latency_ms"),
             "spill_counters": eng.spill_counters(),
             "merge_groups": eng.merge_groups}

    pwall, host_s, prof = profile_patched(
        _session_patches(), lambda: run_sessions(row5_source(args.records))[1])
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "records": args.records,
        "plain_run": plain,
        "profiled_wall_s": pwall,
        "host_s": host_s,
        **device_summary(prof, pwall),
    }))


if __name__ == "__main__":
    main()
