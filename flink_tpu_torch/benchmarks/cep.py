"""The CEP benchmark on the port: the ``cep_patterns_10m_keys`` row (the
port's form of ``tools/bench_cep.py``).

    python3 -m flink_tpu_torch.benchmarks.cep [--records N]
        [--device cuda|cpu] [--check] [--profile]

The reference's shape, unchanged (``tools/bench_cep.py:46-51``): a
2-stage within-2 s sequence (``v % 3 == 0`` then, strictly next,
``v % 3 == 1``, ``SKIP_PAST_LAST_EVENT``) over 10M distinct keys at 400k
events/s of event time, batches of ``1 << 15`` records with a watermark
500 ms behind the newest record fired after each, 4M records, P=8 and
``1 << 14`` slots a shard against ~260k live partials — the paged spill
tier churns (ingest evicts cohorts, due keys reload with the lazy
within-prune). The host backend (the per-key ``CepOperator`` NFA) runs
the same stream at ``min(records, 1 << 18)`` records, as the reference's
row does (with ``--check``, at the comparison's size); the reference's
median of three reps is one run here.

It reports events/s over the whole loop (batch generation included),
emit latency (wall ms from a watermark advance to its matches on the
host, over the fires that matched), matches, the spill counters and the
exchange-rank launches. With ``--check`` the first ``min(records,
1 << 19)`` records run through the device engine and through the same
engine class with ``backend="host"``, and every emitted batch must be
equal: each batch is reduced to a digest of its column names, dtypes and
bytes (time spent on digests is not counted). With ``--profile`` the run
repeats under torch.profiler with host timers around the engine's stages
(ingest, slot resolution, advance, decode, prune, eviction) and reports
the device's busy share and the advance's share of the fires' wall time.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import List, Optional

import numpy as np

from flink_tpu_torch.benchmarks.joins import _percentile, digest

BATCH = 1 << 15
NUM_KEYS = 10_000_000
RATE = 400_000          # events/s of event time
WITHIN_MS = 2_000
WM_LAG_MS = 500
BUDGET = 1 << 14        # slots a shard vs ~260k live partial keys
PARALLELISM = 8
RECORDS = 4_000_000
SEED = 3
HOST_RECORDS = 1 << 18
CHECK_RECORDS = 1 << 19


def pattern():
    """``tools/bench_cep.py``'s pattern."""
    from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy, Pattern

    return (Pattern.begin(
                "a", skip=AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT)
            .where(lambda b: np.asarray(b["v"]) % 3 == 0)
            .next("b")
            .where(lambda b: np.asarray(b["v"]) % 3 == 1)
            .within(WITHIN_MS))


def make_engine(device=None, backend: str = "device",
                spill_dir: Optional[str] = None):
    """The row's engine: P=8 logical shards of ``BUDGET`` slots on
    ``device`` (``backend="host"``: the host CepOperator behind the same
    interface)."""
    from flink_tpu_torch.cep.mesh_engine import MeshCepEngine

    if backend == "host":
        return MeshCepEngine(pattern(), backend="host")
    return MeshCepEngine(pattern(), num_shards=PARALLELISM, device=device,
                         capacity_per_shard=BUDGET, spill_dir=spill_dir)


def stream(total: int, seed: int = SEED):
    """The row's batches, in order: ``(keys, values, timestamps)``."""
    rng = np.random.default_rng(seed)
    events, t = 0, 0
    while events < total:
        n = min(BATCH, total - events)
        keys = rng.integers(0, NUM_KEYS, n).astype(np.int64)
        vals = rng.integers(0, 9, n).astype(np.int64)
        ts = t + (np.arange(n, dtype=np.int64) * 1000) // RATE
        yield keys, vals, ts
        events += n
        t = int(ts[-1]) + 1


def drive(engine, total: int, seed: int = SEED,
          digests: Optional[list] = None,
          matches_out: Optional[list] = None) -> dict:
    """Keyed batches at RATE events/s of event time, a trailing-watermark
    fire after every batch, then a drain in batch-sized watermark steps
    (every fire must fit its due keys inside the slot budget). With
    ``digests`` every emitted batch's digest is appended, with
    ``matches_out`` every match's ``(key, start_ts, end_ts)``, in order,
    outside the timed part."""
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )

    events = matches = 0
    lat: List[float] = []
    aside = 0.0

    def emitted(out):
        nonlocal aside
        if digests is None and matches_out is None:
            return
        d0 = time.perf_counter()
        for b in out:
            if digests is not None:
                digests.append(digest(b))
            if matches_out is not None:
                matches_out.extend(zip(b["key"].tolist(),
                                       b["start_ts"].tolist(),
                                       b["end_ts"].tolist()))
        aside += time.perf_counter() - d0

    t0 = time.perf_counter()
    t = 0
    for keys, vals, ts in stream(total, seed):
        engine.process_batch(RecordBatch({
            KEY_ID_FIELD: keys, "v": vals, TIMESTAMP_FIELD: ts}))
        events += len(keys)
        t = int(ts[-1]) + 1
        f0 = time.perf_counter()
        out = engine.on_watermark(t - WM_LAG_MS)
        m = sum(len(b) for b in out)
        if m:
            lat.append((time.perf_counter() - f0) * 1e3)
        matches += m
        emitted(out)
    wm = t - WM_LAG_MS
    step = max(BATCH * 1000 // RATE, 1)
    while wm < t:
        wm = min(wm + step, t)
        out = engine.on_watermark(wm)
        matches += sum(len(b) for b in out)
        emitted(out)
    wall = time.perf_counter() - t0 - aside
    lat.sort()
    return {"events": events, "matches": matches, "wall_s": wall,
            "events_per_s": events / wall,
            "emit_latency_ms": {"p50": _percentile(lat, 0.5),
                                "p99": _percentile(lat, 0.99),
                                "max": lat[-1] if lat else None,
                                "count": len(lat)}}


def run(records: int = RECORDS, device=None,
        matches_out: Optional[list] = None,
        host_records: int = HOST_RECORDS) -> dict:
    """One device run of the row on ``device`` (the card by default) with
    a temporary spill dir: its numbers, spill counters and exchange-rank
    launches; then the host backend's events/s over ``min(records,
    host_records)`` records (none with ``host_records=0``)."""
    from flink_tpu_torch.stateplane.rank import rank

    with tempfile.TemporaryDirectory(prefix="cep-spill-") as td:
        engine = make_engine(device, spill_dir=td)
        before = rank.launches
        r = drive(engine, records, matches_out=matches_out)
        r["rank_launches"] = rank.launches - before
        r["batches"] = -(-records // BATCH)
        r["spill"] = engine.spill_counters()
        r["device"] = str(engine.device)
    if host_records:
        h = drive(make_engine(backend="host"), min(records, host_records))
        r["host_backend"] = {"records": h["events"],
                             "events_per_s": h["events_per_s"],
                             "matches": h["matches"]}
    return r


def check(records: int = CHECK_RECORDS, device=None) -> dict:
    """The first ``min(records, CHECK_RECORDS)`` records through the
    device engine on ``device`` and through ``backend="host"``: every
    emitted batch equal (by digest), and the host backend's events/s."""
    n = min(records, CHECK_RECORDS)
    dev_d: list = []
    host_d: list = []
    with tempfile.TemporaryDirectory(prefix="cep-check-") as td:
        drive(make_engine(device, spill_dir=td), n, digests=dev_d)
    h = drive(make_engine(backend="host"), n, digests=host_d)
    diverged = next((i for i, (a, b) in enumerate(zip(dev_d, host_d))
                     if a != b), None)
    return {"records": n, "batches_compared": len(dev_d),
            "equal_to_host_backend": (len(dev_d) == len(host_d)
                                      and diverged is None and bool(dev_d)),
            "first_divergent_batch": diverged,
            "host_backend": {"records": h["events"],
                             "events_per_s": h["events_per_s"],
                             "matches": h["matches"]}}


def _patches():
    """(object, attribute, stage) wrapped in the profiled run."""
    from flink_tpu_torch.cep import kernels
    from flink_tpu_torch.cep import mesh_engine as me

    E = me.MeshCepEngine
    return [
        (E, "_ingest_device", "ingest (all)"),
        (E, "_compact_pending", "ingest > pending compaction"),
        (me, "stage_device_exchange", "ingest > staging"),
        (kernels, "cep_exchange_put", "ingest > exchange-put dispatch"),
        (E, "on_watermark", "fire (all)"),
        (E, "_resolve_slots", "fire > slot resolution (all)"),
        (E, "_evict_cohorts", "fire > slot resolution > eviction"),
        (me, "reload_rows_for", "fire > slot resolution > page reloads"),
        (me, "harvest_to_host", "harvests (advance, evict; one D2H each)"),
        (E, "_decode_lane", "fire > decode"),
        (E, "_put_matches", "fire > match store put"),
        (E, "_prune_resident", "fire > prune"),
        (E, "_to_device", "h2d copies (all)"),
    ]


def range_device(prof, name: str) -> dict:
    """Device time and kernel count of the kernels launched inside the
    ``record_function(name)`` ranges of a torch.profiler trace (None
    where the trace attributes none to them)."""
    import torch

    def kernels_below(ev) -> int:
        return len(getattr(ev, "kernels", ()) or ()) + sum(
            kernels_below(c) for c in ev.cpu_children)

    ranges = [ev for ev in prof.events() if ev.name == name
              and ev.device_type == torch.autograd.DeviceType.CPU]
    us = sum(ev.device_time_total for ev in ranges)
    n = sum(kernels_below(ev) for ev in ranges)
    return {"ranges": len(ranges),
            "device_ms": us / 1e3 if us else None,
            "kernels": n or None}


def profile(records: int = RECORDS, device=None) -> dict:
    """The row on ``device`` (the card by default) under torch.profiler
    with host timers around the engine's stages: host seconds per stage,
    the device's busy and
    idle share of the run, and the advance: its calls, its wall ms per
    call (synchronised, so its device work included), its device ms and
    kernels over the run and its share of the fires' wall time."""
    import torch

    from flink_tpu_torch.benchmarks.q5_profile import (
        device_summary,
        profile_patched,
    )
    from flink_tpu_torch.cep import kernels

    adv_ms: List[float] = []
    plain = kernels.cep_advance

    def advance(*a, **kw):
        t0 = time.perf_counter()
        with torch.profiler.record_function("cep_advance"):
            out = plain(*a, **kw)
        if out[0].is_cuda:
            torch.cuda.synchronize()
        adv_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    kernels.cep_advance = advance
    try:
        with tempfile.TemporaryDirectory(prefix="cep-prof-") as td:
            engine = make_engine(device, spill_dir=td)
            out, host_s, prof = profile_patched(
                _patches(), lambda: drive(engine, records))
    finally:
        kernels.cep_advance = plain
    fire_s = host_s.get("fire (all)", 0.0)
    calls = len(adv_ms)
    srt = sorted(adv_ms)
    dev = range_device(prof, "cep_advance")
    return {"profiled_wall_s": out["wall_s"],
            "profiled_events_per_s": out["events_per_s"],
            "host_s": host_s,
            "advance": {
                "calls": calls,
                "wall_ms_p50": _percentile(srt, 0.5),
                "wall_ms_p99": _percentile(srt, 0.99),
                "wall_s": sum(adv_ms) / 1e3,
                "device_ms": dev["device_ms"],
                "kernels_per_call": (dev["kernels"] / calls
                                     if dev["kernels"] and calls else None),
                "share_of_fire_wall": (sum(adv_ms) / 1e3 / fire_s
                                       if fire_s else None)},
            **device_summary(prof, out["wall_s"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=RECORDS)
    ap.add_argument("--device", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    from flink_tpu_torch.benchmarks.joins import load_kernels

    load_kernels(args.device)
    out = run(args.records, args.device,
              host_records=0 if args.check else HOST_RECORDS)
    if args.check:
        out["check"] = check(args.records, args.device)
    if args.profile:
        out["profile"] = profile(args.records, args.device)
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
