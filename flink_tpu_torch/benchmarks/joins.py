"""Streaming-join benchmarks on the port (the port's form of
``tools/bench_joins.py``).

    python3 -m flink_tpu_torch.benchmarks.joins [--shape q8|10m|both]
        [--records N] [--device cuda|cpu] [--check] [--profile]

Two shapes, the reference's own (``tools/bench_joins.py:128-220``):

- ``q8``: the person/auction interval join of Nexmark Q8's shape — 100k
  sellers, band ``[0, 10 s]``, 200k events/s of event time per side, 4M
  records, ``1 << 18`` slots per shard per side, P=8.
- ``10m``: the thrashing shape — 10M distinct keys, band ``±2 s``, 400k
  events/s of event time, 4M records, a device budget of ``1 << 16``
  slots per shard per side against ~1.6M live rows: ingest evicts page
  cohorts and band probes serve cold candidates from the page tier.

``run_shape("q8")`` and ``run_shape("10m")`` are the reference's
``bench_q8`` and ``bench_interval_10m``, one run each where the
reference warms up and reports the median of three.
``drive`` alternates left/right batches of ``1 << 15`` records and moves
the watermark to trail the band after each pair, as the reference's
``_drive`` does.
It reports events/s over the whole loop (batch generation included),
emit latency (wall ms from a batch's arrival to its matches on the host,
over the batches that matched), matches, the spill counters and the
exchange-rank launches. With ``--check`` it replays the same stream
through the same engine with ``backend="host"`` (the bit-identical oracle)
and requires every emitted batch to be equal: each batch is reduced to a
digest of its column names, dtypes and bytes (time spent on digests is not
counted in events/s). With ``--profile`` the Q8 run repeats under
torch.profiler with host timers around the engine's stages and reports
the device's idle share.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Dict, List, Optional

import numpy as np

BATCH = 1 << 15
PARALLELISM = 8
RECORDS = 4_000_000

#: keys, the band [lower, upper] ms, events/s of event time per side,
#: slots and device budget (0: none) per shard per side, the watermark's
#: lag behind the newest record (ms), the stream's seed —
#: tools/bench_joins.py:128-167 and :170-220
SHAPES = {
    "q8": dict(num_keys=100_000, lower=0, upper=10_000, rate=200_000,
               capacity=1 << 18, budget=0, band_ms=10_000, seed=1),
    "10m": dict(num_keys=10_000_000, lower=-2_000, upper=2_000,
                rate=400_000, capacity=1 << 16, budget=1 << 16,
                band_ms=2_000, seed=2),
}


def make_engine(shape: str, device=None, backend: str = "device"):
    """The shape's interval engine on an 8-shard logical mesh of
    ``device`` (``backend="host"``: the numpy oracle with 8 shards)."""
    from flink_tpu_torch.joins import MeshIntervalJoinEngine

    s = SHAPES[shape]
    kw = dict(capacity_per_shard=s["capacity"],
              max_device_slots=s["budget"])
    if backend == "host":
        return MeshIntervalJoinEngine(s["lower"], s["upper"],
                                      backend="host",
                                      num_shards=PARALLELISM, **kw)
    return MeshIntervalJoinEngine(s["lower"], s["upper"],
                                  num_shards=PARALLELISM, device=device,
                                  **kw)


def digest(batch) -> str:
    """Column names, dtypes and bytes of one emitted batch."""
    h = hashlib.blake2b(digest_size=16)
    for n in sorted(batch.names()):
        a = np.ascontiguousarray(batch[n])
        h.update(f"{n}:{a.dtype.str}:{len(a)};".encode())
        h.update(a.view(np.uint8).data)
    return h.hexdigest()


def _percentile(sorted_ms: List[float], q: float) -> Optional[float]:
    if not sorted_ms:
        return None
    return sorted_ms[min(len(sorted_ms) - 1, int(q * len(sorted_ms)))]


def drive(engine, total: int, num_keys: int, rate: int, band_ms: int,
          seed: int, digests: Optional[list] = None) -> dict:
    """Alternate left/right batches at ``rate`` events/s of event time;
    the watermark trails by the band so pruning is live. With
    ``digests`` (a list) every emitted batch's digest is appended, in
    order, outside the timed part."""
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )

    rng = np.random.default_rng(seed)
    events = matches = 0
    lat: List[float] = []
    digest_s = 0.0
    t0 = time.perf_counter()
    t = 0
    while events < total:
        for side, name in ((0, "price"), (1, "rate")):
            n = min(BATCH, max(total - events, 1))
            keys = rng.integers(0, num_keys, n).astype(np.int64)
            ts = t + (np.arange(n, dtype=np.int64) * 1000) // rate
            b0 = time.perf_counter()
            out = engine.process_batch(RecordBatch({
                KEY_ID_FIELD: keys,
                name: rng.random(n).astype(np.float32),
                TIMESTAMP_FIELD: ts,
            }), side)
            m = sum(len(x) for x in out)
            if m:
                lat.append((time.perf_counter() - b0) * 1e3)
            matches += m
            events += n
            if digests is not None:
                d0 = time.perf_counter()
                digests.extend(digest(x) for x in out)
                digest_s += time.perf_counter() - d0
        t = int(ts[-1]) + 1
        engine.on_watermark(t - band_ms)
    wall = time.perf_counter() - t0 - digest_s
    lat.sort()
    return {"events": events, "matches": matches, "wall_s": wall,
            "events_per_s": events / wall,
            "emit_latency_ms": {"p50": _percentile(lat, 0.5),
                                "p99": _percentile(lat, 0.99),
                                "max": lat[-1] if lat else None,
                                "count": len(lat)}}


def run_shape(shape: str, records: int = RECORDS, device=None,
              check: bool = False) -> dict:
    """One run of ``shape`` on ``device`` (the card by default): its
    numbers, spill counters and exchange-rank launches; with ``check``
    the host-backend replay and the digest comparison."""
    from flink_tpu_torch.stateplane.rank import rank

    s = SHAPES[shape]
    engine = make_engine(shape, device)
    digests: Optional[list] = [] if check else None
    before = rank.launches
    r = drive(engine, records, s["num_keys"], s["rate"], s["band_ms"],
              s["seed"], digests)
    r["rank_launches"] = rank.launches - before
    r["spill"] = engine.spill_counters()
    r["shape"] = shape
    r["device"] = str(engine.device)
    if check:
        host_digests: list = []
        host = make_engine(shape, backend="host")
        h = drive(host, records, s["num_keys"], s["rate"], s["band_ms"],
                  s["seed"], host_digests)
        diverged = next((i for i, (a, b) in enumerate(
            zip(digests, host_digests)) if a != b), None)
        r["host_backend"] = {"events_per_s": h["events_per_s"],
                             "matches": h["matches"],
                             "spill": host.spill_counters()}
        r["batches_compared"] = len(digests)
        r["equal_to_host_backend"] = (
            len(digests) == len(host_digests) and diverged is None
            and r["spill"] == r["host_backend"]["spill"])
        r["first_divergent_batch"] = diverged
    return r


def _patches():
    """(object, attribute, stage) wrapped in the profiled run."""
    from flink_tpu_torch.joins import engine as je
    from flink_tpu_torch.joins import side_table as st

    E = je.JoinEngineBase
    return [
        (je.MeshIntervalJoinEngine, "process_batch",
         "engine.process_batch (all)"),
        (E, "_probe_banded", "probe (band search, dispatch, cold, cols)"),
        (je, "pair_lower_bound", "probe > band search (host)"),
        (E, "_dispatch_probe", "probe > dispatch + harvest"),
        (je, "harvest_to_host", "harvests (probe, evict; one D2H each)"),
        (st.JoinSideTable, "fill_cold", "probe > cold rows from pages"),
        (E, "_assemble", "assembly"),
        (E, "_ingest", "ingest (all)"),
        (st._ShardMeta, "merge_rows", "ingest > metadata merge (insert)"),
        (E, "_make_headroom", "ingest > eviction (gather, D2H, page)"),
        (E, "_device_put_rows", "ingest > staging + exchange-put"),
        (je, "stage_device_exchange", "ingest > staging"),
        (E, "_to_device", "h2d copies (all)"),
        (je.MeshIntervalJoinEngine, "on_watermark", "prune (watermarks)"),
    ]


def profile_shape(shape: str, records: int = RECORDS) -> dict:
    """``shape`` on the card under torch.profiler with host timers around
    the engine's stages: host seconds per stage and the device's busy
    and idle share of the run."""
    from flink_tpu_torch.benchmarks.q5_profile import (
        device_summary,
        profile_patched,
    )

    s = SHAPES[shape]
    engine = make_engine(shape)
    run, host_s, prof = profile_patched(
        _patches(), lambda: drive(engine, records, s["num_keys"],
                                  s["rate"], s["band_ms"], s["seed"]))
    return {"shape": shape, "profiled_wall_s": run["wall_s"],
            "profiled_events_per_s": run["events_per_s"],
            "host_s": host_s, **device_summary(prof, run["wall_s"])}


def load_kernels(device) -> None:
    """Build (if stale) and load the rank kernel before a timed run."""
    import torch

    if torch.device(device or "cuda").type == "cuda":
        from flink_tpu_torch.stateplane.rank import build_rank_kernel

        build_rank_kernel()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=("q8", "10m", "both"),
                    default="both")
    ap.add_argument("--records", type=int, default=RECORDS)
    ap.add_argument("--device", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    load_kernels(args.device)
    shapes = ("q8", "10m") if args.shape == "both" else (args.shape,)
    for shape in shapes:
        out: Dict[str, object] = run_shape(shape, args.records,
                                           args.device, args.check)
        if args.profile and shape == "q8":
            out["profile"] = profile_shape(shape, args.records)
        print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
