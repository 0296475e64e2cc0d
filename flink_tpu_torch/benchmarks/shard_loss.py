"""Shard loss and recovery: BASELINE row 7 on the port, and the same
protocol on Nexmark Q5-revenue.

    python3 -m flink_tpu_torch.benchmarks.shard_loss [--shape row7|q5rev]
        [--keys N] [--device cuda|cpu]

- ``row7`` is ``tools/bench_suite.py:332-370`` ``row7_shard_loss_recovery``:
  ``tools/chaos_smoke.py:70-154`` ``shard_loss_scenario`` at the suite's
  size (``tools/bench_suite.py:345-353``) — 1,000,000 keys, 8 steps of
  125,000 records (keys uniform from ``default_rng(17)``, float32 values,
  timestamps ``s*80 .. s*80+60``, watermark ``(s-1)*80``), the session
  engine (gap 100) at P=4 with 1<<14 rows a shard of capacity and budget
  (the paged tier evicts), dispatch-ahead 2; ``device.lost`` at the 15th
  probe of shard 1, seed 7, a checkpoint every 2 steps; the oracle
  ``SessionWindower``.
- ``q5rev`` is the same protocol on the window engine: ``bench.py``'s bids
  (100k auctions, 100k events/s), 10M of them in steps of 1<<20 (keyed by
  auction, the float32 price summed over HOP 10 s / 2 s, each step's
  watermark its newest bid - 1) on ``MeshWindowEngine`` at P=8; shard 3 is
  lost at its 12th probe (step 5's watermark, after the second
  checkpoint); the oracle ``SliceSharedWindower``.

Both run ``chaos.harness.run_shard_loss_verify`` and hold the committed
output to the oracle; the gates are ``chaos_smoke``'s: no divergence, one
shard lost, one unit restored, ``0 < records_replayed <= events/shards``,
and for row 7 rows evicted. Prints one JSON line with
``shard_loss_recovery_ms``, its parts (evacuation, rebuild, landing the
survivors, unit read, unit restore, replay), the survivors' rows moved,
events/s of the whole chaotic run, and the kernels' launches before and
after the loss. The device defaults to the card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

GAP = 100
SEED = 7
#: tools/bench_suite.py:345-353 and tools/chaos_smoke.py:40-49
ROW7 = dict(keys=1_000_000, steps=8, per_step=125_000, shards=4,
            slots=1 << 14, dead=1, nth=15)
#: PERF.md section 4's Q5-revenue: bench.py's bids, 10M in steps of 1<<20
Q5REV = dict(records=10_000_000, step=1 << 20, shards=8, dead=3, nth=12,
             auctions=100_000, rate=100_000, size_ms=10_000,
             slide_ms=2_000)


def row7_steps(keys: int, n_steps: int, per_step: int):
    """``tools/chaos_smoke.py`` ``_steps``: ``(keys, values, timestamps,
    watermark)`` per step."""
    rng = np.random.default_rng(17)
    out = []
    for s in range(n_steps):
        k = rng.integers(0, keys, per_step).astype(np.int64)
        v = rng.random(per_step).astype(np.float32)
        ts = rng.integers(s * 80, s * 80 + 60, per_step).astype(np.int64)
        out.append((k, v, ts, (s - 1) * 80))
    return out


def q5rev_steps(records: int, step: int = Q5REV["step"]):
    """``bench.py``'s bids in steps of ``step``: (auction, float32 price,
    timestamp, the step's newest timestamp - 1)."""
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    src = BidSource(total_records=records, num_auctions=Q5REV["auctions"],
                    events_per_second_of_eventtime=Q5REV["rate"])
    src.open()
    out = []
    while (b := src.poll_batch(step)) is not None:
        ts = np.asarray(b.timestamps, dtype=np.int64)
        out.append((np.asarray(b["auction"], dtype=np.int64),
                    np.asarray(b["price"], dtype=np.float32), ts,
                    int(ts.max()) - 1))
    return out


def row7_makers(device, keys: int, shards: int = ROW7["shards"],
                slots: int = ROW7["slots"]):
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.sessions import SessionWindower

    def make_engine():
        return MeshSessionEngine(
            GAP, SumAggregate("v"), make_mesh(shards, device),
            capacity_per_shard=max(1 << 14, slots), max_device_slots=slots,
            max_dispatch_ahead=2)

    def make_oracle():
        return SessionWindower(GAP, SumAggregate("v"),
                               capacity=max(1 << 15, 2 * keys),
                               spill={"device": device})

    return make_engine, make_oracle


def q5rev_makers(device, shards: int = Q5REV["shards"]):
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.windower import SliceSharedWindower

    def assigner():
        return SlidingEventTimeWindows.of(Q5REV["size_ms"],
                                          Q5REV["slide_ms"])

    def make_engine():
        return MeshWindowEngine(assigner(), SumAggregate("v"),
                                make_mesh(shards, device),
                                capacity_per_shard=1 << 16,
                                max_dispatch_ahead=2)

    def make_oracle():
        return SliceSharedWindower(assigner(), SumAggregate("v"),
                                   capacity=1 << 22,
                                   spill={"device": device})

    return make_engine, make_oracle


def launches() -> Dict[str, int]:
    """The two kernels' launch counts (each wrapper's counter)."""
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank

    return {"exchange_rank": rank.launches,
            "ordered_fold": ordered_fold_planes.launches}


def _reset_launches() -> None:
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank

    rank.launches = 0
    ordered_fold_planes.launches = 0


def watched(make_engine: Callable, seen: dict) -> Callable:
    """``make_engine`` that (a) sets both launch counts to 0 when the FIRST
    engine is built — the oracle has run by then, so the counts are the
    engine's alone — and (b) records the counts and the mesh size where a
    shard is lost. ``seen["engine"]`` is the newest engine."""

    def make():
        if "engine" not in seen:
            _reset_launches()
            seen["t0"] = time.perf_counter()
        eng = make_engine()
        real = eng.lose_shards

        def lose_shards(dead):
            seen.setdefault("at_loss", []).append(
                {"P": eng.P, **launches()})
            return real(dead)

        eng.lose_shards = lose_shards
        seen["engine"] = eng
        return eng

    return make


def run(shape: str = "row7", device=None, keys: Optional[int] = None,
        check: bool = True, records: Optional[int] = None) -> dict:
    """One shard-loss run of ``shape`` (``keys`` cuts row 7's key space,
    ``records`` Q5-revenue's bids); returns the JSON row (gates in
    ``failures``), the report and the final engine."""
    from flink_tpu_torch.chaos.harness import run_shard_loss_verify
    from flink_tpu_torch.chaos.injection import FaultPlan, FaultRule
    from flink_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    if shape == "row7":
        cfg = ROW7
        keys = cfg["keys"] if keys is None else keys
        steps = row7_steps(keys, cfg["steps"], cfg["per_step"])
        make_engine, make_oracle = row7_makers(device, keys)
    else:
        cfg = Q5REV
        steps = q5rev_steps(cfg["records"] if records is None else records)
        make_engine, make_oracle = q5rev_makers(device)
    plan = FaultPlan(rules=[FaultRule(
        pattern="device.lost", nth=cfg["nth"],
        where={"shard": cfg["dead"]})])
    seen: dict = {}
    with tempfile.TemporaryDirectory(prefix="shard-loss-") as tmp:
        t0 = time.perf_counter()
        report = run_shard_loss_verify(
            watched(make_engine, seen), make_oracle, steps, plan,
            seed=SEED, ckpt_root=os.path.join(tmp, "ckpt"),
            checkpoint_every=2, check=check)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    eng = seen["engine"]
    total = launches()
    at = (seen.get("at_loss") or [{}])[0]
    chaotic_s = t1 - seen["t0"]
    loss = eng.last_shard_loss or {}
    shards = cfg["shards"]
    row = {
        "bench": f"shard_loss_{shape}",
        "device": str(device),
        "events": report.events,
        "shards": shards,
        "dead": cfg["dead"],
        **report.signature(),
        "shard_loss_recovery_ms": report.shard_loss_recovery_ms,
        "recovery_parts_ms": dict(report.shard_loss_parts_ms),
        "survivor_rows": loss.get("survivor_rows"),
        "survivor_rows_resident": loss.get("resident_rows"),
        "survivor_rows_spilled": loss.get("spilled_rows"),
        "mesh": [loss.get("from"), loss.get("to")],
        "dead_key_groups": list(loss.get("key_groups", ())),
        "checkpoint_write_ms": report.checkpoint_write_ms,
        "checkpoint_bytes": report.checkpoint_bytes,
        "chaotic_run_s": chaotic_s,
        "events_per_s": report.events / chaotic_s,
        "whole_s": t1 - t0,
        "spill_counters": eng.spill_counters(),
        "launches": total,
        "launches_before_loss": {k: at.get(k) for k in total},
        "launches_after_loss": {k: total[k] - at.get(k, 0)
                                for k in total},
        "P_at_loss": at.get("P"),
        "P_after_loss": eng.P,
    }
    failures: List[str] = []
    if report.diverged:
        failures.append(f"output diverged ({len(report.divergences)})")
    if report.shards_lost != 1:
        failures.append(f"expected 1 shard loss, got {report.shards_lost}")
    if report.shard_restores != 1:
        failures.append(f"expected 1 unit restore, got "
                        f"{report.shard_restores}")
    budget = report.events // shards
    if not 0 < report.records_replayed <= budget:
        failures.append(f"records_replayed {report.records_replayed} not "
                        f"in (0, events/shards = {budget}]")
    if shape == "row7" and row["spill_counters"]["rows_evicted"] <= 0:
        failures.append("no row was evicted: the paged tier was off the "
                        "path")
    row["failures"] = failures
    return {"row": row, "report": report, "engine": eng}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=("row7", "q5rev"), default="row7")
    ap.add_argument("--keys", type=int, default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    out = run(args.shape, args.device, keys=args.keys, check=False)
    print(json.dumps(out["row"]))
    if out["row"]["failures"]:
        raise SystemExit("shard loss gates failed: "
                         + "; ".join(out["row"]["failures"]))


if __name__ == "__main__":
    main()
