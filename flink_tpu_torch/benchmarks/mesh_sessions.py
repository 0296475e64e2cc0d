"""BASELINE row 5 on the mesh session engine: the uniform-key mode of
``tools/bench_mesh_sessions.py`` on the port, and its Zipf mode (row 5c).

    python3 -m flink_tpu_torch.benchmarks.mesh_sessions [--records N]
        [--reps N] [--device cuda|cpu] [--deadline-ms MS]
        [--zipf [--zipf-s S] [--check]]

Drives ``MeshSessionEngine`` directly at the reference's thrashing shape:
P=8, gap 2,000 ms, float32 Sum of ``v`` (ones), keys uniform over 10M
(``default_rng(3)``), 400,000 events/s of event time, batches of 1<<16,
a budget of 1<<16 rows per shard (524,288 in all) against ~800k live
sessions — the paged spill tier evicts and reloads on every shard.

The loop is PIPELINED and FIRE-DEADLINE-AWARE as the reference's: fires
are dispatched async and harvested coalesced (at most
``MAX_PENDING_FIRES`` in flight); each batch is split against the
deadline at the measured per-record rate (power-of-two splits), and the
watermark advances in deadline-sized quanta within a split. Fire latency
is wall time from the watermark advance that dispatched a fire to its
results on the host; the end-of-input flush is timed apart
(``final_drain_ms``). Where the reference reads flight-recorder spans,
this loop times the engine's calls with ``time.perf_counter``.

Prints one JSON line: events/s (the median rep), fire p50/p99, the spill
counters, the page-rewrite amplification ``(rows_split_on_reload +
rows_compacted) / rows_reloaded`` and a host breakdown. The device
defaults to the card.

Zipf mode (``--zipf``, BASELINE row 5c ``mesh_sessions_zipf``): the same
shape with the key column drawn Zipf(``--zipf-s``, default 1.1) over the
10M-key space (``(rng.zipf(s) - 1) % 10M``), and the skew ladder live:
``parallel/load.ShardLoadAccountant`` -> ``autoscale/rebalance.
RebalancePolicy`` -> ``SkewResponder`` moves hot key groups between
shards at batch boundaries (``reassign_key_groups``) and splits dominant
keys (``register_hot_key``, 16 salts). A uniform control run of the same
shape is the denominator of ``skew_recovery_fraction``. The row fails as
VACUOUS when no live move happened or nothing was salted. ``--check``
replays the Zipf run's exact ingest splits and watermarks on an engine
without the ladder and requires every fired (key, start, end, sum) to be
bit-identical (the values are ones: integer-valued float32).
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from collections import deque

import numpy as np

GAP_MS = 2_000
EVENTS_PER_S_OF_EVENTTIME = 400_000
NUM_KEYS = 10_000_000
BUDGET_PER_SHARD = 1 << 16  # x8 shards = row 5's 524,288-row budget
MAX_PENDING_FIRES = 8
RECORDS = 4_000_000         # the suite's BENCH_MESH_SESSION_RECORDS
BATCH = 1 << 16
DEADLINE_MS = 25.0
PARALLELISM = 8
SEED = 3
ZIPF_S = 1.1
#: the skew ladder's settings (``tools/bench_mesh_sessions.py`` defaults)
SKEW_TOPK = 64
SKEW_TRIGGER = 1.25
SKEW_SALTS = 16


def stream_batches(total: int, zipf: float = 0.0):
    """The bench's records, batch by batch: ``(keys, timestamps)`` with
    keys uniform over ``NUM_KEYS`` (or Zipf(``zipf``) ranks folded into
    it) from ``default_rng(SEED)`` and timestamps rising at
    ``EVENTS_PER_S_OF_EVENTTIME``."""
    rng = np.random.default_rng(SEED)
    produced = 0
    while produced < total:
        b = min(BATCH, total - produced)
        if zipf > 0:
            keys = ((rng.zipf(zipf, b) - 1) % NUM_KEYS).astype(np.int64)
        else:
            keys = rng.integers(0, NUM_KEYS, b).astype(np.int64)
        ts = ((produced + np.arange(b, dtype=np.int64)) * 1000
              // EVENTS_PER_S_OF_EVENTTIME)
        yield keys, ts
        produced += b


def amplification(counters) -> float:
    """Page rewrites per reloaded row."""
    return ((counters["rows_split_on_reload"] + counters["rows_compacted"])
            / max(counters["rows_reloaded"], 1))


def make_responder(eng):
    """The skew ladder on ``eng``: load accounting -> live key-group
    moves -> hot-key splitting (a 64-counter sketch keeps the dominant
    keys' shares above the split threshold under a 10M-key tail)."""
    from flink_tpu_torch.autoscale import RebalancePolicy, SkewResponder
    from flink_tpu_torch.parallel.load import ShardLoadAccountant

    acc = ShardLoadAccountant(eng.P, eng.max_parallelism, ewma_alpha=0.5,
                              top_k=SKEW_TOPK)
    return SkewResponder(
        eng, acc, policy=RebalancePolicy(imbalance_trigger=SKEW_TRIGGER,
                                         hysteresis=0.05, cooldown_s=2.0,
                                         max_moves=16),
        salts=SKEW_SALTS, hot_key_share=0.5, allow_inexact=True)


def run(total: int, device: str = "cuda", deadline_ms: float = DEADLINE_MS,
        collect: bool = False, zipf: float = 0.0, respond: bool = False,
        schedule=None) -> dict:
    """One pass; returns events/s, sessions fired, fire latency, spill
    counters, a host breakdown and the engine. ``collect`` keeps every
    fired batch, the record index each ingest split started at (the
    watermark before a split is the last timestamp before it: what an
    oracle needs to place sessions exactly) and the ``schedule`` — per
    split ``(batch, a, z, watermarks)`` — that ``schedule=`` replays
    exactly. ``zipf`` > 0 draws Zipf keys; ``respond`` runs the skew
    ladder at every batch boundary (``skew`` in the result)."""
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    eng = MeshSessionEngine(GAP_MS, SumAggregate("v"),
                            make_mesh(PARALLELISM, device),
                            capacity_per_shard=BUDGET_PER_SHARD,
                            max_device_slots=BUDGET_PER_SHARD)
    deadline_s = deadline_ms / 1000.0
    responder = make_responder(eng) if respond else None
    plan = None
    if schedule is not None:
        plan = {}
        for bi, a, z, wms in schedule:
            plan.setdefault(bi, []).append((a, z, wms))
    taken = []          # the schedule this pass ran
    pending = deque()   # (PendingFire, watermark-advance start time)
    lat = []            # fire latency, ms
    batches = []
    split_starts = []
    fired = 0
    rate = 0.0          # EMA records/s, sizes the deadline splits
    host = {"ingest_s": 0.0, "fire_dispatch_s": 0.0, "harvest_s": 0.0}

    def harvest(bound=MAX_PENDING_FIRES):
        # coalesced: drain whatever landed, and bound the in-flight fires
        nonlocal fired
        while pending and (pending[0][0].ready() or len(pending) > bound):
            pf, t_wm = pending.popleft()
            t0 = time.perf_counter()
            out = pf.harvest()
            host["harvest_s"] += time.perf_counter() - t0
            fired += len(out)
            lat.append((time.perf_counter() - t_wm) * 1e3)
            if collect:
                batches.append(out)

    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        produced = 0
        for bi, (keys, ts) in enumerate(stream_batches(total, zipf)):
            b = len(keys)
            if plan is not None:
                splits = plan.get(bi, [])
            else:
                splits = []
                if deadline_s <= 0:
                    chunk = b
                elif rate <= 0:
                    chunk = 16384  # seed until the rate EMA settles
                else:
                    chunk = 1 << max(int(rate * deadline_s) * 4,
                                     8192).bit_length()
                a = 0
                while a < b:
                    splits.append((a, min(a + chunk, b), None))
                    a += chunk
            for a, z, wms in splits:
                if wms is None:
                    if deadline_s <= 0:
                        quanta = 1
                    else:
                        per_q = 1 << max(int(rate * deadline_s),
                                         2048).bit_length()
                        quanta = min(max((z - a + per_q - 1) // per_q, 1),
                                     32)
                    wms = [int(ts[w - 1]) for w in
                           (a + (z - a) * (j + 1) // quanta
                            for j in range(quanta)) if w > a]
                if collect:
                    split_starts.append(produced + a)
                    taken.append((bi, a, z, wms))
                t1 = time.perf_counter()
                eng.process_batch(RecordBatch({
                    KEY_ID_FIELD: keys[a:z],
                    "v": np.ones(z - a, dtype=np.float32),
                    TIMESTAMP_FIELD: ts[a:z]}))
                t2 = time.perf_counter()
                host["ingest_s"] += t2 - t1
                for wm in wms:
                    t_wm = time.perf_counter()
                    for pf in eng.on_watermark(wm, async_ok=True):
                        pending.append((pf, t_wm))
                    host["fire_dispatch_s"] += time.perf_counter() - t_wm
                    harvest()
                step_rate = (z - a) / max(t2 - t1, 1e-9)
                rate = step_rate if rate <= 0 else 0.7 * rate + 0.3 * step_rate
                if responder is not None:
                    responder.note_batch(keys[a:z])
            produced += b
            if responder is not None:
                # batch boundary: tick the accountant, maybe move hot
                # groups and register splits (the cooldown bounds churn)
                t_r = time.perf_counter()
                responder.maybe_respond()
                host["respond_s"] = host.get("respond_s", 0.0) + (
                    time.perf_counter() - t_r)
        harvest(bound=0)
        # end of input: flush every live session (a shutdown drain, kept
        # out of the fire percentiles)
        t5 = time.perf_counter()
        for pf in eng.on_watermark(1 << 60, async_ok=True):
            out = pf.harvest()
            fired += len(out)
            if collect:
                batches.append(out)
        t_drain = time.perf_counter() - t5
        dt = time.perf_counter() - t0
    finally:
        gc.enable()
    lat.sort()

    def q(p):
        return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

    counters = eng.spill_counters()
    out = {
        "events_per_s": total / dt,
        "wall_s": dt,
        "sessions_fired": fired,
        "fire_latency_ms": {"p50": q(0.5), "p99": q(0.99),
                            "max": lat[-1] if lat else 0.0,
                            "count": len(lat),
                            "final_drain_ms": t_drain * 1e3},
        "spill": counters,
        "rewrite_amplification": amplification(counters),
        "late_records_dropped": eng.late_records_dropped,
        "merge_groups": eng.merge_groups,
        "breakdown": {**host,
                      "pipeline_wait_s": eng.pipeline_wait_s,
                      "native_sweep_s": getattr(eng.meta, "native_sweep_s",
                                                0.0)},
        "engine": eng,
    }
    if responder is not None:
        hot = eng.hot_key_stats()
        out["skew"] = {
            "rebalances": responder.rebalances,
            "groups_moved": responder.groups_moved,
            "keys_split": responder.keys_split,
            "hot_keys": hot["keys"],
            "salted_records": hot["salted_records"],
            "salted_fires": hot["salted_fires"],
            # the measured load imbalance under the live table, and what
            # the contiguous layout would have concentrated
            "imbalance_live": responder.accountant.imbalance(
                eng.key_group_assignment),
            "imbalance_contiguous": responder.accountant.imbalance(),
            "assignment_contiguous": eng.key_group_assignment.is_contiguous,
            "handoff_s": (eng.last_rebalance or {}).get("seconds", 0.0),
        }
    if collect:
        out["batches"] = batches
        out["split_starts"] = split_starts
        out["schedule"] = taken
    return out


def fired_rows(batches) -> list:
    """Every fired ``(key, start, end, sum bits)``, sorted."""
    from flink_tpu_torch.core.records import KEY_ID_FIELD

    rows = []
    for b in batches:
        for out in (b if isinstance(b, list) else [b]):
            rows.extend(zip(
                np.asarray(out[KEY_ID_FIELD]).tolist(),
                np.asarray(out["window_start"]).tolist(),
                np.asarray(out["window_end"]).tolist(),
                np.asarray(out["sum_v"], dtype=np.float32).view(
                    np.uint32).tolist()))
    rows.sort()
    return rows


class VacuousSkewRun(RuntimeError):
    """The Zipf row never moved a key group or never salted a record."""


def run_zipf_row(total: int, device: str = "cuda",
                 deadline_ms: float = DEADLINE_MS, zipf_s: float = ZIPF_S,
                 check: bool = False) -> dict:
    """BASELINE row 5c: the uniform control, then the Zipf run with the
    skew ladder live; with ``check`` the Zipf run's exact schedule is
    replayed without the ladder and every fired row must be
    bit-identical. Raises :class:`VacuousSkewRun` when the ladder never
    engaged (no live move, nothing salted)."""
    uni = run(total, device, deadline_ms=deadline_ms)
    uni.pop("engine")
    z = run(total, device, deadline_ms=deadline_ms, zipf=zipf_s,
            respond=True, collect=check)
    eng = z.pop("engine")
    skew = z["skew"]
    line = {
        "metric": "mesh_sessions_zipf_events_per_sec",
        "events_per_s": z["events_per_s"],
        "uniform_events_per_s": uni["events_per_s"],
        "skew_recovery_fraction": z["events_per_s"] / max(
            uni["events_per_s"], 1e-9),
        "zipf_s": zipf_s,
        "mesh_shards": eng.P,
        "sessions_fired": z["sessions_fired"],
        "uniform_sessions_fired": uni["sessions_fired"],
        "skew": skew,
        "fire_latency_ms": z["fire_latency_ms"],
        "uniform_fire_latency_ms": uni["fire_latency_ms"],
        "spill": z["spill"],
        "breakdown": z["breakdown"],
        "shape": (f"{total} records, Zipf({zipf_s}) keys over the 10M-key "
                  f"space, 400k ev/s event time, 2 s gap, {eng.P}x"
                  f"{BUDGET_PER_SHARD} device rows (paged spill), the skew "
                  "ladder live; recovery = zipf/uniform events/s"),
    }
    if check:
        plain = run(total, device, deadline_ms=deadline_ms, zipf=zipf_s,
                    collect=True, schedule=z["schedule"])
        plain.pop("engine")
        got, want = fired_rows(z["batches"]), fired_rows(plain["batches"])
        # the same Zipf splits without the ladder: its effect alone
        line["zipf_unsplit_events_per_s"] = plain["events_per_s"]
        line["fired_rows"] = len(got)
        line["bit_identical_to_unsplit"] = got == want
    if skew["rebalances"] < 1 or skew["salted_records"] == 0:
        raise VacuousSkewRun(
            f"skew row is VACUOUS: rebalances={skew['rebalances']}, "
            f"salted_records={skew['salted_records']} — the skew ladder "
            "never engaged on the Zipf shape")
    return line


def load_libraries(device: str) -> None:
    """Build (if stale) and load every library the run calls, so a cold
    checkout's g++ / nvcc builds fall outside the timed window."""
    from flink_tpu_torch.native import load_sessions, load_slotmap

    load_sessions()
    load_slotmap()
    if device.startswith("cuda"):
        from flink_tpu_torch.stateplane.fold import build_fold_kernel
        from flink_tpu_torch.stateplane.rank import build_rank_kernel

        build_fold_kernel()
        build_rank_kernel()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=int, default=RECORDS)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deadline-ms", type=float, default=DEADLINE_MS)
    ap.add_argument("--zipf", action="store_true",
                    help="BASELINE row 5c: Zipf keys, the skew ladder live")
    ap.add_argument("--zipf-s", type=float, default=ZIPF_S)
    ap.add_argument("--check", action="store_true",
                    help="with --zipf: replay without the ladder and "
                    "require bit-identical fires")
    args = ap.parse_args()
    load_libraries(args.device)
    if args.zipf:
        line = run_zipf_row(args.records, args.device, args.deadline_ms,
                            args.zipf_s, check=args.check)
        line["device"] = args.device
        print(json.dumps(line, default=str))
        if args.check and not line["bit_identical_to_unsplit"]:
            raise SystemExit("zipf fires differ from the unsplit run")
        return
    reps = [run(args.records, args.device, deadline_ms=args.deadline_ms)
            for _ in range(max(args.reps, 1))]
    by_rate = sorted(reps, key=lambda r: r["events_per_s"])
    med = by_rate[len(by_rate) // 2]
    eng = med.pop("engine")
    for r in reps:
        r.pop("engine", None)
    line = {
        "metric": "mesh_sessions_10m_keys_events_per_sec",
        "events_per_s": med["events_per_s"],
        "rep_events_per_s": [r["events_per_s"] for r in reps],
        "device": args.device,
        "mesh_shards": eng.P,
        "native_session_plane": type(eng.meta).__name__
        == "NativeSessionIntervalSet",
        **{k: v for k, v in med.items() if k != "events_per_s"},
        "fire_deadline_ms": args.deadline_ms,
        "shape": (f"{args.records} records, 400k ev/s event time, 2 s gap, "
                  f"uniform keys over 10M, {eng.P}x{BUDGET_PER_SHARD} device "
                  "rows (paged spill per shard), pipelined loop"),
    }
    if args.device.startswith("cuda"):
        import torch

        line["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
