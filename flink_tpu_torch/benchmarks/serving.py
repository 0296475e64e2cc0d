"""BASELINE row 6: queryable-state lookups against two concurrent jobs on
one session cluster (port of the reference's ``tools/serving_smoke.py``
harness at ``tools/bench_suite.py``'s row-6 settings).

The shape, as the reference runs it:

1. **Warm phase** — job-1 runs alone on a session cluster with 2 lookup
   clients: the engines' step families enter ``PROGRAM_CACHE``.
2. **Measured phase** — a FRESH cluster runs two fresh jobs (job-2 under
   a resident-row quota, job-3 without) while ``clients`` threads issue
   ``lookup_batch_packed`` calls of ``lookup_batch`` keys with a pause
   between calls; a sampler records the replica's generations and
   staleness.

Each job: ``DataGenSource`` (``records`` records, ``keys`` keys, seed 13,
50k events/s of event time) -> ``key_by("key")`` -> tumbling 60 s windows
-> ``.sum("value")``, at ``parallelism.default`` 4, micro-batches of 4,096,
``latency.fire-deadline-ms`` 25, ``serving.replica`` on with a 25 ms
publish interval, and ``state.slot-table.max-device-slots`` from
``TenantQuota(8192).per_shard_slots(4)``.

Gates (``result["failures"]``): no client error, zero program-cache
misses and at least one hit for each fresh job (their steps were cached
by job-1), lookups
served, a hot-row cache hit, at least 2 replica generations, no quota
violation, output from both jobs, and the packed answers equal the dict
answers (one materialized cross-check, repeated while a publish moves the
boundary between the two calls). The reference's 350k lookups/s floor and
25 ms p99 budget were set on other hardware: they are reported beside the
measured numbers (``floors``), not gated.

    python -m flink_tpu_torch.benchmarks.serving --device cpu --records 100000
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Any, Dict, List

import numpy as np

OPERATOR = "window_agg(SumAggregate)"
#: the reference's row-6 floor and budget (not gated here)
REF_MIN_LOOKUPS_PER_S = 350_000.0
REF_P99_BUDGET_MS = 25.0


def pipeline(sink, device: str, records: int, keys: int = 4096,
             quota_rows: int = 8192, publish_interval_ms: int = 25,
             seed: int = 13):
    """One row-6 job as an environment (the reference's ``_pipeline``)."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.tenancy.quotas import TenantQuota
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    env = StreamExecutionEnvironment(Configuration({
        "execution.device": device,
        "execution.micro-batch.size": 4096,
        "parallelism.default": 4,
        "latency.fire-deadline-ms": 25,
        "serving.replica": True,
        "serving.replica.publish-interval-ms": publish_interval_ms,
        "state.slot-table.max-device-slots": TenantQuota(
            max_resident_rows=quota_rows).per_shard_slots(4),
    }))
    (env.add_source(
        DataGenSource(total_records=records, num_keys=keys,
                      events_per_second_of_eventtime=50_000, seed=seed),
        WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key")
        .window(TumblingEventTimeWindows.of(60_000))
        .sum("value").sink_to(sink))
    return env


def run_with_lookups(cluster, job_names: List[str], n_clients: int,
                     keys: int, lookup_batch: int, pause_ms: float,
                     timeout_s: float = 600.0) -> Dict[str, Any]:
    """Drive ``cluster`` to its end while client threads issue packed
    lookups; returns the wall time, the scheduler thread's CPU time (the
    rest of its wall it waited, mostly for the GIL the clients hold),
    client errors, the most replica generations seen, the staleness
    samples, the per-call latencies and whether the packed/dict
    cross-check passed."""
    stop = threading.Event()
    errors: List[str] = []
    seen = {"gens": 0, "checked": False}
    staleness: List[float] = []
    lat_ms: List[float] = []

    def sampler():
        # the jobs unbind their replicas at finish: read DURING the run
        while not stop.is_set():
            seen["gens"] = max(seen["gens"],
                               cluster.serving.replica_generations())
            staleness.append(cluster.serving.replica_staleness_ms())
            time.sleep(0.01)

    def client(i):
        rng = np.random.default_rng(100 + i)
        while not stop.is_set():
            job = job_names[i % len(job_names)]
            ks = rng.integers(0, keys, lookup_batch).tolist()
            try:
                t0 = time.perf_counter()
                res = cluster.lookup_batch_packed(job, OPERATOR, ks)
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and not seen["checked"]:
                    # a publish can land between the two calls: only a
                    # REPEATED mismatch counts
                    for _ in range(5):
                        if res.to_dicts() == cluster.lookup_batch(
                                job, OPERATOR, ks):
                            seen["checked"] = True
                            break
                        res = cluster.lookup_batch_packed(job, OPERATOR,
                                                          ks)
                    else:
                        errors.append("packed != dict lookup results")
                        return
            except RuntimeError as e:
                if ("is not serving" in str(e)
                        or "already terminated" in str(e)
                        or "shut down" in str(e)):
                    return  # the job finished: lookups drain off
                errors.append(f"client {i}: {e!r}")
                return
            except TimeoutError:
                errors.append(f"client {i}: lookup timed out")
                return
            if pause_ms:
                time.sleep(pause_ms / 1e3)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    threads.append(threading.Thread(target=sampler, daemon=True))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    c0 = time.thread_time()
    try:
        results = cluster.run(timeout_s=timeout_s)
    finally:
        cpu_s = time.thread_time() - c0
        stop.set()
        for t in threads:
            t.join(timeout=10)
    return {"elapsed_s": time.perf_counter() - t0,
            "scheduler_cpu_s": cpu_s, "errors": errors,
            "generations": seen["gens"], "staleness_ms": staleness,
            "latencies_ms": lat_ms, "checked": seen["checked"],
            "results": results}


def row6(device: str = "cuda", records: int = 400_000,
         clients: int = 16, keys: int = 4096, lookup_batch: int = 256,
         pause_ms: float = 2.0, quota_rows: int = 8192,
         publish_interval_ms: int = 25, workers: int = 2,
         cache_entries: int = 1 << 18) -> Dict[str, Any]:
    """The warm job, then the two measured jobs; returns the metrics,
    the gate failures and the measured jobs' sink rows (``rows``)."""
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.metrics.core import quantile_sorted
    from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE
    from flink_tpu_torch.tenancy.quotas import TenantQuota
    from flink_tpu_torch.tenancy.session_cluster import SessionCluster

    def job(sink):
        return pipeline(sink, device, records, keys, quota_rows,
                        publish_interval_ms)

    warm = SessionCluster(quantum_records=8192, serving_workers=workers,
                          serving_cache_entries=cache_entries)
    warm.submit(job(CollectSink()), "job-1")
    run_with_lookups(warm, ["job-1"], 2, keys, lookup_batch, pause_ms)

    PROGRAM_CACHE.reset_stats()
    cluster = SessionCluster(quantum_records=8192, serving_workers=workers,
                             serving_cache_entries=cache_entries)
    s2, s3 = CollectSink(), CollectSink()
    cluster.submit(job(s2), "job-2",
                   quota=TenantQuota(max_resident_rows=quota_rows))
    cluster.submit(job(s3), "job-3")
    run = run_with_lookups(cluster, ["job-2", "job-3"], clients, keys,
                           lookup_batch, pause_ms)

    failures: List[str] = list(run["errors"])
    metrics = cluster.serving.metrics()
    lookups = int(metrics["lookups_total"])
    elapsed = run["elapsed_s"]
    lookups_per_s = lookups / elapsed if elapsed > 0 else 0.0
    lat = sorted(run["latencies_ms"])
    stale = sorted(run["staleness_ms"])
    cache = {j: PROGRAM_CACHE.stats_for(j) for j in ("job-2", "job-3")}
    misses = {j: s["misses"] for j, s in cache.items()}
    violations = cluster.jobs["job-2"].ledger.quota_violations
    for j, s in cache.items():
        if s["misses"]:
            failures.append(f"{j} paid {s['misses']} program-cache misses "
                            "on a warm cluster")
        if not s["hits"]:
            # a job whose builds escaped its job_scope reads zeros
            failures.append(f"{j} recorded no program-cache hit")
    if lookups == 0:
        failures.append("zero lookups served")
    if float(metrics["hot_row_hit_rate"]) <= 0.0:
        failures.append("the hot-row cache never served a hit")
    if run["generations"] < 2:
        failures.append(f"replica generations {run['generations']} < 2")
    if violations:
        failures.append(f"{violations} quota violations on job-2")
    if not run["checked"]:
        failures.append("the packed/dict cross-check never ran")
    for name, res in run["results"].items():
        if isinstance(res, BaseException):
            failures.append(f"{name} failed: {res!r}")
    rows = {"job-2": s2.rows(), "job-3": s3.rows()}
    for name, r in rows.items():
        if not r:
            failures.append(f"{name} produced no output")
    return {
        "lookups": lookups,
        "lookup_batches": int(metrics["lookup_batches_total"]),
        "elapsed_s": elapsed,
        "scheduler_cpu_s": run["scheduler_cpu_s"],
        "lookups_per_s": lookups_per_s,
        "call_p50_ms": quantile_sorted(lat, 0.5) if lat else 0.0,
        "call_p99_ms": quantile_sorted(lat, 0.99) if lat else 0.0,
        "lookup_p99_ms": float(metrics["lookup_p99_ms"]),
        "hot_row_hit_rate": float(metrics["hot_row_hit_rate"]),
        "replica_generations": run["generations"],
        "staleness_p99_ms": quantile_sorted(stale, 0.99) if stale else 0.0,
        "program_cache_misses": misses,
        "quota_violations": violations,
        "floors": {"reference_min_lookups_per_s": REF_MIN_LOOKUPS_PER_S,
                   "reference_p99_budget_ms": REF_P99_BUDGET_MS},
        "failures": failures,
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--records", type=int, default=400_000)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--pause-ms", type=float, default=2.0)
    args = ap.parse_args(argv)
    out = row6(args.device, args.records, args.clients,
               pause_ms=args.pause_ms)
    out.pop("rows")
    print(json.dumps(out, default=str))
    return 0 if not out["failures"] else 1


if __name__ == "__main__":
    sys.exit(main())
