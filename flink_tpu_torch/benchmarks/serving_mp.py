"""BASELINE row 9: the multi-process serving tier (port of the reference's
``tools/bench_serving_mp.py``; host code, the card is not involved).

Frontend processes attach the owner's shared-memory hot-cache arenas
(``tenancy/frontend.py``) and run the probe -> packed-reply loop in their
own processes, while the owner keeps priming a new generation every
``prime_interval_ms`` — so the number describes a table that serves fresh
boundaries, not a frozen one.

Measured: the aggregate lookups/s across the frontends (from the arena
headers' counters, not wall-clock division) and the same loop in one
process (the owner's ``get_many_packed``). Gates (``failures``): every
frontend reports, hit rate >= 0.98, the owner primed at least 3
generations under the probes, no torn read surfaced (every value a
frontend returned during the priming is one generation's whole row:
``v == g * 1e6 + key``), and after the priming stops the frontends'
answers equal the owner's dict oracle (``get_many``) for every key.

    python -m flink_tpu_torch.benchmarks.serving_mp --frontends 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List

import numpy as np

JOB, OP = "bench", "window_agg"


class _BenchPlane:
    """The minimal owner the pool needs: the shm cache and a miss
    resolver answering the generation the owner primed last (a torn
    probe that exhausts its retries falls to this path)."""

    def __init__(self, cache):
        self.hot_cache = cache
        self.gen = 1

    def lookup_batch(self, job, op, keys):
        return _values(keys, self.gen)


def _values(keys, gen):
    return [{0: {"g": float(gen), "v": gen * 1_000_000.0 + float(k)}}
            for k in keys]


def _torn(keys, answers) -> int:
    """Answers that are not one generation's whole row."""
    bad = 0
    for k, a in zip(keys, answers):
        row = (a or {}).get(0)
        if row is None or row["v"] != row["g"] * 1_000_000.0 + float(k):
            bad += 1
    return bad


def row9(frontends: int = 2, keys: int = 4096, batch: int = 256,
         batches: int = 2000, prime_interval_ms: float = 25.0,
         root: str = None) -> Dict[str, Any]:
    from flink_tpu_torch.native import hotcache_available
    from flink_tpu_torch.tenancy.frontend import FrontendPool
    from flink_tpu_torch.tenancy.hot_cache import make_hot_row_cache
    from flink_tpu_torch.tenancy.serving import aggregate_lookup_stats

    if not hotcache_available():
        return {"failures": ["native hotcache unavailable"]}
    failures: List[str] = []
    with tempfile.TemporaryDirectory(prefix="serving_mp_",
                                     dir=root) as tmp:
        cache = make_hot_row_cache(max_entries=1 << 18,
                                   shm_dir=os.path.join(tmp, "shm"))
        try:
            klist = list(range(keys))
            cache.put_many(JOB, OP, klist, 1, _values(klist, 1))
            # ---- one process: the owner's own packed probe loop
            kid = np.arange(keys, dtype=np.int64)
            t0 = time.perf_counter()
            for b in range(batches):
                lo = (b * batch) % (keys - batch + 1)
                out = [None] * batch
                misses: List[int] = []
                cache.get_many_packed(JOB, OP, kid[lo:lo + batch], 1,
                                      out, misses, exact=False)
            single_wall = time.perf_counter() - t0
            single_per_s = batches * batch / single_wall
            # ---- N frontends drive the loop while the owner primes
            plane = _BenchPlane(cache)
            pool = FrontendPool(plane, n_frontends=frontends)
            try:
                pool.wait_ready()
                stop = threading.Event()
                primed = {"gens": 1}

                def primer():
                    gen = 1
                    while not stop.is_set():
                        gen += 1
                        cache.put_many(JOB, OP, klist, gen,
                                       _values(klist, gen))
                        plane.gen = primed["gens"] = gen
                        time.sleep(prime_interval_ms / 1e3)

                th = threading.Thread(target=primer, daemon=True)
                th.start()
                try:
                    t0 = time.perf_counter()
                    reports = pool.drive(JOB, OP, klist, batch=batch,
                                         batches=batches)
                    mp_wall = time.perf_counter() - t0
                    # torn reads surfaced to a caller, under the priming
                    torn_seen = 0
                    rng = np.random.default_rng(9)
                    for _ in range(50):
                        ks = rng.integers(0, keys, batch).tolist()
                        torn_seen += _torn(ks, pool.lookup_batch(JOB, OP,
                                                                 ks))
                finally:
                    stop.set()
                    th.join(timeout=5)
                fe_rows = cache.fe_stats(frontends)
                # parity with the owner's dict oracle, priming stopped
                parity_bad = 0
                for lo in range(0, keys, batch):
                    ks = klist[lo:lo + batch]
                    got = pool.lookup_batch(JOB, OP, ks)
                    want: List[Any] = [None] * len(ks)
                    cache.get_many(JOB, OP, ks, primed["gens"], want, [],
                                   exact=False)
                    parity_bad += sum(1 for g, w in zip(got, want)
                                      if g != w or w is None)
            finally:
                pool.close()
        finally:
            cache.close()
    probes = sum(r["probes"] for r in fe_rows)
    hits = sum(r["hits"] for r in fe_rows)
    torn_retries = sum(r["torn_retries"] for r in fe_rows)
    mp_per_s = probes / mp_wall if mp_wall > 0 else 0.0
    one_fe = max((r["probes"] / r["wall_s"] for r in reports
                  if r.get("wall_s")), default=0.0)
    hit_rate = hits / probes if probes else 0.0
    if len(reports) < frontends:
        failures.append(f"only {len(reports)}/{frontends} frontends "
                        "reported")
    if hit_rate < 0.98:
        failures.append(f"hit rate {hit_rate:.3f} < 0.98")
    if primed["gens"] < 3:
        failures.append(f"the owner primed only {primed['gens']} "
                        "generations")
    if torn_seen:
        failures.append(f"{torn_seen} torn reads surfaced")
    if parity_bad:
        failures.append(f"{parity_bad} answers differ from the owner's "
                        "dict oracle")
    return {
        "lookups_per_s": mp_per_s,
        "one_frontend_lookups_per_s": one_fe,
        "single_proc_lookups_per_s": single_per_s,
        "scaling_x": mp_per_s / single_per_s if single_per_s else 0.0,
        "hit_rate": hit_rate,
        "torn_retries": torn_retries,
        "torn_surfaced": torn_seen,
        "parity_mismatches": parity_bad,
        "generations": primed["gens"],
        "frontend_stats": aggregate_lookup_stats(
            [], frontend_stats=fe_rows),
        "per_frontend": reports,
        "failures": failures,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frontends", type=int, default=2)
    ap.add_argument("--batches", type=int, default=2000)
    args = ap.parse_args(argv)
    out = row9(frontends=args.frontends, batches=args.batches)
    print(json.dumps(out, default=str))
    return 0 if not out["failures"] else 1


if __name__ == "__main__":
    sys.exit(main())
