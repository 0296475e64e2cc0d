"""A keyed process job with its state on the device: the
``CountWithTimeoutFunction`` of Flink's "Process Function" documentation
(``docs/content/docs/dev/datastream/operators/process_function.md``),
written batch-wise.

Per key the function keeps a count and the timestamp of its last record
(``lastModified``) in two int64 ``DeviceValueStateDescriptor`` states, and
registers an event-time timer at ``lastModified + 60,000`` ms for every
record; a timer emits ``(key, count)`` when it equals the key's
``lastModified + 60,000`` at the time it fires, so a key's later record
suppresses its earlier emission. A batch's records are sorted by
timestamp first, and each state is written with ONE put in which a key
may appear many times: the last lane, the newest record, wins.

    python -m flink_tpu_torch.benchmarks.process_timeout [--device cpu]
        [--records N] [--keys N] [--batch N] [--async-state] [--check]

The default shape is ``DataGenSource(total_records=4_000_000,
num_keys=10_000_000, events_per_second_of_eventtime=20_000, seed=7)``,
0 ms out-of-orderness, micro-batches of 1<<16, parallelism 1: ~3.30M
distinct keys (10M x (1 - e^-0.4)), so the state's slot index grows to
1<<22. ``--check`` holds the rows against ``oracle`` (NumPy). One JSON
line is printed.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List

import numpy as np

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.process import KeyedProcessFunction
from flink_tpu_torch.state.async_state import DeviceValueStateDescriptor

TIMEOUT_MS = 60_000
SHAPE = {"records": 4_000_000, "keys": 10_000_000, "rate": 20_000,
         "batch": 1 << 16, "seed": 7}


class CountWithTimeout(KeyedProcessFunction):
    """The documentation's function over batches. ``descriptor`` and
    ``batch_cls`` are the state descriptor class and RecordBatch class to
    use (a package's own, so that the same function runs in either
    package); ``use_async`` goes through ``ctx.async_state``. Counts the
    host seconds of its state calls and of the timer heap, the timers it
    registers and fires, and each fire's latency from the watermark's
    arrival at the timer service to the emitted batch."""

    def __init__(self, descriptor=DeviceValueStateDescriptor,
                 batch_cls=RecordBatch, use_async: bool = False):
        self.COUNT = descriptor("count", np.int64, 0)
        self.LAST = descriptor("last_modified", np.int64, 0)
        self.batch_cls = batch_cls
        self.use_async = use_async
        self.state_s = 0.0
        self.heap_s = 0.0
        self.registered = 0
        self.fired = 0
        self.fire_ms: List[float] = []
        self._wm_t0 = 0.0

    def open(self, ctx) -> None:
        #: the sync state handles (the device states' tensors live there)
        self.states = (ctx.state(self.COUNT), ctx.state(self.LAST))
        timers = ctx.timer_service()
        advance = timers.advance_watermark

        def timed_advance(wm):
            t0 = time.perf_counter()
            out = advance(wm)
            self._wm_t0 = t0
            self.heap_s += time.perf_counter() - t0
            return out

        timers.advance_watermark = timed_advance

    def _states(self, ctx):
        get = ctx.async_state if self.use_async else ctx.state
        return get(self.COUNT), get(self.LAST)

    def process_batch(self, batch, ctx) -> None:
        order = np.argsort(batch.timestamps, kind="stable")
        kid = batch.key_ids[order]
        ts = batch.timestamps[order]
        # each lane's occurrence number of its key within the batch
        by_key = np.argsort(kid, kind="stable")
        sk = kid[by_key]
        n = len(kid)
        starts = np.r_[True, sk[1:] != sk[:-1]]
        first = np.maximum.accumulate(np.where(starts, np.arange(n), 0))
        occ = np.empty(n, dtype=np.int64)
        occ[by_key] = np.arange(n) - first + 1
        t0 = time.perf_counter()
        count, last = self._states(ctx)
        if self.use_async:
            count.get(kid).then(
                lambda old: count.put(kid, np.asarray(old) + occ))
        else:
            count.put(kid, count.get(kid) + occ)
        last.put(kid, ts)
        self.state_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx.timer_service().register_event_time_timers(kid, ts + TIMEOUT_MS)
        self.heap_s += time.perf_counter() - t0
        self.registered += n

    def on_timer(self, key_ids, timestamps, ctx) -> None:
        t0 = time.perf_counter()
        count, last = self._states(ctx)
        if self.use_async:
            fc, fl = count.get(key_ids), last.get(key_ids)
            cnt, lm = fc.value(), fl.value()
        else:
            cnt, lm = count.get(key_ids), last.get(key_ids)
        self.state_s += time.perf_counter() - t0
        due = timestamps == lm + TIMEOUT_MS
        self.fired += len(key_ids)
        ctx.collect(self.batch_cls.from_pydict(
            {"key_id": key_ids[due], "count": cnt[due]},
            timestamps=timestamps[due]))
        self.fire_ms.append((time.perf_counter() - self._wm_t0) * 1e3)


def build(env, source, fn):
    """DataGen -> key_by("key") -> process(fn), 0 ms out-of-orderness."""
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    return env.from_source(
        source, WatermarkStrategy.for_bounded_out_of_orderness(0),
        name="datagen").key_by("key").process(fn, name="count_with_timeout")


def run(device: str, records: int = SHAPE["records"],
        keys: int = SHAPE["keys"], batch: int = SHAPE["batch"],
        use_async: bool = False, rate: int = SHAPE["rate"],
        seed: int = SHAPE["seed"]) -> Dict[str, Any]:
    """Run the job on ``device`` through ``env.execute()``; returns its
    rows (one RecordBatch, in emission order), the function (its
    counters) and the job's metrics."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import DataGenSource

    env = StreamExecutionEnvironment(Configuration({
        "execution.device": device, "execution.micro-batch.size": batch}))
    fn = CountWithTimeout(use_async=use_async)
    sink = CollectSink()
    build(env, DataGenSource(total_records=records, num_keys=keys,
                             events_per_second_of_eventtime=rate,
                             seed=seed), fn).sink_to(sink)
    result = env.execute("count_with_timeout")
    rows = sink.result() if sink.batches else RecordBatch(
        {"key_id": np.zeros(0, np.int64), "count": np.zeros(0, np.int64)})
    return {"rows": rows, "fn": fn, "metrics": result.metrics}


def oracle(records: int = SHAPE["records"], keys: int = SHAPE["keys"],
           batch: int = SHAPE["batch"], rate: int = SHAPE["rate"],
           seed: int = SHAPE["seed"]) -> Dict[str, np.ndarray]:
    """The same job in NumPy at the executor's cadence: a watermark of
    (max timestamp - 1) after every batch, MAX_WATERMARK at the end;
    timers deduplicated, fired in (timestamp, key id) order, emitting
    where the timer equals lastModified + 60,000 at the time it fires."""
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.state.keygroups import hash_keys_to_i64

    count = np.zeros(keys, dtype=np.int64)
    last = np.zeros(keys, dtype=np.int64)
    # pending timers as (timestamp << 24 | key): ordered by timestamp;
    # a timer registered twice is one timer, so duplicates merge when due
    pend = np.zeros(0, dtype=np.int64)
    out_k: List[np.ndarray] = []
    out_c: List[np.ndarray] = []
    out_t: List[np.ndarray] = []

    def fire(upto):
        nonlocal pend
        due = pend <= (upto << 24) | ((1 << 24) - 1)
        code = np.unique(pend[due])
        pend = pend[~due]
        t, k = code >> 24, code & ((1 << 24) - 1)
        kid = hash_keys_to_i64(k)
        order = np.lexsort((kid, t))
        t, k, kid = t[order], k[order], kid[order]
        emit = t == last[k] + TIMEOUT_MS
        out_k.append(kid[emit])
        out_c.append(count[k[emit]])
        out_t.append(t[emit])

    src = DataGenSource(total_records=records, num_keys=keys,
                        events_per_second_of_eventtime=rate, seed=seed)
    src.open(0, 1)
    max_ts = None
    while True:
        b = src.poll_batch(batch)
        if b is None:
            break
        order = np.argsort(b.timestamps, kind="stable")
        k = b["key"][order]
        ts = b.timestamps[order]
        np.add.at(count, k, 1)
        last[k] = ts  # NumPy: the last lane, the newest record, wins
        pend = np.concatenate([pend, ((ts + TIMEOUT_MS) << 24) | k])
        m = int(b.timestamps.max())
        max_ts = m if max_ts is None else max(max_ts, m)
        fire(max_ts - 1)
    fire(np.iinfo(np.int64).max >> 24)
    return {"key_id": np.concatenate(out_k), "count": np.concatenate(out_c),
            "ts": np.concatenate(out_t)}


def rows_equal(rows: RecordBatch, want: Dict[str, np.ndarray]) -> bool:
    """The job's rows equal ``want`` in emission order, exactly."""
    return (np.array_equal(rows["key_id"], want["key_id"])
            and np.array_equal(rows["count"], want["count"])
            and np.array_equal(rows.timestamps, want["ts"]))


def summary(out: Dict[str, Any]) -> Dict[str, Any]:
    fn, m = out["fn"], out["metrics"]
    lat = sorted(fn.fire_ms)

    def q(p):
        return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

    return {"records": m["records_emitted_by_sources"],
            "rows": len(out["rows"]),
            "events_per_s": m["records_per_s"], "runtime_s": m["runtime_s"],
            "fire_p50_ms": q(0.5), "fire_p99_ms": q(0.99),
            "fires": len(lat), "timers_registered": fn.registered,
            "timers_fired": fn.fired, "heap_s": fn.heap_s,
            "state_s": fn.state_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--records", type=int, default=SHAPE["records"])
    ap.add_argument("--keys", type=int, default=SHAPE["keys"])
    ap.add_argument("--batch", type=int, default=SHAPE["batch"])
    ap.add_argument("--async-state", action="store_true")
    ap.add_argument("--check", action="store_true")
    a = ap.parse_args()
    out = run(a.device, a.records, a.keys, a.batch, a.async_state)
    row = {"device": a.device, **summary(out)}
    if a.check:
        row["oracle_ok"] = rows_equal(
            out["rows"], oracle(a.records, a.keys, a.batch))
    print(json.dumps(row))


if __name__ == "__main__":
    main()
