"""High-QPS queryable-state serving: coalesce lookups into device batches
(port of ``flink_tpu/tenancy/serving.py``, the whole module; host code).

The cost of a point lookup against device-resident state is fixed: one
gather and ONE device-to-host copy. At serving QPS the only lever is
amortization: concurrent lookups for the same (job, operator) coalesce
into one request batch, so a burst of N lookups pays one device round
trip, not N. That is this module:

- :class:`LookupCoalescer` — the generic client-side combiner: callers
  from any thread enqueue ``(key, namespace)`` and block on their slice
  of the batch result; the first enqueuer becomes the flusher after a
  short window (or when the batch is full) and issues ONE batched call.
- :class:`ServingPlane` — the cluster-side plane: per-(job, operator)
  coalescers whose flush posts a
  :class:`~flink_tpu_torch.cluster.local_executor.StateQueryBatchRequest`
  to the job's control queue (served on the task loop at a batch
  boundary, race-free), plus the serving metrics (lookups/s, batch
  sizes, p99). Its replica path (``bind_replica``, the worker pool, the
  hot-row cache probe) serves the sealed generations of a read replica's
  adapter (``tenancy/replica.py``; the session cluster binds them).

Reference: flink-queryable-state's KvStateClientProxy pipelines requests
per TaskManager connection; here the pipeline depth becomes an explicit
device batch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.observe.lock_sentinel import named_lock


def reservoir_p99_ms(latencies) -> float:
    """p99 of a latency reservoir (ms); 0.0 when empty. Pays the one
    sort, then reads through ``metrics.core.quantile_sorted`` — the
    shared percentile-index formula (also the fire-latency p99's)."""
    from flink_tpu_torch.metrics.core import quantile_sorted

    return quantile_sorted(sorted(latencies), 0.99)


def lookup_stats_dict(lookups: int, batches: int,
                      latencies) -> Dict[str, float]:
    """The canonical serving-stats dict shape, built in ONE place (pays
    the one p99 sort) — every aggregation path returns through here so
    field names and avg_batch_size semantics cannot drift."""
    return {
        "lookups_total": lookups,
        "lookup_batches_total": batches,
        "avg_batch_size": lookups / batches if batches else 0.0,
        "lookup_p99_ms": reservoir_p99_ms(latencies),
    }


def aggregate_lookup_stats(coalescers,
                           frontend_stats=None) -> Dict[str, float]:
    """Merge coalescer counters + latency reservoirs into the canonical
    serving-stats dict (one sort, for the p99). Reads go through each
    coalescer's locked snapshot — client threads append concurrently,
    and iterating a deque mid-append raises.

    ``frontend_stats`` (optional): per-frontend counter rows as
    ``NativeHotRowCache.fe_stats`` returns them — the multi-process
    tier's shm-header counters. Frontend-served probes fold into
    ``lookups_total`` (a frontend hit IS a served lookup that never
    reached a coalescer) and the per-counter sums ride along under
    ``frontend_*``, so a breakdown derives from the real
    counters, not wall-clock division."""
    lookups = 0
    batches = 0
    lat: List[float] = []
    for c in coalescers:
        n, b, ms = c.stats_snapshot()
        lookups += n
        batches += b
        lat.extend(ms)
    out = lookup_stats_dict(lookups, batches, lat)
    if frontend_stats:
        for k in frontend_stats[0].keys():
            out[f"frontend_{k}"] = float(
                sum(r[k] for r in frontend_stats))
        # hits answered inside a frontend never cross to a coalescer;
        # miss crossings DO reach one (counted there already)
        out["lookups_total"] += out.get("frontend_hits", 0.0)
    return out


class _Pending:
    __slots__ = ("key", "namespace", "result", "error", "done")

    def __init__(self, key, namespace):
        self.key = key
        self.namespace = namespace
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class LookupCoalescer:
    """Combine concurrent point lookups into batched flushes.

    ``flush_fn(keys, namespace) -> list_of_results`` executes one device
    batch. Entries sharing a namespace filter batch together; distinct
    namespaces flush as separate batches within one drain (rare — the
    common serving path passes ``namespace=None``).

    ``window_ms`` — how long the first enqueuer waits for riders before
    flushing (0 = flush immediately, still coalescing whatever arrived
    concurrently); ``max_batch`` — flush early when full.
    """

    def __init__(self, flush_fn: Callable[[List[Any], Any], List[Any]],
                 max_batch: int = 512, window_ms: float = 1.0):
        self._flush_fn = flush_fn
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        self._lock = named_lock("serving.coalescer")
        self._queue: deque = deque()
        self._flusher_active = False
        #: served lookups / flush batches (the amortization evidence)
        self.lookups_total = 0
        self.batches_total = 0
        #: bounded reservoir of per-lookup latencies (ms)
        self.latencies_ms: deque = deque(maxlen=8192)
        #: set by CoalescerPool.retire: post-retirement counts redirect
        #: into the pool's retained totals, so a lookup racing a
        #: retire (forget_job / unbind_job) is never silently dropped
        #: from cumulative stats
        self._fold_into = None

    def _record(self, n_lookups: int = 0, batches: int = 0,
                lat=()) -> None:
        with self._lock:
            sink = self._fold_into
            if sink is None:
                self.lookups_total += n_lookups
                self.batches_total += batches
                self.latencies_ms.extend(lat)
                return
        # release our lock before _absorb takes the pool's: no path
        # ever holds both locks at once (retire also staggers them)
        sink._absorb(n_lookups, batches, lat)

    def lookup(self, key, namespace=None, timeout_s: float = 30.0):
        """Enqueue one lookup and block until its batch lands."""
        t0 = time.perf_counter()
        entry = _Pending(key, namespace)
        flush_now = False
        with self._lock:
            self._queue.append(entry)
            if not self._flusher_active:
                # first in line becomes the flusher for this window
                self._flusher_active = True
                flush_now = True
        if flush_now:
            if self.window_s > 0:
                # ride-collection window: let concurrent callers pile on
                deadline = time.monotonic() + self.window_s
                while time.monotonic() < deadline:
                    with self._lock:
                        if len(self._queue) >= self.max_batch:
                            break
                    time.sleep(self.window_s / 4)
            # flusher-duty handoff: exactly one thread set
            # _flusher_active under the first hold and owns the duty
            # until _drain clears it under its own hold; late enqueuers
            # see the flag and ride instead of flushing
            self._drain()
        if not entry.done.wait(timeout_s):
            raise TimeoutError("queryable-state lookup not served")
        self._record(lat=((time.perf_counter() - t0) * 1e3,))
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _drain(self) -> None:
        """Flush everything queued, in (at most max_batch)-sized device
        batches, grouped by namespace filter. Runs on the flusher's
        thread; errors fan out to every rider of the failed batch."""
        while True:
            try:
                while True:
                    with self._lock:
                        if not self._queue:
                            break
                        batch = [self._queue.popleft()
                                 for _ in range(min(len(self._queue),
                                                    self.max_batch))]
                    by_ns: Dict[Any, List[_Pending]] = {}
                    for e in batch:
                        by_ns.setdefault(e.namespace, []).append(e)
                    for ns, entries in by_ns.items():
                        try:
                            results = self._flush_fn(
                                [e.key for e in entries], ns)
                            if len(results) != len(entries):
                                # a short reply must be an ERROR for
                                # every rider — zip-truncating would
                                # hand the tail result=None, which
                                # reads as "key has no state"
                                raise RuntimeError(
                                    f"lookup flush returned "
                                    f"{len(results)} results for "
                                    f"{len(entries)} keys")
                            for e, r in zip(entries, results):
                                e.result = r
                        except BaseException as err:  # noqa: BLE001
                            for e in entries:
                                e.error = err
                        finally:
                            self._record(n_lookups=len(entries),
                                         batches=1)
                            for e in entries:
                                e.done.set()
            except BaseException:
                # release flusher duty before propagating: the next
                # lookup() claims it and drains whatever is queued
                with self._lock:
                    self._flusher_active = False
                raise
            with self._lock:
                if not self._queue:
                    self._flusher_active = False
                    return
                # entries raced in after our last empty check: keep
                # flusher duty and loop — a loop, not tail-recursion, so
                # a one-rider-per-round arrival pattern cannot grow the
                # stack

    def stats_snapshot(self) -> Tuple[int, int, List[float]]:
        """(lookups_total, batches_total, latencies) under the lock —
        the only safe way to read the counters and the reservoir while
        client threads serve."""
        with self._lock:
            return (self.lookups_total, self.batches_total,
                    list(self.latencies_ms))

    def note_batch(self, n_lookups: int, elapsed_ms: float) -> None:
        """Record an externally-flushed batch (ServingPlane's explicit
        ``lookup_batch`` path) against this coalescer's counters."""
        self._record(n_lookups=n_lookups, batches=1, lat=(elapsed_ms,))

    def p99_ms(self) -> float:
        with self._lock:
            lat = list(self.latencies_ms)
        return reservoir_p99_ms(lat)


class CoalescerPool:
    """Per-key pool of :class:`LookupCoalescer`\\ s: double-checked
    creation, retirement, cumulative stats. The ONE copy of the
    coalescer lifecycle — the serving plane (keys = (job, operator))
    and the queryable-state client share it, so the creation race,
    retirement accounting, and stats shape can't drift between them.
    Retired members fold their counters (and bounded latency
    reservoirs) into retained totals, so cumulative stats survive
    member churn (jobs finishing, clients forgetting)."""

    def __init__(self, make_flush: Callable[[Any], Callable],
                 max_batch: int = 512, window_ms: float = 1.0):
        self._make_flush = make_flush
        self._max_batch = int(max_batch)
        self._window_ms = float(window_ms)
        self._members: Dict[Any, LookupCoalescer] = {}
        self._lock = named_lock("serving.pool")
        self._retired_lookups = 0
        self._retired_batches = 0
        self._retired_lat: deque = deque(maxlen=8192)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def get(self, key) -> LookupCoalescer:
        # fully locked (construction is cheap): an unlocked fast path
        # would let get and retire interleave mid-read
        with self._lock:
            co = self._members.get(key)
            if co is None:
                co = self._members[key] = LookupCoalescer(
                    self._make_flush(key),
                    max_batch=self._max_batch,
                    window_ms=self._window_ms)
            return co

    def retire(self, match: Callable[[Any], bool]) -> None:
        with self._lock:
            popped = [self._members.pop(k)
                      for k in [k for k in self._members if match(k)]]
        for co in popped:
            # fold the counters AND flag the coalescer: a lookup that
            # already holds a reference (raced the pop) records its
            # counts into our retained totals via _record/_absorb —
            # nothing is silently dropped from cumulative stats. Locks
            # are taken one at a time (pool, then co, then pool again),
            # never nested.
            with co._lock:
                n, b = co.lookups_total, co.batches_total
                ms = list(co.latencies_ms)
                co.lookups_total = 0
                co.batches_total = 0
                co.latencies_ms.clear()
                co._fold_into = self
            self._absorb(n, b, ms)

    def _absorb(self, n_lookups: int, batches: int, lat) -> None:
        with self._lock:
            self._retired_lookups += n_lookups
            self._retired_batches += batches
            self._retired_lat.extend(lat)

    def snapshot(self) -> List[LookupCoalescer]:
        # under the lock: client threads insert concurrently, and dict
        # iteration during an insert raises
        with self._lock:
            return list(self._members.values())

    def lookups_total(self) -> int:
        """One counter, one walk — what a per-scrape gauge reads."""
        with self._lock:
            n = self._retired_lookups
        for c in self.snapshot():
            with c._lock:
                n += c.lookups_total
        return n

    def batches_total(self) -> int:
        with self._lock:
            n = self._retired_batches
        for c in self.snapshot():
            with c._lock:
                n += c.batches_total
        return n

    def latencies(self) -> List[float]:
        with self._lock:
            lat: List[float] = list(self._retired_lat)
        for c in self.snapshot():
            lat.extend(c.stats_snapshot()[2])
        return lat

    def stats(self) -> Dict[str, float]:
        """The canonical serving-stats dict, retained totals included
        (pays the one p99 sort)."""
        with self._lock:
            lookups = self._retired_lookups
            batches = self._retired_batches
            lat = list(self._retired_lat)
        for c in self.snapshot():
            n, b, ms = c.stats_snapshot()
            lookups += n
            batches += b
            lat.extend(ms)
        return lookup_stats_dict(lookups, batches, lat)


class PackedLookupResult:
    """A batch lookup's results, materialized LAZILY: hit keys live in
    the native probe's packed buffers (:class:`PackedProbe` — raw
    int64/float64 bit patterns, zero copies, zero dicts built); only a
    key somebody actually reads pays dict construction, and it is
    cached per index. Misses (and Python-plane fallbacks) are
    pre-materialized ``overrides``. Sequence-compatible: ``len``,
    indexing, iteration, ``==`` against a plain list — and
    :meth:`to_dicts` for the full eager form (bit-identical to
    ``lookup_batch``, test-pinned)."""

    __slots__ = ("_n", "_probe", "_overrides", "_cache")

    def __init__(self, n: int, probe, overrides: Dict[int, Any]) -> None:
        self._n = int(n)
        self._probe = probe
        self._overrides = overrides
        self._cache: Dict[int, Any] = {}

    @classmethod
    def from_dicts(cls, results) -> "PackedLookupResult":
        return cls(len(results), None, dict(enumerate(results)))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        if i in self._overrides:
            return self._overrides[i]
        v = self._cache.get(i)
        if v is None:
            v = self._probe.materialize(i)
            self._cache[i] = v
        return v

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def to_dicts(self) -> List[Any]:
        return [self[i] for i in range(self._n)]

    def __eq__(self, other):
        if isinstance(other, PackedLookupResult):
            return self.to_dicts() == other.to_dicts()
        if isinstance(other, list):
            return self.to_dicts() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"PackedLookupResult(n={self._n})"


class _RepPending:
    """One rider of the replica serving path (shard-queue entry)."""

    __slots__ = ("key", "key_id", "namespace", "result", "error", "done")

    def __init__(self, key, key_id: int, namespace):
        self.key = key
        self.key_id = key_id
        self.namespace = namespace
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class _ReplicaWorker(threading.Thread):
    """One serving worker: the single owner of its set of per-(job,
    operator, shard) lookup queues. Riders enqueue misses; the worker
    drains every owned queue each round, batches the entries per (job,
    operator) against ONE sealed replica generation, and completes the
    riders — multiple workers drain disjoint shard sets concurrently,
    so one tenant's burst never serializes every tenant's traffic
    behind a single drain loop (the pre-replica bottleneck)."""

    def __init__(self, plane: "ServingPlane", idx: int) -> None:
        super().__init__(name=f"serving-worker-{idx}", daemon=True)
        self._plane = plane
        self._lock = named_lock("serving.worker")
        self._queues: Dict[tuple, deque] = {}
        self._event = threading.Event()
        self._stopped = False

    def enqueue(self, qkey: tuple, entry: _RepPending) -> None:
        with self._lock:
            self._queues.setdefault(qkey, deque()).append(entry)
        self._event.set()

    def stop(self) -> None:
        self._stopped = True
        self._event.set()

    def fail_pending(self, reason: str) -> None:
        """Complete any still-queued riders with an error (shutdown —
        nothing will drain the queues again)."""
        with self._lock:
            leftovers = [e for q in self._queues.values() for e in q]
            self._queues.clear()
        for e in leftovers:
            e.error = RuntimeError(reason)
            e.done.set()

    def run(self) -> None:
        while not self._stopped:
            self._event.wait(timeout=0.1)
            self._event.clear()
            while self._drain_round():
                pass

    def _drain_round(self) -> bool:
        # pop everything queued this round (bounded: later arrivals
        # land in the next round), grouped per (job, operator) — one
        # replica batch per group per round
        groups: Dict[tuple, List[_RepPending]] = {}
        with self._lock:
            for (job, op, _shard), q in self._queues.items():
                if q:
                    groups.setdefault((job, op), []).extend(q)
                    q.clear()
        if not groups:
            return False
        for (job, op), entries in groups.items():
            self._plane._flush_replica(job, op, entries)
        return True


class ServingPlane:
    """The session cluster's lookup surface. Two read paths:

    - **Replica path** (an adapter is bound for the (job, operator)):
      probe the host hot-row cache; misses go to per-shard lookup
      queues drained by the worker pool, which resolves them against
      the SEALED replica generation — one gather + one device read per
      miss batch, zero contention with ingest, results cached under
      the generation tag. Cold rows detour through the legacy path
      below (page tiers are single-owner host state).
    - **Legacy path** (no replica — single-device engines, pre-publish
      warmup): per-(job, operator) coalescers flushing batched
      StateQueryBatchRequests onto the owning job's control queue,
      served by the task loop at a batch boundary."""

    def __init__(self, max_batch: int = 512, window_ms: float = 1.0,
                 timeout_s: float = 30.0, workers: int = 2,
                 cache_entries: int = 1 << 18,
                 shm_dir: Optional[str] = None):
        self.max_batch = int(max_batch)
        self.window_ms = float(window_ms)
        self.timeout_s = float(timeout_s)
        self.n_workers = max(int(workers), 1)
        #: when set, the hot cache allocates MAP_SHARED arenas under
        #: this directory and frontend processes may attach (the
        #: multi-process serving tier — tenancy/frontend.py)
        self.shm_dir = shm_dir

        def make_flush(key):
            def flush(keys, namespace, _job=key[0], _op=key[1]):
                return self._flush(_job, _op, keys, namespace)

            return flush

        self._pool = CoalescerPool(make_flush, max_batch=self.max_batch,
                                   window_ms=self.window_ms)
        #: job name -> control queue (bound by the session cluster)
        self._queues: Dict[str, Any] = {}
        #: (job, operator) -> ReplicaAdapter (bound by the cluster)
        self._replicas: Dict[tuple, Any] = {}
        from flink_tpu_torch.tenancy.hot_cache import make_hot_row_cache

        #: the native GIL-free probe table when available, else the
        #: bit-identical Python LRU (FLINK_TPU_NATIVE_HOTCACHE=0 A/B)
        self.hot_cache = make_hot_row_cache(cache_entries,
                                            shm_dir=shm_dir)
        self._workers: List[_ReplicaWorker] = []
        self._workers_lock = named_lock("serving.workers")
        #: sampled serving.cache_hit instants (1-in-N — a per-hit ring
        #: write at cache-hit QPS would itself cost a core fraction)
        self._hit_sample = 0

    # ------------------------------------------------------------- binding

    def bind_job(self, job_name: str, control_queue) -> None:
        self._queues[job_name] = control_queue

    def bind_replica(self, job_name: str, operator: str,
                     adapter) -> None:
        """Register a replica adapter for (job, operator) lookups; the
        cold-row detour rides the legacy control-queue flush."""
        adapter.cold_fetch = (
            lambda keys, _j=job_name, _o=operator:
            self._flush(_j, _o, list(keys), None))
        adapter.attach_cache(self.hot_cache, job_name, operator)
        self._replicas[(job_name, operator)] = adapter
        self._ensure_workers()

    def unbind_job(self, job_name: str) -> None:
        self._queues.pop(job_name, None)
        for k in [k for k in self._replicas if k[0] == job_name]:
            del self._replicas[k]
        self.hot_cache.invalidate_job(job_name)
        # retire the job's coalescers: a cluster churning many short
        # jobs would otherwise grow the pool (and its latency
        # reservoirs, and every scrape's walk) per HISTORICAL job
        self._pool.retire(lambda k: k[0] == job_name)

    def _ensure_workers(self) -> None:
        self._pick_worker(("", "", 0))  # starts the pool if stopped

    def shutdown_workers(self) -> None:
        """Stop the worker pool (cluster run finished). A later
        bind_replica restarts it; riders still queued fail fast."""
        with self._workers_lock:
            workers, self._workers = self._workers, []
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=2)
            w.fail_pending("serving workers shut down (cluster run "
                           "finished)")

    def _pick_worker(self, qkey: tuple) -> _ReplicaWorker:
        with self._workers_lock:
            while len(self._workers) < self.n_workers:
                w = _ReplicaWorker(self, len(self._workers))
                self._workers.append(w)
                w.start()
            return self._workers[hash(qkey) % len(self._workers)]

    def _coalescer(self, job_name: str, operator: str) -> LookupCoalescer:
        # bound-check BEFORE pool.get: a client still polling a finished
        # job would otherwise re-create the retired coalescer (plus its
        # latency reservoir) on every lookup, with no future unbind to
        # retire it — the per-historical-job leak, deterministically
        if job_name not in self._queues:
            raise RuntimeError(
                f"job {job_name!r} is not serving (not running, or "
                "finished)")
        co = self._pool.get((job_name, operator))
        if job_name not in self._queues:
            # unbind raced our get: retire what we may have re-created
            self._pool.retire(lambda k: k == (job_name, operator))
            raise RuntimeError(
                f"job {job_name!r} is not serving (not running, or "
                "finished)")
        return co

    def _flush(self, job_name: str, operator: str, keys, namespace):
        from flink_tpu_torch.observe import flight_recorder as flight

        with flight.span("serving.lookup", job=job_name):
            return self._flush_inner(job_name, operator, keys,
                                     namespace)

    def _flush_inner(self, job_name: str, operator: str, keys,
                     namespace):
        from flink_tpu_torch.cluster.local_executor import (
            StateQueryBatchRequest,
        )

        q = self._queues.get(job_name)
        if q is None:
            raise RuntimeError(
                f"job {job_name!r} is not serving (not running, or "
                "finished)")
        req = StateQueryBatchRequest(operator, keys, namespace)
        q.put(req)
        if self._queues.get(job_name) is not q:
            # the job terminated between our bound-queue check and the
            # put: the executor's terminal drain (and the cluster's
            # post-unbind drain) may both have missed this request, and
            # nothing will ever serve the dead queue — fail whatever is
            # still on it (every entry is equally stranded) so riders
            # get the prompt not-serving error instead of a timeout
            import queue as _queue

            while True:
                try:
                    stranded = q.get_nowait()
                except _queue.Empty:
                    break
                stranded.finish(None, RuntimeError(
                    f"job {job_name!r} is not serving (not running, or "
                    "finished)"))
        return req.wait(self.timeout_s)

    # ---------------------------------------------------------- replica path

    def _adapter(self, job_name: str, operator: str):
        ad = self._replicas.get((job_name, operator))
        if ad is None or not ad.ready():
            return None
        return ad

    @staticmethod
    def _filter_ns(result, namespace):
        if namespace is None:
            return result
        ns = int(namespace)
        return {ns: result[ns]} if ns in result else {}

    @staticmethod
    def _probe_faulted(job_name: str, operator: str) -> bool:
        """The ``serving.cache_probe`` chaos point: raise/delay kinds
        apply in place; a ``drop`` kind makes the probe fall to the
        MISS path for this request (the system-level shape of a torn
        native read — the entry is skipped, never served mixed).
        One module-global None check while disarmed."""
        from flink_tpu_torch.chaos import injection as chaos

        rule = chaos.payload_action(
            "serving.cache_probe", kinds=("raise", "delay", "drop"),
            job=job_name, operator=operator)
        return rule is not None and rule.kind == "drop"

    def _cache_probe(self, job_name: str, operator: str, ad, key,
                     co) -> Tuple[bool, int, int, Any]:
        """(hit, key_id, generation, value) — one batched native probe
        (or one locked dict access on the Python fallback); a hit
        records its (sub-ms) latency against the coalescer's reservoir
        and a SAMPLED serving.cache_hit instant."""
        from flink_tpu_torch.observe import flight_recorder as flight

        kid = ad.key_id(key)
        gen = ad.generation()
        if self._probe_faulted(job_name, operator):
            return False, kid, gen, None
        # exact=False: bound adapters re-prime/drop every entry a
        # publish changes, so presence implies validity (see HotRowCache)
        hit, val = self.hot_cache.get(job_name, operator, kid, gen,
                                      exact=False)
        if hit:
            co._record(n_lookups=1)
            self._hit_sample += 1
            if self._hit_sample % 256 == 1:
                flight.instant("serving.cache_hit", job=job_name,
                               batch=gen)
        return hit, kid, gen, val

    def _enqueue_miss(self, job_name: str, operator: str, ad, key,
                      kid: int, namespace) -> _RepPending:
        entry = _RepPending(key, kid, namespace)
        shard = ad.shard_of(kid)
        qkey = (job_name, operator, shard)
        # shard -> worker is a stable partition: exactly one worker
        # ever drains one shard queue (single-owner discipline)
        self._pick_worker(qkey).enqueue(qkey, entry)
        return entry

    def _flush_replica(self, job_name: str, operator: str,
                       entries: List[_RepPending]) -> None:
        """Worker-side: resolve one miss batch against ONE sealed
        generation, fill the hot-row cache, complete the riders. The
        coalescer's guarantees carry over: a short result raises to
        EVERY rider (zip-truncation would read as 'key has no state'),
        and counters/latencies are recorded under the coalescer lock
        (through _record, which also folds into retained totals when a
        retire raced — nothing drops from cumulative stats)."""
        from flink_tpu_torch.observe import flight_recorder as flight

        t0 = time.perf_counter()
        try:
            # the bound-check/retire dance of the legacy path: a job
            # unbound mid-flight must not re-create a retired coalescer
            # (the per-historical-job leak) — and its riders get the
            # prompt not-serving error
            co = self._coalescer(job_name, operator)
        except RuntimeError as err:
            for e in entries:
                e.error = err
                e.done.set()
            self._pool._absorb(len(entries), 1, ())
            return
        ad = self._replicas.get((job_name, operator))
        # chunk at max_batch: bounds one device batch's gather tier and
        # keeps a burst from stretching every rider's latency behind
        # one giant flush (the legacy coalescer's exact discipline)
        for i in range(0, len(entries), self.max_batch):
            chunk = entries[i:i + self.max_batch]
            try:
                if ad is None:
                    raise RuntimeError(
                        f"job {job_name!r} is not serving (not running, "
                        "or finished)")
                gen = ad.generation()
                with flight.span("serving.lookup", job=job_name,
                                 batch=gen):
                    results, gen = ad.lookup_batch(
                        [e.key for e in chunk])
                if len(results) != len(chunk):
                    raise RuntimeError(
                        f"replica lookup returned {len(results)} "
                        f"results for {len(chunk)} keys")
            except BaseException as err:  # noqa: BLE001
                for e in chunk:
                    e.error = err
                    e.done.set()
                co._record(n_lookups=len(chunk), batches=1)
                continue
            # fill the cache only when the plane has not sealed a newer
            # generation since this chunk resolved: put() guards
            # downgrades of EXISTING entries, but an ABSENT key would
            # insert the stale value — and with presence-implies-
            # validity probes, a key that then stops changing (so no
            # future prime touches it) would serve it forever
            if ad.generation() == gen:
                # ONE batched fill (a single GIL-released C call on the
                # native plane) instead of a locked put per key
                self.hot_cache.put_many(
                    job_name, operator, [e.key_id for e in chunk],
                    gen, results)
            for e, r in zip(chunk, results):
                e.result = r
                e.done.set()
            co._record(n_lookups=len(chunk), batches=1,
                       lat=((time.perf_counter() - t0) * 1e3,))

    # ------------------------------------------------------------- lookups

    def lookup(self, job_name: str, operator: str, key,
               namespace=None):
        """One point lookup. Replica-armed operators probe the hot-row
        cache, then ride the shard-queue worker path; others ride the
        legacy coalescer's forming batch."""
        ad = self._adapter(job_name, operator)
        if ad is None:
            return self._coalescer(job_name, operator).lookup(
                key, namespace, timeout_s=self.timeout_s)
        t0 = time.perf_counter()
        co = self._coalescer(job_name, operator)
        hit, kid, gen, val = self._cache_probe(job_name, operator, ad,
                                               key, co)
        if hit:
            co._record(lat=((time.perf_counter() - t0) * 1e3,))
            return self._filter_ns(val, namespace)
        entry = self._enqueue_miss(job_name, operator, ad, key, kid,
                                   namespace)
        if not entry.done.wait(self.timeout_s):
            raise TimeoutError("queryable-state lookup not served")
        co._record(lat=((time.perf_counter() - t0) * 1e3,))
        if entry.error is not None:
            raise entry.error
        return self._filter_ns(entry.result, namespace)

    def lookup_batch(self, job_name: str, operator: str, keys,
                     namespace=None) -> List[Any]:
        """An explicit batch. Replica path: per-key cache probes, the
        misses coalesce onto the shard queues (riding other clients'
        batches); legacy path: one request batch on the control queue."""
        ad = self._adapter(job_name, operator)
        if ad is None:
            co = self._coalescer(job_name, operator)
            t0 = time.perf_counter()
            out = self._flush(job_name, operator, list(keys), namespace)
            co.note_batch(len(out), (time.perf_counter() - t0) * 1e3)
            return out
        from flink_tpu_torch.observe import flight_recorder as flight
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        t0 = time.perf_counter()
        co = self._coalescer(job_name, operator)
        keys = list(keys)
        # BATCH-FIRST: one vectorized hash, then ONE probe call for
        # the whole key batch — a single GIL-released C call on the
        # native plane (one locked pass on the Python fallback) —
        # before ANY per-key Python work; only misses compose below
        kids = hash_keys_to_i64(np.asarray(keys))
        out: List[Any] = [None] * len(keys)
        miss_idx: List[Tuple[int, int]] = []
        gen = ad.generation()
        if self._probe_faulted(job_name, operator):
            miss_idx = [(i, int(k)) for i, k in enumerate(kids)]
            hits = 0
        else:
            hits = self.hot_cache.get_many(job_name, operator, kids,
                                           gen, out, miss_idx,
                                           exact=False)
        if namespace is not None:
            for i in range(len(out)):
                if out[i] is not None:
                    out[i] = self._filter_ns(out[i], namespace)
        pending = [(i, self._enqueue_miss(job_name, operator, ad,
                                          keys[i], kid, namespace))
                   for i, kid in miss_idx]
        if hits:
            # one locked record + one sampled instant for the whole
            # batch's hits — per-key lock traffic at cache-hit QPS
            # would itself be the bottleneck
            co._record(n_lookups=hits)
            self._hit_sample += hits
            if self._hit_sample % 256 < hits:
                flight.instant("serving.cache_hit", job=job_name,
                               batch=gen)
        err: Optional[BaseException] = None
        # ONE deadline for the whole request (the legacy batch path's
        # bound): a fresh full timeout per rider would let a degraded
        # worker stretch one call to n_misses x timeout_s
        deadline = t0 + self.timeout_s
        for i, entry in pending:
            if not entry.done.wait(
                    max(deadline - time.perf_counter(), 0.0)):
                raise TimeoutError("queryable-state lookup not served")
            if entry.error is not None:
                err = entry.error
            else:
                out[i] = self._filter_ns(entry.result, namespace)
        co._record(lat=((time.perf_counter() - t0) * 1e3,))
        if err is not None:
            raise err
        return out

    def lookup_batch_packed(self, job_name: str, operator: str,
                            keys) -> PackedLookupResult:
        """The NATIVE SERVING FAST PATH: one vectorized key hash, ONE
        GIL-released C probe for the whole batch, and the hits never
        leave the packed buffers — :class:`PackedLookupResult`
        materializes a dict only for keys the caller actually reads
        (a frontend serializing from the packed form pays the
        interpreter nothing per hit). Misses coalesce onto the shard
        worker queues exactly like :meth:`lookup_batch`. Falls back to
        the (bit-identical) dict path when the operator has no replica
        adapter or no native table yet."""
        ad = self._adapter(job_name, operator)
        get_packed = getattr(self.hot_cache, "get_many_packed", None)
        if ad is None or get_packed is None:
            return PackedLookupResult.from_dicts(
                self.lookup_batch(job_name, operator, keys))
        from flink_tpu_torch.observe import flight_recorder as flight
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        t0 = time.perf_counter()
        co = self._coalescer(job_name, operator)
        keys = list(keys)
        n = len(keys)
        kids = hash_keys_to_i64(np.asarray(keys))
        out: List[Any] = [None] * n
        miss_idx: List[Tuple[int, int]] = []
        gen = ad.generation()
        if self._probe_faulted(job_name, operator):
            probe = None
            hits = 0
            miss_idx = [(i, int(k)) for i, k in enumerate(kids)]
        else:
            hits, probe = get_packed(job_name, operator, kids, gen,
                                     out, miss_idx, exact=False)
            if probe is None and not miss_idx:
                # no native table for the op yet (first touches, or a
                # non-packable shape): the dict path IS the fast path
                return PackedLookupResult.from_dicts(
                    self.lookup_batch(job_name, operator, keys))
        # overflow-store hits (rare: non-packable ops) were
        # materialized into `out` by the probe — carry them as
        # overrides (their packed hit flag is 0)
        overrides: Dict[int, Any] = {
            i: v for i, v in enumerate(out) if v is not None}
        pending = [(i, self._enqueue_miss(job_name, operator, ad,
                                          keys[i], kid, None))
                   for i, kid in miss_idx]
        if hits:
            co._record(n_lookups=hits)
            self._hit_sample += hits
            if self._hit_sample % 256 < hits:
                flight.instant("serving.cache_hit", job=job_name,
                               batch=gen)
        err: Optional[BaseException] = None
        deadline = t0 + self.timeout_s
        for i, entry in pending:
            if not entry.done.wait(
                    max(deadline - time.perf_counter(), 0.0)):
                raise TimeoutError("queryable-state lookup not served")
            if entry.error is not None:
                err = entry.error
            else:
                overrides[i] = entry.result
        co._record(lat=((time.perf_counter() - t0) * 1e3,))
        if err is not None:
            raise err
        return PackedLookupResult(n, probe, overrides)

    # ---------------------------------------------------------------- metrics

    def lookups_total(self) -> int:
        """One counter, one walk — what the per-scrape gauge reads."""
        return self._pool.lookups_total()

    def lookup_batches_total(self) -> int:
        return self._pool.batches_total()

    def lookup_p99_ms(self) -> float:
        """p99 over every coalescer's latency reservoir (pays one sort)."""
        return reservoir_p99_ms(self._pool.latencies())

    def replica_staleness_ms(self) -> float:
        """Worst-case age of any bound replica's sealed generation (ms
        since its boundary publish) — the serving SLO's staleness arm.
        Snapshots the adapter list first: sampler/scrape threads read
        while bind/unbind mutate the dict (iterating the live dict
        raises mid-mutation and would kill the sampler silently)."""
        return max((ad.plane.staleness_ms()
                    for ad in list(self._replicas.values())),
                   default=0.0)

    def hot_row_hit_rate(self) -> float:
        return self.hot_cache.hit_rate()

    def replica_generations(self) -> int:
        """Total sealed generations across bound replicas (a publish-vacuity
        gate reads this; snapshot — see staleness)."""
        return sum(ad.plane.generation()
                   for ad in list(self._replicas.values()))

    def replica_counters(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ad in list(self._replicas.values()):
            for k, v in ad.plane.counters().items():
                out[k] = out.get(k, 0) + v
        return out

    def frontend_stats(self) -> Dict[str, float]:
        """Aggregate per-frontend shm counters (probes / hits / torn
        retries / miss crossings), summed across frontend slots and
        tables straight off the shared arena headers — the frontends
        write them lock-free in their own processes; the owner reads
        them here with no IPC. Empty when the multi-process tier is
        not armed (no ``shm_dir``)."""
        if self.shm_dir is None:
            return {}
        fe_stats = getattr(self.hot_cache, "fe_stats", None)
        if fe_stats is None:
            return {}
        rows = fe_stats()
        return {f"frontend_{k}": float(sum(r[k] for r in rows))
                for k in (rows[0].keys() if rows else ())}

    def metrics(self) -> Dict[str, float]:
        out = self._pool.stats()
        out.update(self.hot_cache.stats())
        out.update(self.frontend_stats())
        out["replica_staleness_ms"] = self.replica_staleness_ms()
        out["replica_generations"] = float(self.replica_generations())
        return out
