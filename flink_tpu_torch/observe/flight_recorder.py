"""Flight recorder (port of ``flink_tpu/observe/flight_recorder.py``):
always-on, bounded-overhead per-batch pipeline tracing.

A process-global recorder the hot paths write into unconditionally,
cheap enough to leave on. Its cost on the card is measured by phase
22(e) of ``chip_smoke.py`` and in ``PERF.md``.

Design constraints, in order:

- **No allocation on the hot path.** Each thread owns preallocated
  parallel numpy arrays (a ring: drop-oldest by cursor wraparound) and
  a reusable stack of span context managers — recording one span is a
  handful of scalar stores, no objects, no locks (per-thread rings;
  the registry lock is taken once per thread lifetime).
- **One clock.** Every record's ``t0`` and ``t1`` are
  ``time.perf_counter`` seconds (:func:`clock`), the clock another
  thread stamps a wait record's start with; one ``(wall, perf)`` anchor
  pair taken at recorder creation maps records onto the wall clock for
  export.
- **Correlated attribution.** Every record carries ``(job, shard,
  batch_id, watermark)``. Call sites pass what they know; the rest is
  inherited from an ambient per-thread context (``set_job`` /
  ``set_batch`` / ``set_watermark``) so the executor names the job
  once, the engine names the batch once, and a harvest three layers
  down still lands attributed. The executor's operator spans also
  carry the operator (``op``: the node's ``<name>#<uid>``, its metric
  scope), interned once per node like the job (:func:`intern`).
- **One timeline.** Three forms of record interleave in the same ring:

  - *spans* (:func:`span`): a thread's work, ``[enter, exit]``. A span
    of a kind in :data:`~flink_tpu_torch.observe.CPU_TIMED_KINDS` also
    holds the thread CPU seconds spent inside (``cpu_s``, from
    ``time.thread_time``): wall minus CPU is the time the thread was not
    running (waiting on the GIL, a lock, the device, or descheduled).
    The thread CPU clock is a system call, on some hosts a dear one with
    a long tail, so a thread reads it for at most one span in
    :data:`CPU_EVERY_S` seconds; ``cpu_s`` is None where it was not
    read (other kinds, spans between readings, and
    ``instant(..., duration_s=d)``, an externally timed span).
  - *instants* (:func:`instant`): watchdog deadline misses, armed chaos
    injections; ``instant`` is true, no duration.
  - *wait records* (:func:`waited`): an interval in which no thread
    worked on the thing the kind names — a source batch between the
    pump's put and the task loop's take (``source.queue``), a
    dispatched fire between its dispatch and its harvest
    (``fire.pending``). Their start may be stamped on another thread
    (with :func:`clock`). They read ``instant=True`` and
    ``waited=True``, so readers that skip instants (they attribute a
    thread's time to its innermost span) skip them, and they count in
    :meth:`FlightRecorder.kind_totals`' durations and quantiles like
    spans; their ``cpu_s`` is 0, as an instant's.

Span kinds are a closed registry (:data:`flink_tpu_torch.observe.
KNOWN_SPAN_KINDS`): an unregistered kind raises at the call site.

Usage::

    from flink_tpu_torch.observe import flight_recorder as flight

    flight.set_job("pipeline-a")
    with flight.span("batch.ingest", shard=-1, batch=seq):
        ...
    flight.instant("watchdog.miss", shard=3)
    put_at = flight.clock()          # on the producing thread
    flight.waited("source.queue", put_at)   # on the consuming one

Disable with ``FLINK_TPU_FLIGHT_RECORDER=0`` (read at import; spans
become no-ops that cost one module-global check), or per-region with
:func:`disabled`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np

#: sentinel for "no watermark attribution" (int64 min would render as
#: a plausible timestamp; this is unmistakably absent)
WM_NONE = -(1 << 62)

#: the recorder's one clock (seconds): every record's t0 and t1
clock = time.perf_counter
_cpu_clock = time.thread_time
#: a thread reads its CPU clock for at most one CPU-timed span a period
#: (s): all of a host-bound batch's, about one in ten of a 2 ms one
CPU_EVERY_S = 0.05
_NO_CPU = float("nan")

#: record flags: a span is 0; an instant sets INSTANT; a wait record
#: sets INSTANT and WAITED (readers that skip instants skip it)
INSTANT = 1
WAITED = 2
_WAIT_FLAGS = INSTANT | WAITED

#: per-thread ring capacity (records); power of two so the drop-oldest
#: wraparound is a mask, not a modulo
_CAPACITY = 1 << int(os.environ.get(
    "FLINK_TPU_FLIGHT_RECORDER_CAPACITY_POW2", "16"))
#: per-kind duration reservoir depth (overwritten modulo — a cheap
#: recent-window sample, not a full history)
_RESERVOIR = 256

_enabled = os.environ.get("FLINK_TPU_FLIGHT_RECORDER", "1") != "0"


class SpanRecord(NamedTuple):
    """One decoded record (``snapshot()`` output)."""

    kind: str
    instant: bool      # true for instants and wait records
    t0: float          # perf_counter seconds
    t1: float
    job: Optional[str]
    shard: int
    batch_id: int
    watermark: Optional[int]
    thread: str
    op: Optional[str] = None     # the operator, ``<name>#<uid>``
    cpu_s: Optional[float] = None  # thread CPU seconds (None: not read)
    waited: bool = False         # a wait record

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _SpanCtx:
    """Reusable span context manager (pooled per thread — entering a
    span allocates nothing once the pool is warm)."""

    __slots__ = ("_ring", "_kind", "_shard", "_batch", "_wm", "_job",
                 "_op", "_cpu", "_t0", "_c0")

    def __init__(self, ring: "_ThreadRing") -> None:
        self._ring = ring

    def __enter__(self) -> "_SpanCtx":
        # the CPU interval lies inside the wall one
        self._t0 = t0 = clock()
        if self._cpu:
            ring = self._ring
            if t0 >= ring.cpu_next:
                ring.cpu_next = t0 + CPU_EVERY_S
                self._c0 = _cpu_clock()
            else:
                self._cpu = False
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        cpu = _cpu_clock() - self._c0 if self._cpu else _NO_CPU
        r = self._ring
        r.write(self._kind, 0, self._t0, clock(), self._job, self._shard,
                self._batch, self._wm, self._op, cpu)
        r.pool.append(self)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class _ThreadRing:
    """One thread's preallocated record ring + per-kind aggregates +
    span-context pool. Single-writer (the owning thread); snapshot
    readers copy the arrays, which is safe because writes are
    monotonic scalar stores and a torn read costs at most one
    half-written record at the cursor."""

    def __init__(self, n_kinds: int, name: str) -> None:
        self.name = name
        cap = _CAPACITY
        self.mask = cap - 1
        self.cursor = 0
        self.kind = np.zeros(cap, dtype=np.int16)
        self.flags = np.zeros(cap, dtype=np.int8)
        self.t0 = np.zeros(cap, dtype=np.float64)
        self.t1 = np.zeros(cap, dtype=np.float64)
        self.cpu = np.zeros(cap, dtype=np.float64)
        self.job = np.full(cap, -1, dtype=np.int32)
        self.op = np.full(cap, -1, dtype=np.int32)
        self.shard = np.full(cap, -1, dtype=np.int32)
        self.batch = np.full(cap, -1, dtype=np.int64)
        self.wm = np.full(cap, WM_NONE, dtype=np.int64)
        # per-kind duration aggregates (merged across threads on read)
        self.k_count = np.zeros(n_kinds, dtype=np.int64)
        self.k_total = np.zeros(n_kinds, dtype=np.float64)
        self.k_max = np.zeros(n_kinds, dtype=np.float64)
        self.k_res = np.zeros((n_kinds, _RESERVOIR), dtype=np.float32)
        self.k_cursor = np.zeros(n_kinds, dtype=np.int64)
        # ambient attribution context (set by the layer that knows)
        self.ctx_job = -1
        self.ctx_batch = -1
        self.ctx_wm = WM_NONE
        #: the recorder's clock at which the thread next reads its CPU
        #: clock for a span
        self.cpu_next = 0.0
        self.pool: List[_SpanCtx] = [_SpanCtx(self) for _ in range(8)]

    def write(self, kind_id: int, flags: int, t0: float, t1: float,
              job: int, shard: int, batch: int, wm: int, op: int = -1,
              cpu: float = _NO_CPU) -> None:
        i = self.cursor & self.mask
        self.cursor += 1
        self.kind[i] = kind_id
        self.flags[i] = flags
        self.t0[i] = t0
        self.t1[i] = t1
        self.cpu[i] = cpu
        self.job[i] = job
        self.op[i] = op
        self.shard[i] = shard
        self.batch[i] = batch
        self.wm[i] = wm
        # counts aggregate for EVERY record (an operator reading
        # flight.chaos_inject_count must see armed injections);
        # durations for spans and wait records — instants' stay 0
        self.k_count[kind_id] += 1
        if flags != INSTANT:
            d = t1 - t0
            self.k_total[kind_id] += d
            if d > self.k_max[kind_id]:
                self.k_max[kind_id] = d
            self.k_res[kind_id, self.k_cursor[kind_id] % _RESERVOIR] = d
            self.k_cursor[kind_id] += 1


class FlightRecorder:
    """The process-global span plane (see module docstring). Normally
    used through the module-level :func:`span` / :func:`instant` /
    :func:`waited`; constructing private instances is for tests."""

    def __init__(self, kinds, cpu_kinds=()) -> None:
        self.kinds = tuple(kinds)
        self._kind_id = {k: i for i, k in enumerate(self.kinds)}
        if len(self._kind_id) != len(self.kinds):
            raise ValueError("duplicate span kinds")
        #: per kind id: its spans read the thread CPU clock
        self._cpu_kind = tuple(k in cpu_kinds for k in self.kinds)
        self._lock = threading.Lock()
        self._rings: List[_ThreadRing] = []
        self._tl = threading.local()
        #: interned names (jobs and operators share the table)
        self._names: List[str] = []
        self._name_id: Dict[str, int] = {}
        #: (wall, perf) anchor for export only: wall = anchor[0] +
        #: (t - anchor[1])
        self.anchor = (time.time(), clock())

    # ------------------------------------------------------------ hot path

    def _ring(self) -> _ThreadRing:
        ring = getattr(self._tl, "ring", None)
        if ring is None:
            ring = _ThreadRing(len(self.kinds),
                               threading.current_thread().name)
            with self._lock:
                self._rings.append(ring)
            self._tl.ring = ring
        return ring

    def span(self, kind: str, shard: int = -1, batch: int = -1,
             watermark: int = WM_NONE, job: Optional[str] = None,
             op: int = -1):
        """Context manager timing one lifecycle section (wall, and thread
        CPU for the recorder's CPU-timed kinds). Unspecified attribution
        falls back to the thread's ambient context; ``op`` is an
        :meth:`intern` id."""
        if not _enabled:
            return _NULL_SPAN
        ring = self._ring()
        pool = ring.pool
        ctx = pool.pop() if pool else _SpanCtx(ring)
        ctx._kind = kid = self._kind_id[kind]
        ctx._cpu = self._cpu_kind[kid]
        ctx._shard = shard
        ctx._batch = batch if batch >= 0 else ring.ctx_batch
        ctx._wm = watermark if watermark != WM_NONE else ring.ctx_wm
        ctx._job = self.intern(job) if job is not None else ring.ctx_job
        ctx._op = op
        return ctx

    def instant(self, kind: str, shard: int = -1, batch: int = -1,
                watermark: int = WM_NONE, job: Optional[str] = None,
                t0: Optional[float] = None,
                duration_s: float = 0.0) -> None:
        """Record an instant event (or a short externally-timed span:
        pass ``duration_s`` and it lands as ``[now - d, now]``)."""
        if not _enabled:
            return
        ring = self._ring()
        now = clock() if t0 is None else t0
        timed = duration_s > 0.0
        ring.write(
            self._kind_id[kind], 0 if timed else INSTANT,
            now - duration_s, now,
            self.intern(job) if job is not None else ring.ctx_job,
            shard,
            batch if batch >= 0 else ring.ctx_batch,
            watermark if watermark != WM_NONE else ring.ctx_wm,
            cpu=_NO_CPU if timed else 0.0)

    def waited(self, kind: str, t0: float, t1: Optional[float] = None,
               shard: int = -1, batch: int = -1,
               watermark: int = WM_NONE, job: Optional[str] = None) -> None:
        """Record a wait record ``[t0, t1]`` (``t1`` now by default):
        time in which the thing ``kind`` names waited and no thread
        worked on it. ``t0`` is from :func:`clock`, stamped on any
        thread."""
        if not _enabled:
            return
        ring = self._ring()
        ring.write(
            self._kind_id[kind], _WAIT_FLAGS, t0,
            clock() if t1 is None else t1,
            self.intern(job) if job is not None else ring.ctx_job,
            shard,
            batch if batch >= 0 else ring.ctx_batch,
            watermark if watermark != WM_NONE else ring.ctx_wm, cpu=0.0)

    # ------------------------------------------------------ ambient context

    def intern(self, name: str) -> int:
        """The id of a job or operator name (the same name, the same
        id). Callers on a hot path intern once and keep the id."""
        # a double-checked fast path: entries are insert-only and the
        # slow path re-checks under the lock before assigning
        nid = self._name_id.get(name)
        if nid is None:
            with self._lock:
                nid = self._name_id.get(name)
                if nid is None:
                    nid = len(self._names)
                    self._names.append(name)
                    self._name_id[name] = nid
        return nid

    def set_job(self, name: Optional[str]) -> None:
        self._ring().ctx_job = -1 if name is None else self.intern(name)

    def set_batch(self, batch_id: int) -> None:
        self._ring().ctx_batch = int(batch_id)

    def set_watermark(self, wm: int) -> None:
        self._ring().ctx_wm = int(wm)

    def watermark(self) -> int:
        """The thread's ambient watermark (``WM_NONE`` when unset)."""
        return self._ring().ctx_wm

    # ------------------------------------------------------------- reading

    def _iter_rings(self) -> Iterator[_ThreadRing]:
        with self._lock:
            rings = list(self._rings)
        return iter(rings)

    def snapshot(self) -> List[SpanRecord]:
        """Decode every thread's ring, merged and sorted by start time.
        Half-open rings decode their written prefix; full rings decode
        all records (oldest first is not guaranteed across the wrap —
        the sort restores global time order)."""
        out: List[SpanRecord] = []
        with self._lock:
            names = list(self._names)

        def name(i: int) -> Optional[str]:
            return names[i] if 0 <= i < len(names) else None

        for ring in self._iter_rings():
            n = min(ring.cursor, ring.mask + 1)
            if n == 0:
                continue
            cols = zip(*(a[:n].tolist() for a in (
                ring.kind, ring.flags, ring.t0, ring.t1, ring.job,
                ring.shard, ring.batch, ring.wm, ring.op, ring.cpu)))
            for kind, flags, t0, t1, jid, shard, batch, wm, oid, cpu in cols:
                out.append(SpanRecord(
                    kind=self.kinds[kind],
                    instant=bool(flags & INSTANT),
                    t0=t0, t1=t1, job=name(jid), shard=shard,
                    batch_id=batch,
                    watermark=None if wm == WM_NONE else wm,
                    thread=ring.name, op=name(oid),
                    cpu_s=None if cpu != cpu else cpu,
                    waited=bool(flags & WAITED)))
        out.sort(key=lambda r: r.t0)
        return out

    def dropped(self) -> int:
        """Records overwritten by the drop-oldest policy so far."""
        return sum(max(0, r.cursor - (r.mask + 1))
                   for r in self._iter_rings())

    def kind_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-kind aggregates merged across threads: ``{kind: {count,
        total_s, max_s, p50_ms, p99_ms}}`` (quantiles over the bounded
        recent-window reservoirs; spans and wait records contribute
        durations, instants counts only). Memoized on the rings'
        cursors: a metrics scrape reading many gauges pays ONE merge,
        not one per gauge."""
        from flink_tpu_torch.metrics.core import quantile_sorted

        version = tuple(r.cursor for r in self._iter_rings())
        cached = getattr(self, "_kt_cache", None)
        if cached is not None and cached[0] == version:
            return cached[1]
        n = len(self.kinds)
        count = np.zeros(n, dtype=np.int64)
        total = np.zeros(n, dtype=np.float64)
        kmax = np.zeros(n, dtype=np.float64)
        samples: List[List[float]] = [[] for _ in range(n)]
        for ring in self._iter_rings():
            count += ring.k_count
            total += ring.k_total
            kmax = np.maximum(kmax, ring.k_max)
            for k in range(n):
                m = int(min(ring.k_cursor[k], _RESERVOIR))
                if m:
                    samples[k].extend(ring.k_res[k, :m].tolist())
        out: Dict[str, Dict[str, float]] = {}
        for k, kind in enumerate(self.kinds):
            if not count[k]:
                continue
            data = sorted(samples[k])
            out[kind] = {
                "count": int(count[k]),
                "total_s": float(total[k]),
                "max_s": float(kmax[k]),
                "p50_ms": quantile_sorted(data, 0.5) * 1e3,
                "p99_ms": quantile_sorted(data, 0.99) * 1e3,
            }
        self._kt_cache = (version, out)
        return out

    def clear(self) -> None:
        """Reset every ring and aggregate (keeps thread registrations
        and name interning — cheap, called between bench reps)."""
        # cursors reset below, and a later refill can land on the same
        # cursor tuple a cached merge was keyed on — drop it explicitly
        self._kt_cache = None
        for ring in self._iter_rings():
            ring.cursor = 0
            ring.cpu_next = 0.0
            ring.k_count[:] = 0
            ring.k_total[:] = 0.0
            ring.k_max[:] = 0.0
            ring.k_cursor[:] = 0


# ------------------------------------------------------------- module API

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-global recorder (created on first use)."""
    global _recorder
    # double-checked publish of an immutable singleton slot; the slow
    # path re-checks under the lock
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                from flink_tpu_torch.observe import (
                    CPU_TIMED_KINDS,
                    KNOWN_SPAN_KINDS,
                )

                _recorder = FlightRecorder(KNOWN_SPAN_KINDS,
                                           CPU_TIMED_KINDS)
    return _recorder


def span(kind: str, shard: int = -1, batch: int = -1,
         watermark: int = WM_NONE, job: Optional[str] = None,
         op: int = -1):
    if not _enabled:
        return _NULL_SPAN
    return recorder().span(kind, shard=shard, batch=batch,
                           watermark=watermark, job=job, op=op)


def instant(kind: str, shard: int = -1, batch: int = -1,
            watermark: int = WM_NONE, job: Optional[str] = None,
            t0: Optional[float] = None, duration_s: float = 0.0) -> None:
    if not _enabled:
        return
    recorder().instant(kind, shard=shard, batch=batch,
                       watermark=watermark, job=job, t0=t0,
                       duration_s=duration_s)


def waited(kind: str, t0: float, t1: Optional[float] = None,
           shard: int = -1, batch: int = -1, watermark: int = WM_NONE,
           job: Optional[str] = None) -> None:
    if not _enabled:
        return
    recorder().waited(kind, t0, t1, shard=shard, batch=batch,
                      watermark=watermark, job=job)


def intern(name: str) -> int:
    """The recorder's id of an operator (or job) name, -1 when off."""
    return recorder().intern(name) if _enabled else -1


def set_job(name: Optional[str]) -> None:
    if _enabled:
        recorder().set_job(name)


def set_batch(batch_id: int) -> None:
    if _enabled:
        recorder().set_batch(batch_id)


def set_watermark(wm: int) -> None:
    if _enabled:
        recorder().set_watermark(wm)


def current_watermark() -> int:
    """The thread's ambient watermark: that of the fire being
    dispatched inside :func:`fire_span` (``WM_NONE`` when off)."""
    return recorder().watermark() if _enabled else WM_NONE


def ingest_span(seq: int):
    """THE ingest-span contract, in one place for every engine base
    (mesh window/session, joins): name the batch in the ambient
    context, then open ``batch.ingest`` carrying it."""
    set_batch(seq)
    return span("batch.ingest", batch=seq)


def fire_span(watermark: int):
    """THE fire-span contract: note the watermark in the ambient
    context, then open ``fire.dispatch`` carrying it."""
    set_watermark(int(watermark))
    return span("fire.dispatch", watermark=int(watermark))


def enabled() -> bool:
    return _enabled


class disabled:
    """Context manager suppressing recording (an A/B lever for its cost;
    also usable to exclude a noisy region)."""

    def __enter__(self):
        global _enabled
        self._prev = _enabled
        _enabled = False
        return self

    def __exit__(self, *exc):
        global _enabled
        _enabled = self._prev
        return None
