"""Flight recorder (port of ``flink_tpu/observe/flight_recorder.py``):
always-on, bounded-overhead per-batch pipeline tracing.

A process-global recorder the hot paths write into unconditionally,
cheap enough to leave on. Its cost on the card is measured by phase
22(e) of ``chip_smoke.py``.

Design constraints, in order:

- **No allocation on the hot path.** Each thread owns preallocated
  parallel numpy arrays (a ring: drop-oldest by cursor wraparound) and
  a reusable stack of span context managers — recording one span is a
  handful of scalar stores, no objects, no locks (per-thread rings;
  the registry lock is taken once per thread lifetime).
- **Monotonic clock.** Spans time with ``time.perf_counter``; one
  ``(wall, perf)`` anchor pair taken at recorder creation maps records
  onto the wall clock for export.
- **Correlated attribution.** Every record carries ``(job, shard,
  batch_id, watermark)``. Call sites pass what they know; the rest is
  inherited from an ambient per-thread context (``set_job`` /
  ``set_batch`` / ``set_watermark``) so the executor names the job
  once, the engine names the batch once, and a harvest three layers
  down still lands attributed.
- **One timeline.** Durations (batch lifecycle, fires, harvests,
  checkpoints) and instants (watchdog deadline misses, armed chaos
  injections) interleave in the same ring.

Span kinds are a closed registry (:data:`flink_tpu_torch.observe.
KNOWN_SPAN_KINDS`, the reference's tuple whole): an unregistered kind
raises at the call site.

Two of those kinds are never recorded by the port: ``xla.compile`` and
``d2h.transfer``. The reference records them from ``jax.monitoring``'s
backend-compile events and a hook on ``ArrayImpl.__array__``
(``install_probes``). The port's device programs are eager torch ops and
hand-written kernels that are built once per process, and torch has no
hook on a device-to-host copy, so there is neither a compile to count
nor a transfer to hook; ``install_probes`` has no counterpart.

Usage::

    from flink_tpu_torch.observe import flight_recorder as flight

    flight.set_job("pipeline-a")
    with flight.span("batch.ingest", shard=-1, batch=seq):
        ...
    flight.instant("watchdog.miss", shard=3)

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
    instant: bool
    t0: float          # perf_counter seconds
    t1: float
    job: Optional[str]
    shard: int
    batch_id: int
    watermark: Optional[int]
    thread: str

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _SpanCtx:
    """Reusable span context manager (pooled per thread — entering a
    span allocates nothing once the pool is warm)."""

    __slots__ = ("_ring", "_kind", "_shard", "_batch", "_wm", "_job",
                 "_t0")

    def __init__(self, ring: "_ThreadRing") -> None:
        self._ring = ring

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        r = self._ring
        r.write(self._kind, 0, self._t0, time.perf_counter(),
                self._job, self._shard, self._batch, self._wm)
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
        self.job = np.full(cap, -1, dtype=np.int32)
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
        self.pool: List[_SpanCtx] = [_SpanCtx(self) for _ in range(8)]

    def write(self, kind_id: int, flags: int, t0: float, t1: float,
              job: int, shard: int, batch: int, wm: int) -> None:
        i = self.cursor & self.mask
        self.cursor += 1
        self.kind[i] = kind_id
        self.flags[i] = flags
        self.t0[i] = t0
        self.t1[i] = t1
        self.job[i] = job
        self.shard[i] = shard
        self.batch[i] = batch
        self.wm[i] = wm
        # counts aggregate for EVERY record (an operator reading
        # flight.chaos_inject_count must see armed injections);
        # durations only for spans — instants' quantiles stay 0
        self.k_count[kind_id] += 1
        if not flags:
            d = t1 - t0
            self.k_total[kind_id] += d
            if d > self.k_max[kind_id]:
                self.k_max[kind_id] = d
            self.k_res[kind_id, self.k_cursor[kind_id] % _RESERVOIR] = d
            self.k_cursor[kind_id] += 1


class FlightRecorder:
    """The process-global span plane (see module docstring). Normally
    used through the module-level :func:`span` / :func:`instant`;
    constructing private instances is for tests."""

    def __init__(self, kinds) -> None:
        self.kinds = tuple(kinds)
        self._kind_id = {k: i for i, k in enumerate(self.kinds)}
        if len(self._kind_id) != len(self.kinds):
            raise ValueError("duplicate span kinds")
        self._lock = threading.Lock()
        self._rings: List[_ThreadRing] = []
        self._tl = threading.local()
        self._jobs: List[str] = []
        self._job_id: Dict[str, int] = {}
        #: (wall, perf) anchor: wall = anchor[0] + (t - anchor[1])
        self.anchor = (time.time(), time.perf_counter())

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
             watermark: int = WM_NONE, job: Optional[str] = None):
        """Context manager timing one lifecycle section. Unspecified
        attribution falls back to the thread's ambient context."""
        if not _enabled:
            return _NULL_SPAN
        ring = self._ring()
        pool = ring.pool
        ctx = pool.pop() if pool else _SpanCtx(ring)
        ctx._kind = self._kind_id[kind]
        ctx._shard = shard
        ctx._batch = batch if batch >= 0 else ring.ctx_batch
        ctx._wm = watermark if watermark != WM_NONE else ring.ctx_wm
        ctx._job = self.job_id(job) if job is not None else ring.ctx_job
        return ctx

    def instant(self, kind: str, shard: int = -1, batch: int = -1,
                watermark: int = WM_NONE, job: Optional[str] = None,
                t0: Optional[float] = None,
                duration_s: float = 0.0) -> None:
        """Record an instant event (or a short externally-timed span,
        e.g. an XLA compile whose duration arrives via monitoring:
        pass ``duration_s`` and it lands as ``[now - d, now]``)."""
        if not _enabled:
            return
        ring = self._ring()
        now = time.perf_counter() if t0 is None else t0
        ring.write(
            self._kind_id[kind], 0 if duration_s > 0.0 else 1,
            now - duration_s, now,
            self.job_id(job) if job is not None else ring.ctx_job,
            shard,
            batch if batch >= 0 else ring.ctx_batch,
            watermark if watermark != WM_NONE else ring.ctx_wm)

    # ------------------------------------------------------ ambient context

    def job_id(self, name: str) -> int:
        # a double-checked fast path on the per-span hot path: entries are insert-only and the
        # slow path re-checks under the lock before assigning
        jid = self._job_id.get(name)
        if jid is None:
            with self._lock:
                jid = self._job_id.get(name)
                if jid is None:
                    jid = len(self._jobs)
                    self._jobs.append(name)
                    self._job_id[name] = jid
        return jid

    def set_job(self, name: Optional[str]) -> None:
        self._ring().ctx_job = -1 if name is None else self.job_id(name)

    def set_batch(self, batch_id: int) -> None:
        self._ring().ctx_batch = int(batch_id)

    def set_watermark(self, wm: int) -> None:
        self._ring().ctx_wm = int(wm)

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
            jobs = list(self._jobs)
        for ring in self._iter_rings():
            n = min(ring.cursor, ring.mask + 1)
            if n == 0:
                continue
            for i in range(n):
                jid = int(ring.job[i])
                wm = int(ring.wm[i])
                out.append(SpanRecord(
                    kind=self.kinds[int(ring.kind[i])],
                    instant=bool(ring.flags[i]),
                    t0=float(ring.t0[i]), t1=float(ring.t1[i]),
                    job=jobs[jid] if 0 <= jid < len(jobs) else None,
                    shard=int(ring.shard[i]),
                    batch_id=int(ring.batch[i]),
                    watermark=None if wm == WM_NONE else wm,
                    thread=ring.name))
        out.sort(key=lambda r: r.t0)
        return out

    def dropped(self) -> int:
        """Records overwritten by the drop-oldest policy so far."""
        return sum(max(0, r.cursor - (r.mask + 1))
                   for r in self._iter_rings())

    def kind_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-kind aggregates merged across threads: ``{kind: {count,
        total_s, max_s, p50_ms, p99_ms}}`` (quantiles over the bounded
        recent-window reservoirs; instants contribute counts only).
        Memoized on the rings' cursors: a metrics scrape reading many
        gauges pays ONE merge, not one per gauge."""
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
        and job interning — cheap, called between bench reps)."""
        # cursors reset below, and a later refill can land on the same
        # cursor tuple a cached merge was keyed on — drop it explicitly
        self._kt_cache = None
        for ring in self._iter_rings():
            ring.cursor = 0
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
                from flink_tpu_torch.observe import KNOWN_SPAN_KINDS

                _recorder = FlightRecorder(KNOWN_SPAN_KINDS)
    return _recorder


def span(kind: str, shard: int = -1, batch: int = -1,
         watermark: int = WM_NONE, job: Optional[str] = None):
    if not _enabled:
        return _NULL_SPAN
    return recorder().span(kind, shard=shard, batch=batch,
                           watermark=watermark, job=job)


def instant(kind: str, shard: int = -1, batch: int = -1,
            watermark: int = WM_NONE, job: Optional[str] = None,
            t0: Optional[float] = None, duration_s: float = 0.0) -> None:
    if not _enabled:
        return
    recorder().instant(kind, shard=shard, batch=batch,
                       watermark=watermark, job=job, t0=t0,
                       duration_s=duration_s)


def set_job(name: Optional[str]) -> None:
    if _enabled:
        recorder().set_job(name)


def set_batch(batch_id: int) -> None:
    if _enabled:
        recorder().set_batch(batch_id)


def set_watermark(wm: int) -> None:
    if _enabled:
        recorder().set_watermark(wm)


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
