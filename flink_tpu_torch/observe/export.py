"""Flight-recorder exporters: Perfetto traces, Prometheus histograms,
event-time latency markers.

Three consumers of the one span plane (:mod:`flink_tpu_torch.observe.
flight_recorder`), so the attribution the recorder captures is also
what every surface shows — the bench breakdowns, the dashboard and a
Perfetto timeline can never disagree about where the time went:

- :func:`chrome_trace` / :func:`write_chrome_trace` — the Chrome trace
  event JSON format (load the file at https://ui.perfetto.dev or
  chrome://tracing). One *pid* per job, one *tid* per shard (shard -1
  lands on the per-thread "host" track), durations as complete
  (``ph=X``) events, compiles/misses/injections as instants on the
  same clock.
- :func:`register_flight_metrics` — per-span-kind duration aggregates
  (count / total ms / p50 / p99) as gauges on a ``flight`` metric
  group, rendered by the existing PrometheusReporter.
- :class:`LatencyMarkerPlane` — the Flink LatencyMarker shape for the
  micro-batch design: each source batch is the marker (stamped with
  its ingest wall time), every operator it flows through records
  ``now - marker`` into a per-operator histogram, and per-operator
  watermark-lag gauges report how far each operator's event-time
  frontier trails the sources'.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from flink_tpu_torch.observe.flight_recorder import FlightRecorder, SpanRecord

#: first tid of the per-thread host tracks (shard-less spans; shard
#: spans use tid = shard + 1, well below this)
HOST_TID_BASE = 1000


def _sanitize(kind: str) -> str:
    return kind.replace(".", "_")


def chrome_trace(records: List[SpanRecord],
                 anchor=None) -> Dict[str, Any]:
    """Encode decoded records as a Chrome trace event object
    (``{"traceEvents": [...]}``, ts/dur in microseconds). ``anchor`` —
    the recorder's ``(wall, perf)`` pair; when given, timestamps are
    wall-clock microseconds (Perfetto shows real times), else they are
    relative to the earliest record."""
    events: List[Dict[str, Any]] = []
    if anchor is not None:
        wall0, perf0 = anchor
        base = perf0 - wall0  # t_us = (t - base) * 1e6
    else:
        base = min((r.t0 for r in records), default=0.0)
    jobs: Dict[Optional[str], int] = {}
    host_tids: Dict[str, int] = {}
    seen_tids = {}
    for r in records:
        pid = jobs.setdefault(r.job, len(jobs) + 1)
        if r.shard >= 0:
            tid = r.shard + 1
            seen_tids[(pid, tid)] = f"shard-{r.shard}"
        else:
            # shard-less spans get one HOST track PER THREAD: two
            # concurrent threads (task loop vs a serving client) must
            # not interleave complete events on one track — Perfetto
            # would render bogus nesting
            tid = host_tids.setdefault(
                r.thread, HOST_TID_BASE + len(host_tids))
            seen_tids[(pid, tid)] = f"host:{r.thread}"
        args: Dict[str, Any] = {"batch": r.batch_id, "thread": r.thread}
        if r.watermark is not None:
            args["watermark"] = r.watermark
        if r.shard >= 0:
            args["shard"] = r.shard
        ev: Dict[str, Any] = {
            "name": r.kind,
            "cat": r.kind.split(".", 1)[0],
            "pid": pid,
            "tid": tid,
            "ts": round((r.t0 - base) * 1e6, 3),
            "args": args,
        }
        if r.instant:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant marker
        else:
            ev["ph"] = "X"
            ev["dur"] = round((r.t1 - r.t0) * 1e6, 3)
        events.append(ev)
    for job, pid in jobs.items():
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": job or "(unattributed)"}})
    for (pid, tid), name in sorted(seen_tids.items()):
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       rec: Optional[FlightRecorder] = None) -> int:
    """Dump the recorder's current rings as a Perfetto-loadable JSON
    file; returns the number of events written."""
    from flink_tpu_torch.observe.flight_recorder import recorder

    rec = rec or recorder()
    trace = chrome_trace(rec.snapshot(), anchor=rec.anchor)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])


def validate_trace_schema(trace: Dict[str, Any],
                          known_kinds) -> List[str]:
    """Schema check the trace smoke gates on: every duration/instant
    event's name is a registered span kind, batch-lifecycle events
    carry batch attribution, and fire events carry watermark
    attribution. Returns a list of violations (empty = valid)."""
    known = set(known_kinds)
    problems: List[str] = []
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M":
            continue
        name = ev.get("name")
        if name not in known:
            problems.append(f"unregistered span kind {name!r}")
            continue
        args = ev.get("args", {})
        if name == "batch.ingest" and args.get("batch", -1) < 0:
            problems.append("batch.ingest without batch attribution")
        if name == "fire.dispatch" and "watermark" not in args:
            problems.append("fire.dispatch without watermark")
        if ph == "X" and ev.get("dur", 0) < 0:
            problems.append(f"negative duration on {name!r}")
    return problems


def span_rollup(kind_totals: Dict[str, Dict[str, float]],
                wall_s: float,
                buckets: Dict[str, Any]) -> Dict[str, float]:
    """Sum per-kind span totals into named wall-time buckets — THE
    bench drivers' rollup primitive. ``buckets`` maps an output field
    to one span kind or a sequence of kinds; absent kinds contribute
    0.0 (a driver may name kinds its engine doesn't emit yet). Always
    appends ``total_s`` (the measured wall clock) so every driver's
    breakdown dict carries the same denominator. Buckets may overlap
    (a kind can appear in several) and are not guaranteed to sum to
    ``total_s`` — they attribute, they don't partition."""

    def total(kind: str) -> float:
        return kind_totals.get(kind, {}).get("total_s", 0.0)

    out: Dict[str, float] = {}
    for name, kinds in buckets.items():
        if isinstance(kinds, str):
            kinds = (kinds,)
        out[name] = round(sum(total(k) for k in kinds), 3)
    out["total_s"] = round(wall_s, 3)
    return out


def breakdown_from_kind_totals(kind_totals: Dict[str, Dict[str, float]],
                               wall_s: float) -> Dict[str, float]:
    """The canonical host-prep / device / harvest wall-time breakdown,
    derived from flight-recorder span aggregates — the bench drivers
    report THIS dict, so their gates and a captured trace read the same
    numbers from the same spans by construction.

    ``host_prep_s`` approximates genuine host work on the ingest path:
    ``batch.ingest`` total minus ALL inline device interactions
    (``device.dispatch``) and fence blocks (``device.fence_wait``).
    The subtraction uses the process totals, and some device spans
    open on the FIRE path (cold-page reloads, eviction gathers), so
    host prep can be slightly UNDER-stated at spill-heavy shapes —
    the same approximation the pre-recorder engine counters
    (``device_inline_s`` accumulated on both paths, subtracted from
    an ingest-only timer) made, so gate budgets calibrated against
    them carry over unchanged. ``device_step_s`` is the device spans
    plus the fire dispatches; ``harvest_s`` is ALL D2H
    materializations (``fire.harvest``), including ones nested inside
    device interactions or synchronous fires — buckets may overlap
    and are not guaranteed to sum to ``total_s``."""

    def total(kind: str) -> float:
        return kind_totals.get(kind, {}).get("total_s", 0.0)

    host_prep = max(total("batch.ingest") - total("device.dispatch")
                    - total("device.fence_wait"), 0.0)
    out = {"host_prep_s": round(host_prep, 3)}
    out.update(span_rollup(kind_totals, wall_s, {
        "meta_sweep_s": "prep.meta_sweep",
        "stage_s": "prep.stage",
        "device_step_s": ("fire.dispatch", "device.dispatch",
                          "device.fence_wait"),
        "harvest_s": "fire.harvest",
        "device_in_prep_s": ("device.dispatch", "device.fence_wait"),
    }))
    out["host_prep_fraction"] = round(host_prep / wall_s, 4) \
        if wall_s > 0 else 0.0
    return out


def register_flight_metrics(group,
                            rec: Optional[FlightRecorder] = None):
    """Per-span-kind duration aggregates as gauges under
    ``<scope>.flight`` (count / total_ms / p50_ms / p99_ms per kind,
    names Prometheus-safe). Suppliers read the recorder's merged
    per-thread aggregates at scrape time — nothing is added to the
    hot path, and ``kind_totals`` is memoized so a scrape of all the
    gauges pays one merge. The aggregates are PROCESS-GLOBAL (the
    recorder is shared by every job in the process): register them at
    a registry root or cluster scope, not under one job's — per-job
    attribution lives on the records themselves (trace export), not
    in these rollups."""
    from flink_tpu_torch.observe.flight_recorder import recorder

    rec = rec or recorder()
    fg = group.add_group("flight")

    def _stat(kind: str, field: str):
        def read() -> float:
            return rec.kind_totals().get(kind, {}).get(field, 0.0)

        return read

    for kind in rec.kinds:
        base = _sanitize(kind)
        fg.gauge(f"{base}_count", _stat(kind, "count"))
        fg.gauge(f"{base}_total_s", _stat(kind, "total_s"))
        fg.gauge(f"{base}_p50_ms", _stat(kind, "p50_ms"))
        fg.gauge(f"{base}_p99_ms", _stat(kind, "p99_ms"))
    fg.gauge("records_dropped", lambda: rec.dropped())
    return fg


class LatencyMarkerPlane:
    """Per-operator event-time latency markers (the Flink LatencyMarker
    shape, re-designed for micro-batches).

    The reference injects LatencyMarker records at sources (stamped
    with wall time) and each operator reports ``now - marker`` — here
    the *source batch* is the marker: :meth:`stamp_source` notes the
    wall instant a batch left its source, and :meth:`observe` (called
    by the executor after each operator's hooks ran on the depth-first
    push of that batch) records the elapsed wall time into the
    operator's ``markerLatencyMs`` histogram. Watermark lag is the
    event-time counterpart: per operator, how far its combined input
    watermark trails the sources' frontier (held-back watermarks from
    in-flight async fires surface here first)."""

    def __init__(self) -> None:
        self._hists: Dict[str, Any] = {}
        self._marker_t0 = 0.0
        #: a marker is LIVE only during the depth-first push of the
        #: source batch that stamped it — operator work that runs
        #: outside it (async-fire drains, the end-of-source flush,
        #: restored-window fires) carries no marker and records no
        #: sample, instead of charging the drain interval to the last
        #: batch (or perf_counter's whole epoch on a restore-only run)
        self._marker_live = False
        #: per-source emitted watermarks; the job frontier is their
        #: MIN — operators combine inputs with min (WatermarkValve),
        #: so a max here would report steady inter-source skew as
        #: permanent operator lag
        self._source_wms: Dict[Any, int] = {}

    def operator_group(self, group, name: str, input_watermark_fn):
        """Register one operator's latency surface under
        ``<scope>.latency``: the marker histogram + the watermark-lag
        gauge. Returns the histogram (the executor holds it)."""
        lg = group.add_group("latency")
        hist = lg.histogram("markerLatencyMs", reservoir_size=2048)
        self._hists[name] = hist

        def lag() -> float:
            src = self.source_watermark
            wm = input_watermark_fn()
            if src is None or wm is None or wm < -(1 << 60):
                # the operator has not seen a watermark yet (valve at
                # its negative sentinel) — no meaningful lag to report
                return 0.0
            return float(max(src - wm, 0))

        lg.gauge("watermarkLagMs", lag)
        return hist

    def stamp_source(self) -> None:
        """A source batch enters the dataflow NOW — it is the marker."""
        self._marker_t0 = time.perf_counter()
        self._marker_live = True

    def end_marker(self) -> None:
        """The stamped batch's synchronous push finished — work after
        this point (drains, flushes) is not that batch's latency."""
        self._marker_live = False

    def note_source_watermark(self, wm: int, source=None) -> None:
        prev = self._source_wms.get(source)
        if prev is None or wm > prev:
            self._source_wms[source] = int(wm)

    @property
    def source_watermark(self) -> Optional[int]:
        """The sources' combined frontier: MIN over every source that
        has emitted a watermark (matching the valves' min-combine)."""
        return min(self._source_wms.values()) \
            if self._source_wms else None

    def observe(self, hist) -> None:
        """One operator finished its hooks for the marked batch (no-op
        when no marker is live)."""
        if self._marker_live:
            hist.update((time.perf_counter() - self._marker_t0) * 1e3)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: h.snapshot() for name, h in self._hists.items()}
