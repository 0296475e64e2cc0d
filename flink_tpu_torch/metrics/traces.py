"""Structured trace spans for checkpoint/recovery/job-lifecycle durations.

reference: flink-metrics/flink-metrics-core/.../traces/Span.java +
SpanBuilder; reported via TraceReporter (slf4j or OpenTelemetry,
flink-metrics-otel/.../OpenTelemetryTraceReporter.java). The reference emits
spans for checkpointing and recovery durations (SURVEY.md §5).

Re-design: a thread-safe in-process collector; spans are plain records.
An OTel exporter can be attached where the package is available (not baked
into this image — gated import).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    scope: str
    name: str
    start_ts_ms: float
    end_ts_ms: float
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return self.end_ts_ms - self.start_ts_ms


class SpanBuilder:
    def __init__(self, collector: "TraceCollector", scope: str, name: str):
        self._collector = collector
        self._scope = scope
        self._name = name
        self._attributes: Dict[str, Any] = {}
        self._start: Optional[float] = None

    def set_attribute(self, key: str, value) -> "SpanBuilder":
        self._attributes[key] = value
        return self

    def __enter__(self) -> "SpanBuilder":
        self._start = time.time() * 1000
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = time.time() * 1000
        if exc_type is not None:
            self._attributes["error"] = repr(exc)
        self._collector.add(Span(self._scope, self._name, self._start, end,
                                 dict(self._attributes)))


#: process-default collector: control-plane paths that are not owned by
#: one job's executor (sharded checkpoint storage, the partial-failover
#: protocol) report their restore/replay durations here so they are
#: observable even when no per-job collector was threaded through
_DEFAULT: Optional["TraceCollector"] = None


def default_collector() -> "TraceCollector":
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = TraceCollector()
    return _DEFAULT


class TraceCollector:
    """Bounded in-memory span store; the REST layer and tests read it."""

    def __init__(self, capacity: int = 4096):
        self._spans: List[Span] = []
        self._capacity = capacity
        self._lock = threading.Lock()

    def span(self, scope: str, name: str) -> SpanBuilder:
        return SpanBuilder(self, scope, name)

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._capacity:
                self._spans = self._spans[-self._capacity:]

    def spans(self, scope: Optional[str] = None) -> List[Span]:
        with self._lock:
            if scope is None:
                return list(self._spans)
            return [s for s in self._spans if s.scope == scope]
