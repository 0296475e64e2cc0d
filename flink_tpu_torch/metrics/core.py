"""Metric types + hierarchical metric groups.

reference: flink-metrics/flink-metrics-core — Metric/Counter/Gauge/Histogram/
Meter interfaces, hierarchical MetricGroup scopes (job -> task -> operator),
TM-side registry runtime/metrics/MetricRegistryImpl.java (SURVEY.md §5).

Re-design: metrics are plain Python objects owned by the single-threaded
task loop (no locks on the hot path — the same single-owner discipline the
reference gets from the mailbox model); reporters snapshot on demand from
whatever thread serves them. Histogram keeps a bounded reservoir.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple


def quantile_sorted(data: List[float], q: float) -> float:
    """Quantile of an already-sorted list (shared index formula)."""
    if not data:
        return 0.0
    return data[min(len(data) - 1, int(q * len(data)))]


class Counter:
    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    def dec(self, n: int = 1) -> None:
        self._value -= n

    @property
    def count(self) -> int:
        return self._value

    def get(self) -> int:
        return self._value


class Gauge:
    """Wraps a supplier; value computed at report time."""

    __slots__ = ("_supplier",)

    def __init__(self, supplier: Callable[[], Any]) -> None:
        self._supplier = supplier

    def get(self):
        return self._supplier()


class SettableGauge(Gauge):
    __slots__ = ("_value",)

    def __init__(self, initial=0) -> None:
        self._value = initial
        super().__init__(lambda: self._value)

    def set(self, v) -> None:
        self._value = v


class Histogram:
    """Bounded-reservoir histogram with quantile snapshots
    (reference: DescriptiveStatisticsHistogram)."""

    __slots__ = ("_reservoir", "_count")

    def __init__(self, reservoir_size: int = 8192) -> None:
        self._reservoir: deque = deque(maxlen=reservoir_size)
        self._count = 0

    def update(self, value: float) -> None:
        self._reservoir.append(value)
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, q: float) -> float:
        return quantile_sorted(sorted(self._reservoir), q)

    def snapshot(self) -> Dict[str, float]:
        if not self._reservoir:
            return {"count": self._count, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        data = sorted(self._reservoir)
        n = len(data)
        return {
            "count": self._count,
            "min": data[0],
            "max": data[-1],
            "mean": sum(data) / n,
            "p50": quantile_sorted(data, 0.5),
            "p95": quantile_sorted(data, 0.95),
            "p99": quantile_sorted(data, 0.99),
        }


class Meter:
    """Events-per-second over a sliding minute (reference: MeterView)."""

    __slots__ = ("_count", "_stamps")

    def __init__(self) -> None:
        self._count = 0
        self._stamps: deque = deque(maxlen=128)

    def mark(self, n: int = 1) -> None:
        self._count += n
        self._stamps.append((time.monotonic(), self._count))

    @property
    def count(self) -> int:
        return self._count

    @property
    def rate(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        (t0, c0), (t1, c1) = self._stamps[0], self._stamps[-1]
        dt = t1 - t0
        return (c1 - c0) / dt if dt > 0 else 0.0


class MetricGroup:
    """Hierarchical scope: job -> task -> operator, like the reference's
    AbstractMetricGroup. Leaf metrics register into the shared registry with
    their full scope string."""

    def __init__(self, registry: "MetricRegistry",
                 scope: Tuple[str, ...] = ()) -> None:
        self.registry = registry
        self.scope = scope

    def add_group(self, name: str) -> "MetricGroup":
        return MetricGroup(self.registry, self.scope + (str(name),))

    def _register(self, name: str, metric) -> Any:
        self.registry.register(self.scope, name, metric)
        return metric

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter())

    def gauge(self, name: str, supplier: Callable[[], Any]) -> Gauge:
        return self._register(name, Gauge(supplier))

    def settable_gauge(self, name: str, initial=0) -> SettableGauge:
        return self._register(name, SettableGauge(initial))

    def histogram(self, name: str, reservoir_size: int = 8192) -> Histogram:
        return self._register(name, Histogram(reservoir_size))

    def meter(self, name: str) -> Meter:
        return self._register(name, Meter())

    def scope_string(self, delimiter: str = ".") -> str:
        return delimiter.join(self.scope)


class MetricRegistry:
    """Flat store of (scope, name) -> metric + attached reporters
    (reference: runtime/metrics/MetricRegistryImpl.java)."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[Tuple[str, ...], str], Any] = {}
        self._reporters: List[Any] = []

    def register(self, scope: Tuple[str, ...], name: str, metric) -> None:
        self._metrics[(scope, name)] = metric

    def unregister_scope_prefix(self, prefix: Tuple[str, ...]) -> None:
        self._metrics = {
            (s, n): m for (s, n), m in self._metrics.items()
            if s[:len(prefix)] != prefix
        }

    def add_reporter(self, reporter) -> None:
        self._reporters.append(reporter)
        reporter.open(self)

    def close(self) -> None:
        for r in self._reporters:
            r.close()

    def root_group(self, *scope: str) -> MetricGroup:
        return MetricGroup(self, tuple(scope))

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> Dict[str, Any]:
        """Flat name -> value view (gauges evaluated, histograms expanded)."""
        out: Dict[str, Any] = {}
        for (scope, name), metric in list(self._metrics.items()):
            key = ".".join(scope + (name,))
            if isinstance(metric, Histogram):
                for k, v in metric.snapshot().items():
                    out[f"{key}.{k}"] = v
            elif isinstance(metric, Meter):
                out[f"{key}.count"] = metric.count
                out[f"{key}.rate"] = metric.rate
            elif isinstance(metric, (Counter, Gauge)):
                out[key] = metric.get()
            else:
                out[key] = metric
        return out

    def items(self):
        return list(self._metrics.items())
