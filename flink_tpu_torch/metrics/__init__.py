#: Canonical cross-cutting metric-group names, the reference's (the
#: per-operator scopes like ``job.<name>#<uid>`` are dynamic and not
#: listed). Producers call ``group.add_group(<one of these>)``.
KNOWN_METRIC_GROUPS = (
    "autoscale",
    "cep",
    "chaos",
    "flight",
    "frontends",
    "latency",
    "skew",
    "state",
    "tenancy",
    "watchdog",
    "window",
)

from flink_tpu_torch.metrics.core import (  # noqa: E402,F401
    Counter,
    Gauge,
    Histogram,
    Meter,
    MetricGroup,
    MetricRegistry,
)
from flink_tpu_torch.metrics.reporters import (  # noqa: E402,F401
    LoggingReporter,
    PrometheusReporter,
)
from flink_tpu_torch.metrics.traces import (  # noqa: E402,F401
    Span,
    SpanBuilder,
    TraceCollector,
    default_collector,
)
