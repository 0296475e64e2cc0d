"""Metric reporters.

reference: the 9 pluggable reporters under flink-metrics/* —
flink-metrics-prometheus/.../PrometheusReporter.java exposes an HTTP
endpoint in the Prometheus text exposition format; flink-metrics-slf4j logs
periodic dumps. Here: PrometheusReporter renders the text format and can
serve it from a background http.server; LoggingReporter prints snapshots.
"""

from __future__ import annotations

import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from flink_tpu_torch.metrics.core import Counter, Gauge, Histogram, Meter

logger = logging.getLogger("flink_tpu_torch.metrics")

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(parts) -> str:
    return _INVALID.sub("_", "_".join(parts))


class PrometheusReporter:
    """Render (and optionally serve) metrics in Prometheus text format."""

    def __init__(self, port: Optional[int] = None):
        self.port = port
        self._registry = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def open(self, registry) -> None:
        self._registry = registry
        if self.port is not None:
            self._start_server()

    def render(self) -> str:
        lines = []
        for (scope, name), metric in self._registry.items():
            mname = _prom_name(("flink_tpu",) + scope[-1:] + (name,))
            labels = ""
            if len(scope) > 1:
                labelstr = ",".join(
                    f'scope_{i}="{s}"' for i, s in enumerate(scope[:-1]))
                labels = "{" + labelstr + "}"
            if isinstance(metric, Counter):
                lines.append(f"# TYPE {mname} counter")
                lines.append(f"{mname}{labels} {metric.get()}")
            elif isinstance(metric, Histogram):
                snap = metric.snapshot()
                lines.append(f"# TYPE {mname} summary")
                for q in ("p50", "p95", "p99"):
                    qv = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}[q]
                    ql = labels[:-1] + "," if labels else "{"
                    lines.append(
                        f'{mname}{ql}quantile="{qv}"}} {snap[q]}')
                lines.append(f"{mname}_count{labels} {snap['count']}")
            elif isinstance(metric, Meter):
                lines.append(f"# TYPE {mname} gauge")
                lines.append(f"{mname}{labels} {metric.rate}")
            elif isinstance(metric, Gauge):
                v = metric.get()
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    lines.append(f"# TYPE {mname} gauge")
                    lines.append(f"{mname}{labels} {v}")
        return "\n".join(lines) + "\n"

    def _start_server(self) -> None:
        reporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = reporter.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()


class LoggingReporter:
    """Periodic-dump reporter (reference: flink-metrics-slf4j)."""

    def __init__(self, level: int = logging.INFO):
        self.level = level
        self._registry = None

    def open(self, registry) -> None:
        self._registry = registry

    def report(self) -> None:
        for key, value in sorted(self._registry.snapshot().items()):
            logger.log(self.level, "metric %s = %s", key, value)

    def close(self) -> None:
        pass
