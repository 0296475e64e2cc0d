"""REST status endpoint for the MiniCluster (port of
``flink_tpu/cluster/rest.py``).

reference: flink-runtime/.../rest (41k LoC of handlers) + the Angular web
dashboard. Scope here: the JSON monitoring surface the reference's dashboard
reads — cluster overview, job list, per-job status/metrics — served from a
background http.server thread.

GET  /ui, /ui/<asset>        the web dashboard (multi-view SPA, the port's
                             own copy in flink_tpu_torch/web/ — the
                             flink-runtime-web role)
GET  /overview               cluster totals
GET  /jobs                   job summaries
GET  /jobs/<id>              one job's status
GET  /jobs/<id>/metrics      metric registry snapshot of the running attempt
GET  /jobs/<id>/state/<op>   queryable-state lookup (?key=K[&namespace=N])
GET  /jobs/<id>/flamegraph   sample the job's task threads (?duration_ms=N)
GET  /flamegraph             sample task threads cluster-wide (&all=1: every
                             thread incl. control plane)
GET  /taskexecutors          live executors + slots
POST /jobs/<id>/cancel       cancel the job
POST /jobs/<id>/savepoints   {"target": path, "stop": bool, "drain": bool}
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class RestServer:
    def __init__(self, cluster, port: int = 0):
        self.cluster = cluster
        rest = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                # "/" keeps serving the overview JSON (API compat);
                # the SPA lives under /ui
                clean = self.path.split("?")[0]
                if clean in ("/ui", "/index.html") \
                        or clean.startswith("/ui/"):
                    body, ctype = rest._static(clean)
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                try:
                    payload = rest._route(self.path)
                except KeyError:
                    self.send_response(404)
                    self.end_headers()
                    return
                except Exception as e:  # noqa: BLE001
                    body = json.dumps({"error": repr(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                body = json.dumps(payload, default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802
                try:
                    length = int(self.headers.get("Content-Length", 0) or 0)
                    body = json.loads(self.rfile.read(length) or b"{}") \
                        if length else {}
                    payload = rest._route_post(self.path, body)
                except KeyError:
                    self.send_response(404)
                    self.end_headers()
                    return
                except Exception as e:  # noqa: BLE001
                    out = json.dumps({"error": repr(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                    return
                out = json.dumps(payload, default=str).encode()
                self.send_response(202)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="rest-server", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- routing

    #: dashboard assets (flink_tpu_torch/web — the flink-runtime-web
    #: web-dashboard role: a real multi-view SPA over this REST surface)
    _STATIC_TYPES = {".html": "text/html; charset=utf-8",
                     ".js": "application/javascript; charset=utf-8",
                     ".css": "text/css; charset=utf-8"}

    def _static(self, clean_path: str):
        import os

        name = clean_path[len("/ui/"):] if clean_path.startswith("/ui/") \
            else "index.html"
        if not name or "/" in name or name.startswith("."):
            return None, None
        web = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "web")
        path = os.path.join(web, name)
        ext = os.path.splitext(name)[1]
        if ext not in self._STATIC_TYPES or not os.path.isfile(path):
            return None, None
        with open(path, "rb") as f:
            return f.read(), self._STATIC_TYPES[ext]

    def _route(self, path: str):
        parts = [p for p in path.split("?")[0].split("/") if p]
        if parts == ["overview"] or not parts:
            return self._overview()
        if parts == ["jobs"]:
            return {"jobs": self.cluster.dispatcher.list_jobs()}
        if parts == ["taskexecutors"]:
            return self._executors()
        if len(parts) >= 2 and parts[0] == "jobs":
            job_id = parts[1]
            if len(parts) == 2:
                st = self.cluster.dispatcher.job_status(job_id)
                if st["status"] == "UNKNOWN":
                    raise KeyError(job_id)
                return dict(st, job_id=job_id)
            if parts[2] == "metrics":
                return self._job_metrics(job_id)
            if parts[2] == "plan":
                return {"job_id": job_id,
                        "plan": self.cluster.dispatcher.job_plan(job_id)}
            if parts[2] == "state" and len(parts) >= 4:
                return self._query_state(job_id, parts[3], path)
            if parts[2] == "flamegraph":
                if self.cluster.dispatcher.job_status(
                        job_id)["status"] == "UNKNOWN":
                    raise KeyError(job_id)
                return self._flamegraph(path, job_id=job_id)
        if parts == ["flamegraph"]:
            return self._flamegraph(path)
        raise KeyError(path)

    def _flamegraph(self, raw_path: str, job_id: str = None):
        """GET /flamegraph[?duration_ms=200&all=1] (cluster-wide task
        threads) and GET /jobs/<id>/flamegraph (that job's task threads —
        task threads are named task-<jobid>-<attempt>, so the job id IS
        the sampling filter). On-demand thread sampling folded into a
        frame tree (reference: VertexFlameGraph +
        JobVertexFlameGraphHandler)."""
        from urllib.parse import parse_qs, urlsplit

        from flink_tpu_torch.metrics.flamegraph import (
            TASK_THREAD_PREFIXES,
            sample_flame_graph,
        )

        q = parse_qs(urlsplit(raw_path).query)
        duration = min(int(q.get("duration_ms", ["200"])[0]), 10_000)
        if job_id is not None:
            prefixes = [f"task-{job_id}"]
        elif q.get("all", ["0"])[0] == "1":
            prefixes = None
        else:
            prefixes = TASK_THREAD_PREFIXES
        return sample_flame_graph(duration_ms=duration,
                                  thread_name_prefixes=prefixes)

    def _query_state(self, job_id: str, operator_name: str, raw_path: str):
        """GET /jobs/<id>/state/<operator>?key=K[&namespace=N] — queryable
        state over REST (reference: queryable-state client, here on the
        monitoring port)."""
        from urllib.parse import parse_qs, unquote, urlsplit

        q = parse_qs(urlsplit(raw_path).query)
        if "key" not in q:
            raise KeyError("missing ?key=")
        key: object = q["key"][0]
        # key-type=string|int|float forces the key's Python type; the
        # default 'auto' tries int (string keys that LOOK numeric need the
        # explicit override — int 3 and "3" hash differently, like the
        # reference's typed key serializers)
        key_type = q.get("key-type", ["auto"])[0]
        if key_type == "int":
            key = int(key)
        elif key_type == "float":
            key = float(key)
        elif key_type == "auto":
            try:
                key = int(key)
            except ValueError:
                pass
        ns = int(q["namespace"][0]) if "namespace" in q else None
        result = self.cluster.dispatcher.query_state(
            job_id, unquote(operator_name), key, ns)
        return {"job_id": job_id, "operator": operator_name,
                "key": key, "state": result}

    def _route_post(self, path: str, body: dict):
        parts = [p for p in path.split("?")[0].split("/") if p]
        if len(parts) == 3 and parts[0] == "jobs" and parts[2] == "cancel":
            job_id = parts[1]
            if self.cluster.dispatcher.job_status(job_id)["status"] == \
                    "UNKNOWN":
                raise KeyError(job_id)
            self.cluster.dispatcher.cancel_job(job_id)
            return {"job_id": job_id, "status": "cancelling"}
        if len(parts) == 3 and parts[0] == "jobs" and \
                parts[2] == "savepoints":
            from flink_tpu_torch.cluster.minicluster import JobClient

            target = body.get("target")
            if not target:
                raise ValueError("body must carry 'target'")
            client = JobClient(self.cluster, parts[1])
            if body.get("stop"):
                p = client.stop_with_savepoint(
                    target, drain=bool(body.get("drain")))
            else:
                p = client.trigger_savepoint(target)
            return {"job_id": parts[1], "savepoint": p}
        raise KeyError(path)

    def _overview(self):
        jobs = self.cluster.dispatcher.list_jobs()
        by_status: dict = {}
        for j in jobs:
            by_status[j["status"]] = by_status.get(j["status"], 0) + 1
        return {
            "taskexecutors": len(self.cluster.executors),
            "slots_total": sum(te.num_slots for te in self.cluster.executors),
            "jobs": by_status,
            "flink_tpu_version": _version(),
        }

    def _executors(self):
        # RM registry covers local AND remote (standalone) executors;
        # in-process ones add their live task view
        local = {te.endpoint_id: te.heartbeat()
                 for te in self.cluster.executors}
        out = []
        # through the RPC gateway: registry reads serialize on the RM main
        # thread instead of racing its mutations
        for eid, info in self.cluster.rm_gateway().executor_registry().items():
            entry = dict(local.get(eid, {"executor_id": eid}))
            entry.update(address=info["address"], slots=info["slots"],
                         allocated=info["allocated"],
                         heartbeat_age_s=round(info["heartbeat_age_s"], 3))
            out.append(entry)
        return {"executors": out}

    def _job_metrics(self, job_id: str):
        master = self.cluster.dispatcher.master(job_id)
        if master is None:
            raise KeyError(job_id)
        result = master.result
        if result is not None:
            snap = getattr(result, "metric_snapshot", None)
            if snap is None and getattr(result, "registry", None):
                snap = result.registry.snapshot()
            return {"job_id": job_id, "metrics": snap or {},
                    "spans": getattr(result, "spans", [])}
        return {"job_id": job_id, "metrics": {},
                "note": "job still running or no result yet"}

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _version() -> str:
    try:
        from flink_tpu_torch.version import __version__

        return __version__
    except Exception:  # pragma: no cover
        return "unknown"
