"""History server — finished jobs outlive the cluster (port of
``flink_tpu/cluster/history_server.py``).

reference: flink-runtime-web's HistoryServer: JobManagers archive
terminal jobs' REST payloads to a DFS directory
(`jobmanager.archive.fs.dir`); a standalone HistoryServer process serves
them after the cluster is gone.

Re-design: the JobMaster writes one JSON archive per terminal job
(status, attempts/state-machine transcript, metrics snapshot, checkpoint
trace spans) through the core.fs SPI (any scheme), and ``HistoryServer``
is a small standalone HTTP server over the archive directory."""

from __future__ import annotations

import json
import threading
from typing import Optional

from flink_tpu_torch.core.config import ConfigOption


ARCHIVE_DIR = ConfigOption(
    "jobmanager.archive.dir", default=None, type=str,
    description="Directory (any core.fs scheme) where terminal jobs are "
    "archived for the history server. None = no archiving.")


_SUMMARY_FIELDS = ("job_id", "job_name", "status", "start_time",
                   "end_time", "attempts")


def _write_atomic(fs, local: str, payload: dict) -> None:
    data = json.dumps(payload, default=str).encode()
    tmp = local + ".tmp"
    with fs.open(tmp, "wb") as fh:
        fh.write(data)
    fs.rename(tmp, local)


def archive_job(archive_dir: str, job_id: str, payload: dict) -> str:
    """Write one terminal job's archive plus a small summary sidecar —
    the /jobs listing reads only sidecars, so listing latency does not
    scale with span/metric payload sizes (the reference's HistoryServer
    keeps a cached overview for the same reason)."""
    from flink_tpu_torch.core.fs import get_filesystem

    fs, local = get_filesystem(archive_dir.rstrip("/") + f"/{job_id}.json")
    parent = local.rsplit("/", 1)[0]
    if parent and not fs.exists(parent):
        fs.mkdirs(parent)
    _write_atomic(fs, local, payload)
    _write_atomic(fs, local[:-5] + ".summary.json",
                  {k: payload.get(k) for k in _SUMMARY_FIELDS})
    return local


def read_archive(archive_dir: str, job_id: Optional[str] = None):
    from flink_tpu_torch.core.fs import get_filesystem

    fs, local = get_filesystem(archive_dir)
    if job_id is not None:
        path = local.rstrip("/") + f"/{job_id}.json"
        if not fs.exists(path):
            return None
        with fs.open(path, "rb") as fh:
            return json.loads(fh.read())
    out = []
    if not fs.exists(local):
        return out
    for name in sorted(fs.listdir(local)):
        if not name.endswith(".summary.json"):
            continue
        with fs.open(local.rstrip("/") + f"/{name}", "rb") as fh:
            out.append(json.loads(fh.read()))
    return out


class HistoryServer:
    """Standalone REST surface over an archive directory (reference:
    HistoryServer): GET /jobs (summaries), GET /jobs/<id> (full archive).
    Runs without any cluster."""

    def __init__(self, archive_dir: str, port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.archive_dir = archive_dir
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                try:
                    parts = [p for p in
                             self.path.split("?")[0].split("/") if p]
                    if parts == ["jobs"] or not parts:
                        body = {"jobs": read_archive(outer.archive_dir)}
                    elif len(parts) == 2 and parts[0] == "jobs":
                        body = read_archive(outer.archive_dir, parts[1])
                        if body is None:
                            raise KeyError(parts[1])
                    else:
                        raise KeyError(self.path)
                    payload = json.dumps(body).encode()
                    self.send_response(200)
                except KeyError:
                    payload = json.dumps(
                        {"error": f"not found: {self.path}"}).encode()
                    self.send_response(404)
                except Exception as e:  # noqa: BLE001
                    payload = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="history-server",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
