"""The port's REST surface (``flink_tpu_torch/cluster/rest.py``), its
dashboard (``flink_tpu_torch/web/``) and the history server
(``cluster/history_server.py``) against the reference's: the same routes
answer with the same keys and values on the same jobs. Counterparts of
``tests/test_history_server.py``, the REST case of ``test_cluster.py`` and
the MiniCluster cases of ``test_annotations_flamegraph.py``, and the state
route at a held end of stream. Port jobs run with ``execution.device:
cpu``; every request has a timeout."""

import json
import time
import urllib.error
import urllib.request

import pytest

from test_torch_minicluster import (
    PKGS,
    _both,
    _cluster,
    _count_job,
    _env,
    _ns,
    _task_running,
    _wait_for,
)


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _status_of(port, path):
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10)
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    return 200, b""


@pytest.fixture(scope="module")
def rest_clusters(tmp_path_factory):
    """Both packages' clusters, each with one finished job and one failed
    job, archiving to a history directory."""
    made = {}
    for pkg in PKGS:
        ns = _ns(pkg)
        archive = str(tmp_path_factory.mktemp(f"history-{pkg}"))
        cluster = _cluster(ns, **{"rest.port": 0,
                                  "cluster.task-executors": 2,
                                  "jobmanager.archive.dir": archive})
        env = _env(ns, {"execution.micro-batch.size": 1000,
                        "restart-strategy.max-attempts": 1})
        _count_job(ns, env, ns.sinks.DiscardingSink(), 5_000, keys=50,
                   rate=10_000, window=1000)
        ok = cluster.submit(env, "good-job")
        ok.wait(timeout=60)

        def boom(batch):
            raise RuntimeError("kaboom")

        env = _env(ns, {"execution.micro-batch.size": 1000,
                        "restart-strategy.max-attempts": 1})
        _count_job(ns, env, ns.sinks.DiscardingSink(), 5_000, keys=50,
                   rate=10_000, window=1000, mapper=boom)
        bad = cluster.submit(env, "bad-job")
        bad.wait(timeout=60)
        made[pkg] = (ns, cluster, archive, ok.job_id, bad.job_id)
    yield made
    for _, cluster, _, _, _ in made.values():
        cluster.shutdown()


def _both_rest(rest_clusters, fn):
    return {pkg: fn(*rest_clusters[pkg]) for pkg in PKGS}


def test_overview_and_job_list(rest_clusters):
    def run(ns, cluster, archive, ok, bad):
        ov = _get(cluster.rest_port, "/overview")
        assert _get(cluster.rest_port, "/") == ov
        jobs = sorted((j["name"], j["status"], j["attempt"])
                      for j in _get(cluster.rest_port, "/jobs")["jobs"])
        return ov, jobs

    got = _both_rest(rest_clusters, run)
    assert got["port"] == got["reference"]
    ov, jobs = got["port"]
    assert ov == {"taskexecutors": 2, "slots_total": 2,
                  "jobs": {"FINISHED": 1, "FAILED": 1},
                  "flink_tpu_version": "0.1.0"}
    assert jobs == [("bad-job", "FAILED", 0), ("good-job", "FINISHED", 0)]


def test_job_detail_metrics_and_plan(rest_clusters):
    def run(ns, cluster, archive, ok, bad):
        port = cluster.rest_port
        detail = _get(port, f"/jobs/{ok}")
        failed = _get(port, f"/jobs/{bad}")
        metrics = _get(port, f"/jobs/{ok}/metrics")
        plan = _get(port, f"/jobs/{ok}/plan")["plan"]
        assert "kaboom" in failed["error"]
        assert metrics["metrics"]  # the finished attempt's snapshot
        return (sorted(detail), detail["status"], detail["attempt"],
                [h["state"] for h in detail["state_history"]],
                sorted(metrics), sorted(plan),
                len(plan.get("vertices", plan.get("nodes", []))))

    got = _both_rest(rest_clusters, run)
    assert got["port"] == got["reference"]
    assert got["port"][1:4] == ("FINISHED", 0,
                                ["CREATED", "RUNNING", "FINISHED"])


def test_unknown_routes_are_404(rest_clusters):
    def run(ns, cluster, archive, ok, bad):
        port = cluster.rest_port
        return [_status_of(port, p)[0] for p in
                ("/jobs/nope", "/jobs/nope/flamegraph", "/nothing",
                 "/ui/missing.js")]

    got = _both_rest(rest_clusters, run)
    assert got["port"] == got["reference"] == [404, 404, 404, 404]


def test_taskexecutors(rest_clusters):
    def run(ns, cluster, archive, ok, bad):
        execs = _get(cluster.rest_port, "/taskexecutors")["executors"]
        return sorted((e["id"], e["slots"], e["allocated"], e["slots_total"])
                      for e in execs), sorted(execs[0])

    got = _both_rest(rest_clusters, run)
    assert got["port"] == got["reference"]


def test_flamegraph_routes(rest_clusters):
    def run(ns, cluster, archive, ok, bad):
        port = cluster.rest_port
        fg = _get(port, "/flamegraph?duration_ms=60&all=1", timeout=30)
        job = _get(port, f"/jobs/{ok}/flamegraph?duration_ms=40",
                   timeout=30)
        return sorted(fg), fg["samples"] >= 0, sorted(job)

    got = _both_rest(rest_clusters, run)
    assert got["port"] == got["reference"]
    assert "root" in got["port"][0] and "endTimestamp" in got["port"][0]


def test_dashboard_served_at_ui(rest_clusters):
    def run(ns, cluster, archive, ok, bad):
        base = f"http://127.0.0.1:{cluster.rest_port}"
        out = {}
        for path in ("/ui", "/ui/app.js", "/ui/style.css", "/index.html"):
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                out[path] = (resp.headers["Content-Type"], resp.read())
        rejected = [_status_of(cluster.rest_port, p)[0] for p in
                    ("/ui/..%2Fweb%2Fapp.js", "/ui/.hidden.js",
                     "/ui/..%2Frest.py")]
        return out, rejected

    got = _both_rest(rest_clusters, run)
    port, ref = got["port"][0], got["reference"][0]
    assert got["port"][1] == got["reference"][1] == [404, 404, 404]
    for path in port:
        assert port[path] == ref[path], path  # the port's own copy
    assert "text/html" in port["/ui"][0]
    assert b"flink_tpu dashboard" in port["/ui"][1]
    assert b"/taskexecutors" in port["/ui/app.js"][1]
    assert "javascript" in port["/ui/app.js"][0]
    assert "text/css" in port["/ui/style.css"][0]


def test_history_server_serves_the_archive(rest_clusters):
    def run(ns, cluster, archive, ok, bad):
        hs_mod = __import__(
            ("flink_tpu" if ns.pkg == "reference" else "flink_tpu_torch")
            + ".cluster.history_server", fromlist=["x"])
        summaries = sorted((s["job_name"], s["status"], s["attempts"])
                           for s in hs_mod.read_archive(archive))
        hs = hs_mod.HistoryServer(archive)
        try:
            jobs = _get(hs.port, "/jobs")["jobs"]
            full = _get(hs.port, f"/jobs/{ok}")
            failed = _get(hs.port, f"/jobs/{bad}")
            missing = _status_of(hs.port, "/jobs/nope")[0]
        finally:
            hs.close()
        assert "kaboom" in failed["error"]
        return (summaries, sorted(j["job_name"] for j in jobs),
                full["status"], full["metrics"]["records_emitted_by_sources"],
                [h[0] for h in full["state_history"]], sorted(full),
                missing)

    got = _both_rest(rest_clusters, run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == [("bad-job", "FAILED", 0),
                              ("good-job", "FINISHED", 0)]
    assert got["port"][3] == 5000 and got["port"][6] == 404


@pytest.mark.parametrize("pkg", PKGS)
def test_no_archive_dir_no_files(pkg, tmp_path):
    ns = _ns(pkg)
    hs_mod = __import__(
        ("flink_tpu" if pkg == "reference" else "flink_tpu_torch")
        + ".cluster.history_server", fromlist=["x"])
    cluster = _cluster(ns)
    try:
        env = _env(ns, {"execution.micro-batch.size": 1000})
        _count_job(ns, env, ns.sinks.DiscardingSink(), 2_000)
        cluster.submit(env, "unarchived").wait(timeout=60)
    finally:
        cluster.shutdown()
    assert hs_mod.read_archive(str(tmp_path / "never-created")) == []


def test_post_savepoint_and_cancel(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"rest.port": 0})
        try:
            env = _env(ns, {"execution.micro-batch.size": 256})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 2_000_000,
                       slow=True)
            client = cluster.submit(env, "rest-job")
            port = cluster.rest_port
            assert _wait_for(lambda: client.status()["status"] == "RUNNING")
            sp = str(tmp_path / f"sp-{ns.pkg}")
            # RUNNING is set before the task reaches its TaskExecutor: a
            # savepoint is refused (a 500) until it has
            deadline = time.monotonic() + 20
            while True:
                try:
                    code, body = _post(
                        port, f"/jobs/{client.job_id}/savepoints",
                        {"target": sp})
                    break
                except urllib.error.HTTPError as e:
                    if e.code != 500 or time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            bad = _status_of(port, "/jobs/x/nothing")[0]
            code2, body2 = _post(port, f"/jobs/{client.job_id}/cancel", {})
            st = client.wait(timeout=30)
            return (code, body["savepoint"] == sp, code2, body2["status"],
                    st["status"], bad)
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"] == (
        202, True, 202, "cancelling", "CANCELED", 404)


def test_query_route_fails_naming_item_12e(tmp_path):
    """The state route (item 12e, served now): at a held end of stream the
    port's ``GET /jobs/<id>/state/<op>?key=K`` answers what the
    reference's does (JSON, window ends as strings), and an unknown
    operator is a 404 in both."""
    from flink_tpu_torch.benchmarks.held import release, settle, wait_held

    def run(ns):
        cluster = _cluster(ns, **{"rest.port": 0})
        hold = str(tmp_path / ns.pkg)
        try:
            env = _env(ns, {"execution.micro-batch.size": 256})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 20_000, keys=40,
                       window=2000, hold_dir=hold)
            client = cluster.submit(env, "q")
            wait_held(hold)
            op = "window_agg(CountAggregate)"
            url = f"/jobs/{client.job_id}/state/{op}?key=3"
            body = settle(lambda: _get(cluster.rest_port, url))
            ns_body = _get(cluster.rest_port, url + "&namespace=" + max(
                body["state"], key=int))
            missing = _status_of(cluster.rest_port,
                                 f"/jobs/{client.job_id}/state/window?key=3")
            release(hold)
            assert client.wait(timeout=60)["status"] == "FINISHED"
            body.pop("job_id")
            ns_body.pop("job_id")
            return body, ns_body, missing[0]
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    body, ns_body, missing = got["port"]
    assert body["state"] and len(ns_body["state"]) == 1 and missing == 404
