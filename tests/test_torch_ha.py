"""High availability and the adaptive scheduler: the port
(``flink_tpu_torch/cluster/ha.py`` and the MiniCluster's scheduler)
against the reference on the same steps — counterparts of every test in
``tests/test_ha_adaptive.py``. Port jobs run with ``execution.device:
cpu``; every wait is bounded."""

import importlib
import json
import os
import time

import pytest

from test_torch_minicluster import (
    PKGS,
    _both,
    _cluster,
    _count_job,
    _counts,
    _env,
    _ns,
    _wait_for,
)


def _ha(pkg):
    return importlib.import_module(
        "flink_tpu.cluster.ha" if pkg == "reference"
        else "flink_tpu_torch.cluster.ha")


# ------------------------------------------------- adaptive scheduler


def test_default_mode_fails_fast_without_slots(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"cluster.task-executors": 0})
        try:
            env = _env(ns, {"execution.micro-batch.size": 512})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(
                str(tmp_path / f"{ns.pkg}.jsonl")), 4_000)
            st = cluster.submit(env, "nores").wait(timeout=20)
            return st["status"], st["error"]
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == "FAILED" and "no slots" in got["port"][1]


def test_adaptive_waits_for_resources_then_runs(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"cluster.task-executors": 0})
        try:
            env = _env(ns, {"execution.micro-batch.size": 512,
                            "jobmanager.scheduler": "adaptive"})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(
                str(tmp_path / f"{ns.pkg}.jsonl")), 4_000)
            client = cluster.submit(env, "adaptive-wait")
            waited = _wait_for(lambda: client.status()["status"]
                               == "WAITING_FOR_RESOURCES", timeout=5)
            cluster.add_task_executor()
            st = client.wait(timeout=30)
            return waited, st["status"], [h["state"]
                                          for h in st["state_history"]]
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"] == (True, "FINISHED",
                           ["CREATED", "WAITING_FOR_RESOURCES", "RUNNING",
                            "FINISHED"])


def test_adaptive_wait_timeout_fails(tmp_path):
    def run(ns):
        cluster = _cluster(ns, **{"cluster.task-executors": 0})
        try:
            env = _env(ns, {
                "execution.micro-batch.size": 512,
                "jobmanager.scheduler": "adaptive",
                "jobmanager.adaptive-scheduler.resource-wait-timeout-ms":
                    300})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(
                str(tmp_path / f"{ns.pkg}.jsonl")), 4_000)
            st = cluster.submit(env, "adaptive-timeout").wait(timeout=20)
            return st["status"], st["error"]
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert "resource wait timeout" in got["port"][1]


def test_adaptive_rescales_on_new_resources(tmp_path):
    total = 20_000

    def run(ns):
        cluster = _cluster(ns)
        out = str(tmp_path / f"{ns.pkg}.jsonl")
        try:
            env = _env(ns, {
                "execution.micro-batch.size": 256,
                "jobmanager.scheduler": "adaptive",
                "state.checkpoints.dir": str(tmp_path / f"ck-{ns.pkg}"),
                "execution.checkpointing.every-n-source-batches": 2})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(out), total,
                       slow=True)
            client = cluster.submit(env, "adaptive-rescale")
            assert _wait_for(lambda: client.status()["status"] == "RUNNING")
            time.sleep(0.3)  # let some checkpoints land
            cluster.add_task_executor()
            st = client.wait(timeout=60)
            states = [h["state"] for h in st["state_history"]]
            return (st["status"], st["attempt"] >= 1, "RESTARTING" in states,
                    _counts(ns.sinks.JsonLinesFileSink.read_rows(out)))
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][:3] == ("FINISHED", True, True)
    assert sum(got["port"][3].values()) == total


# ---------------------------------------------------- leader election


class _Contender:
    def __init__(self):
        self.granted = []
        self.revoked = 0

    def grant_leadership(self, token):
        self.granted.append(token)

    def revoke_leadership(self):
        self.revoked += 1


@pytest.mark.parametrize("pkg", PKGS)
def test_single_leader_and_takeover(pkg, tmp_path):
    ha = _ha(pkg)
    d = str(tmp_path)
    c1, c2 = _Contender(), _Contender()
    s1 = ha.LeaderElectionService(
        ha.FileLeaderElectionDriver(d, "dispatcher", lease_timeout_s=0.4),
        c1, poll_interval_s=0.05)
    s2 = ha.LeaderElectionService(
        ha.FileLeaderElectionDriver(d, "dispatcher", lease_timeout_s=0.4),
        c2, poll_interval_s=0.05)
    s1.start()
    assert _wait_for(lambda: s1.is_leader and c1.granted, timeout=5)
    s2.start()
    time.sleep(0.3)
    assert not s2.is_leader  # exactly one leader
    token1 = c1.granted[0]
    # the leader dies (stops renewing without releasing)
    s1._stop.set()
    s1._thread.join(timeout=2)
    assert _wait_for(lambda: s2.is_leader, timeout=5)
    assert c2.granted and c2.granted[0] != token1  # a fresh fencing token
    s2.stop()
    s1.driver.release()


@pytest.mark.parametrize("pkg", PKGS)
def test_explicit_release_hands_over_fast(pkg, tmp_path):
    ha = _ha(pkg)
    d = str(tmp_path)
    c1, c2 = _Contender(), _Contender()
    s1 = ha.LeaderElectionService(
        ha.FileLeaderElectionDriver(d, "rm", lease_timeout_s=5.0), c1,
        poll_interval_s=0.05)
    s2 = ha.LeaderElectionService(
        ha.FileLeaderElectionDriver(d, "rm", lease_timeout_s=5.0), c2,
        poll_interval_s=0.05)
    s1.start()
    assert _wait_for(lambda: s1.is_leader, timeout=5)
    s2.start()
    s1.stop()  # graceful: releases the lock
    assert _wait_for(lambda: s2.is_leader, timeout=3)
    s2.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_lease_renew_detects_concurrent_steal(pkg, tmp_path, monkeypatch):
    ha = _ha(pkg)
    d = str(tmp_path / "ha")
    os.makedirs(d)
    a = ha.FileLeaderElectionDriver(d, "dispatcher", lease_timeout_s=60)
    b = ha.FileLeaderElectionDriver(d, "dispatcher", lease_timeout_s=60)
    assert a.try_acquire()
    real_utime = os.utime

    def steal_then_utime(path, *args, **kwargs):
        tmp = path + ".steal"
        with open(tmp, "w") as f:
            f.write(json.dumps({"owner": b.owner_id, "ts": time.time()}))
        os.replace(tmp, path)
        return real_utime(path, *args, **kwargs)

    monkeypatch.setattr(os, "utime", steal_then_utime)
    assert a.renew() is False
    monkeypatch.setattr(os, "utime", real_utime)
    assert b.renew() is True


@pytest.mark.parametrize("pkg", PKGS)
def test_stale_lease_is_taken_over(pkg, tmp_path):
    ha = _ha(pkg)
    d = str(tmp_path)
    a = ha.FileLeaderElectionDriver(d, "x", lease_timeout_s=0.2)
    b = ha.FileLeaderElectionDriver(d, "x", lease_timeout_s=0.2)
    assert a.try_acquire() and not b.try_acquire()
    time.sleep(0.3)
    assert b.try_acquire() and not a.renew()


# ------------------------------------------- job graph store, blobs


@pytest.mark.parametrize("pkg", PKGS)
def test_blob_store_roundtrip_cache_and_corruption(pkg, tmp_path):
    ha = _ha(pkg)
    store = ha.BlobStore(str(tmp_path / "ha"),
                         cache_dir=str(tmp_path / "cache"))
    key = store.put(b"artifact-bytes")
    assert store.exists(key)
    assert store.get(key) == b"artifact-bytes"
    store.delete(key)
    assert store.get(key) == b"artifact-bytes"  # the cached copy
    assert store.put(b"artifact-bytes") == key  # content addressing
    k2 = ha.BlobStore(str(tmp_path / "ha2")).put(b"x")
    with open(os.path.join(str(tmp_path / "ha2"), "blobs", k2), "wb") as f:
        f.write(b"tampered")
    with pytest.raises(IOError, match="verification"):
        ha.BlobStore(str(tmp_path / "ha2")).get(k2)


@pytest.mark.parametrize("pkg", PKGS)
def test_blob_store_corrupted_cache_entry_is_repaired(pkg, tmp_path):
    ha = _ha(pkg)
    cache = str(tmp_path / "cache")
    store = ha.BlobStore(str(tmp_path / "ha"), cache_dir=cache)
    key = store.put(b"artifact-bytes")
    assert store.get(key) == b"artifact-bytes"
    with open(os.path.join(cache, key), "wb") as f:
        f.write(b"bit-rot")
    assert store.get(key) == b"artifact-bytes"
    with open(os.path.join(cache, key), "rb") as f:
        assert f.read() == b"artifact-bytes"


def test_blob_keys_equal_the_references(tmp_path):
    data = os.urandom(4096)
    keys = {pkg: _ha(pkg).BlobStore(str(tmp_path / pkg)).put(data)
            for pkg in PKGS}
    assert keys["port"] == keys["reference"]


def test_job_graph_store_keeps_closures(tmp_path):
    """The store pickles the graph through the RPC serializer: a graph
    holding a closure comes back and runs."""
    from flink_tpu_torch.cluster.local_executor import LocalExecutor

    ha = _ha("port")
    ns = _ns("port")
    out = str(tmp_path / "out.jsonl")
    env = _env(ns, {"execution.micro-batch.size": 512})
    seen = {"batches": 0}

    def mapper(b):
        seen["batches"] += 1
        return b

    _count_job(ns, env, ns.sinks.JsonLinesFileSink(out), 3_000,
               mapper=mapper)
    store = ha.JobGraphStore(str(tmp_path / "ha"))
    store.put("j1", "named", env.get_stream_graph(), env.config.to_dict())
    assert store.job_ids() == ["j1"]
    rec = store.get("j1")
    assert rec["job_name"] == "named"
    LocalExecutor(ns.cfg.Configuration(rec["config"])).run(rec["graph"])
    assert sum(_counts(ns.sinks.JsonLinesFileSink.read_rows(out))
               .values()) == 3_000
    assert seen["batches"] == 0  # the recovered copy ran, not this one
    store.remove("j1")
    assert store.job_ids() == []


# ------------------------------------------------------ HA recovery


def _leading(cluster):
    """Wait until ``cluster`` leads and its grant's recovery has passed:
    the reference's dispatcher can start a job twice when that recovery
    runs during a submit (ROADMAP Queue C item R8), so the tests that run
    both packages submit after it."""
    assert _wait_for(lambda: cluster._leader_election.is_leader, 10)
    time.sleep(0.2)


def _ha_conf(ha_dir, **extra):
    return {"high-availability.type": "filesystem",
            "high-availability.storageDir": ha_dir, **extra}


def test_dispatcher_recovers_jobs_after_failover(tmp_path):
    total = 20_000

    def run(ns):
        ha = _ha(ns.pkg)
        ha_dir = str(tmp_path / f"ha-{ns.pkg}")
        out = str(tmp_path / f"{ns.pkg}.jsonl")
        cluster1 = _cluster(ns, **_ha_conf(ha_dir))
        env = _env(ns, {
            "execution.micro-batch.size": 256,
            "state.checkpoints.dir": str(tmp_path / f"ck-{ns.pkg}"),
            "execution.checkpointing.every-n-source-batches": 2})
        _count_job(ns, env, ns.sinks.JsonLinesFileSink(out), total,
                   slow=True)
        _leading(cluster1)
        job_id = cluster1.submit(env, "ha-job").job_id
        time.sleep(0.6)  # run and checkpoint, then the cluster dies
        cluster1.shutdown()
        stored = ha.JobGraphStore(ha_dir).job_ids()
        cluster2 = _cluster(ns, **_ha_conf(ha_dir))
        try:
            master = []
            assert _wait_for(lambda: master.append(
                cluster2.dispatcher.master(job_id)) or master[-1]
                is not None, timeout=10), "job not recovered"
            status = master[-1].wait(timeout=60)
            return (stored == [job_id], status,
                    ha.JobGraphStore(ha_dir).job_ids(),
                    _counts(ns.sinks.JsonLinesFileSink.read_rows(out)))
        finally:
            cluster2.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][:3] == (True, "FINISHED", [])
    assert sum(got["port"][3].values()) == total


def test_revoked_leader_suspends_running_jobs(tmp_path):
    def run(ns):
        ha = _ha(ns.pkg)
        ha_dir = str(tmp_path / f"ha-{ns.pkg}")
        cluster = _cluster(ns, **_ha_conf(
            ha_dir, **{"high-availability.lease-timeout-ms": 400}))
        try:
            env = _env(ns, {"execution.micro-batch.size": 64})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 2_000_000,
                       slow=True)
            _leading(cluster)
            client = cluster.submit(env, "long-job")
            assert _wait_for(lambda: client.status()["status"] == "RUNNING",
                             timeout=10)
            lock = os.path.join(ha_dir, "dispatcher.lock")
            with open(lock + ".steal", "w") as f:
                f.write(json.dumps({"owner": "other-cluster",
                                    "ts": time.time()}))
            os.replace(lock + ".steal", lock)
            assert _wait_for(lambda: client.status()["status"]
                             in ("SUSPENDED", "CANCELED"), timeout=10)
            store = ha.JobGraphStore(ha_dir)
            return client.status()["status"], [
                store.get(j)["job_name"] for j in store.job_ids()]
        finally:
            cluster.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][1] == ["long-job"]


def test_standby_cluster_does_not_run_jobs(tmp_path):
    def run(ns):
        ha = _ha(ns.pkg)
        ha_dir = str(tmp_path / f"ha-{ns.pkg}")
        env = _env(ns, {"execution.micro-batch.size": 512})
        _count_job(ns, env, ns.sinks.JsonLinesFileSink(
            str(tmp_path / f"{ns.pkg}.jsonl")), 2_000)
        ha.JobGraphStore(ha_dir).put(
            "job-x", "seeded", env.get_stream_graph(), env.config.to_dict())
        leader = _cluster(ns, **_ha_conf(ha_dir))
        standby = _cluster(ns, **_ha_conf(ha_dir))
        try:
            assert _wait_for(
                lambda: leader.dispatcher.master("job-x") is not None
                or standby.dispatcher.master("job-x") is not None,
                timeout=10)
            ran = [c for c in (leader, standby)
                   if c.dispatcher.master("job-x") is not None]
            status = ran[0].dispatcher.master("job-x").wait(timeout=30)
            return len(ran), status
        finally:
            standby.shutdown()
            leader.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"] == (1, "FINISHED")


def test_standby_takes_over_a_released_leaders_job(tmp_path):
    """23(d)'s shape at a CPU size: two clusters share the storage dir; the
    job submitted to the leader finishes on the standby after the leader
    releases."""
    total = 20_000

    def run(ns):
        ha_dir = str(tmp_path / f"ha-{ns.pkg}")
        out = str(tmp_path / f"{ns.pkg}.jsonl")
        conf = _ha_conf(ha_dir, **{"high-availability.lease-timeout-ms":
                                   500})
        leader = _cluster(ns, **conf)
        _leading(leader)
        standby = _cluster(ns, **conf)
        try:
            env = _env(ns, {
                "execution.micro-batch.size": 256,
                "state.checkpoints.dir": str(tmp_path / f"ck-{ns.pkg}"),
                "execution.checkpointing.every-n-source-batches": 2})
            _count_job(ns, env, ns.sinks.JsonLinesFileSink(out), total,
                       slow=True)
            job_id = leader.submit(env, "ha-q").job_id
            time.sleep(0.4)
            leader.shutdown()
            master = []
            assert _wait_for(lambda: master.append(
                standby.dispatcher.master(job_id)) or master[-1]
                is not None, timeout=10)
            status = master[-1].wait(timeout=60)
            return status, _counts(
                ns.sinks.JsonLinesFileSink.read_rows(out))
        finally:
            standby.shutdown()

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == "FINISHED"
    assert sum(got["port"][1].values()) == total


def test_recovery_during_a_submit_starts_the_job_once(tmp_path,
                                                      monkeypatch):
    """A leadership grant's recovery that runs while a job is being
    submitted — the store already holds the job, its master has not
    started — must not start it a second time. The port submits under
    the recovery lock (ROADMAP Queue C item R8: the reference's
    dispatcher starts a second master, which finds no slot, fails, and
    takes the job out of the store; a loaded CPU made it happen here)."""
    import threading

    ns, ha = _ns("port"), _ha("port")
    cluster = _cluster(ns, **_ha_conf(str(tmp_path / "ha")))
    try:
        assert _wait_for(lambda: cluster._leader_election.is_leader, 5)
        started = []
        real_init = ns.mc.JobMasterThread.__init__

        def counting_init(self, *a, **k):
            started.append(a[1])
            real_init(self, *a, **k)

        monkeypatch.setattr(ns.mc.JobMasterThread, "__init__",
                            counting_init)
        real_put = ha.JobGraphStore.put
        racers = []

        def put_then_recover(store, *a, **k):
            real_put(store, *a, **k)
            t = threading.Thread(target=cluster.dispatcher.recover_jobs)
            t.start()
            racers.append(t)
            time.sleep(0.2)  # the recovery gets its chance mid-submit

        monkeypatch.setattr(ha.JobGraphStore, "put", put_then_recover)
        env = _env(ns, {"execution.micro-batch.size": 512})
        _count_job(ns, env, ns.sinks.DiscardingSink(), 4_000)
        client = cluster.submit(env, "once")
        for t in racers:
            t.join(timeout=10)
            assert not t.is_alive()
        assert client.wait(timeout=60)["status"] == "FINISHED"
        assert started == [client.job_id]
    finally:
        cluster.shutdown()
