"""The port's multi-process serving tier (``flink_tpu_torch/tenancy/
frontend.py`` over the shared-memory arenas of ``native/hotcache.cpp``) on
the CPU, mirroring ``tests/test_serving_frontend.py``:

- an ATTACHED mapping refuses every write; the owner's epoch lets a
  frontend follow an owner restart; the manifest lists and cleans up;
- frontend answers equal the owner's own lookup path bit for bit (hits
  in the frontend, misses crossing to the owner, in input order), also
  after a frontend dies and the request fails over to a sibling;
- reader processes probing while the owner writes never surface a torn
  row (every hit is one generation's whole row: ``v == g * 1e6 + key``);
- a session cluster with ``serving_shm_dir`` armed: frontends serve a
  running job's replica-primed entries, equal to the cluster's lookups;
- the counters folded into the serving stats equal the reference's
  ``aggregate_lookup_stats`` on the same rows;
- ``LookupRouter`` plans every key to the reference router's host (under
  a live ``KeyGroupAssignment`` too), answers in input order and counts
  local and remote keys as the reference's.

The frontends are spawned (never forked) and import no JAX: the reference
package is only used in process, for its pure functions. Tolerance: none
(``==`` on the answers).
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from flink_tpu_torch.native import hotcache_available

native = pytest.mark.skipif(not hotcache_available(),
                            reason="the native hot cache did not build")

JOB, OP = "job-a", "window_agg"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shm_cache(tmp, max_entries=1 << 12):
    from flink_tpu_torch.tenancy.hot_cache import make_hot_row_cache

    return make_hot_row_cache(max_entries=max_entries,
                              shm_dir=os.path.join(tmp, "shm"))


def _prime(cache, n=64, gen=1):
    keys = list(range(n))
    vals = [{0: {"count": float(k), "sum": float(k * 2 + gen)}}
            for k in keys]
    cache.put_many(JOB, OP, keys, gen, vals)
    return keys, vals


class _StubPlane:
    """The owner the pool needs: a shm-backed hot cache plus a
    deterministic miss resolver standing in for the replica path."""

    def __init__(self, cache):
        self.hot_cache = cache
        self.miss_calls = []

    def lookup_batch(self, job, op, keys):
        self.miss_calls.append(list(keys))
        return [{"cold": float(k)} for k in keys]


# ------------------------------------------------------------ shm arena


@native
def test_frontend_client_bit_identical_to_owner_probe():
    from flink_tpu_torch.tenancy.hot_cache_native import FrontendCacheClient

    with tempfile.TemporaryDirectory() as tmp:
        cache = _shm_cache(tmp)
        keys, vals = _prime(cache)
        client = FrontendCacheClient(cache.shm_dir, frontend_id=0)
        try:
            hits, probe, misses = client.probe(
                JOB, OP, np.asarray(keys, dtype=np.int64))
            assert hits == len(keys) and misses == []
            got = [probe.materialize(i) for i in range(len(keys))]
            out, m = [None] * len(keys), []
            cache.get_many(JOB, OP, keys, 1, out, m, exact=False)
            assert got == out == vals
        finally:
            client.close()
            cache.close()


@native
def test_attached_handle_refuses_writes():
    from flink_tpu_torch.native import load_hotcache
    from flink_tpu_torch.tenancy.hot_cache_native import _ptr_i64, _u64p

    with tempfile.TemporaryDirectory() as tmp:
        cache = _shm_cache(tmp)
        _prime(cache)
        lib = load_hotcache()
        tbl = cache._tables[(JOB, OP)]
        h = lib.hc_attach(tbl.shm_path.encode())
        assert h
        try:
            assert lib.hc_is_attached(h) == 1
            assert lib.hc_epoch(h) == tbl.epoch
            before = lib.hc_len(h)
            k = np.asarray([999], dtype=np.int64)
            g = np.asarray([5], dtype=np.int64)
            off = np.asarray([0, 1], dtype=np.int64)
            ns = np.asarray([0], dtype=np.int64)
            va = np.asarray([7], dtype=np.int64)
            tg = np.asarray([0], dtype=np.uint64)
            assert lib.hc_put_batch(
                h, 1, _ptr_i64(k), _ptr_i64(g), _ptr_i64(off),
                _ptr_i64(ns), _ptr_i64(va), tg.ctypes.data_as(_u64p)) == 0
            assert lib.hc_len(h) == before
            lib.hc_clear(h)
            assert lib.hc_len(h) == before
        finally:
            lib.hc_destroy(h)
            cache.close()


@native
def test_owner_restart_epoch_detected_and_reattached():
    from flink_tpu_torch.tenancy.hot_cache import make_hot_row_cache
    from flink_tpu_torch.tenancy.hot_cache_native import FrontendCacheClient

    with tempfile.TemporaryDirectory() as tmp:
        cache = _shm_cache(tmp)
        _prime(cache, gen=1)
        client = FrontendCacheClient(cache.shm_dir, frontend_id=0)
        try:
            hits, probe, _ = client.probe(JOB, OP,
                                          np.asarray([3], dtype=np.int64))
            assert hits == 1 and probe.materialize(0)[0]["sum"] == 7.0
            shm_dir = cache.shm_dir
            cache.close()
            cache = make_hot_row_cache(max_entries=1 << 12, shm_dir=shm_dir)
            _prime(cache, gen=2)
            hits, probe, _ = client.probe(JOB, OP,
                                          np.asarray([3], dtype=np.int64))
            assert hits == 1 and probe.materialize(0)[0]["sum"] == 8.0
        finally:
            client.close()
            cache.close()


@native
def test_manifest_lists_tables_and_cleans_up():
    from flink_tpu_torch.tenancy.hot_cache_native import MANIFEST_NAME

    with tempfile.TemporaryDirectory() as tmp:
        cache = _shm_cache(tmp)
        _prime(cache)
        man = os.path.join(cache.shm_dir, MANIFEST_NAME)
        with open(man) as f:
            doc = json.load(f)
        rows = [r for r in doc["tables"]
                if r["job"] == JOB and r["operator"] == OP]
        assert len(rows) == 1 and os.path.exists(rows[0]["path"])
        assert rows[0]["epoch"] != 0
        cache.close()
        assert not os.path.exists(man)
        assert not os.path.exists(rows[0]["path"])


def test_shm_dir_without_native_plane_raises(monkeypatch):
    from flink_tpu_torch.tenancy.hot_cache import make_hot_row_cache

    monkeypatch.setenv("FLINK_TPU_NATIVE_HOTCACHE", "0")
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(RuntimeError, match="shm_dir"):
            make_hot_row_cache(shm_dir=os.path.join(tmp, "shm"))


def test_default_shm_dir_is_under_the_temp_dir(monkeypatch, tmp_path):
    from flink_tpu_torch.tenancy.frontend import default_shm_dir

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tempfile.tempdir = None
    try:
        d = default_shm_dir("x")
    finally:
        tempfile.tempdir = None
    assert d.startswith(str(tmp_path)) and d.endswith(f"_x_{os.getpid()}")


# -------------------------------------------------------- frontend pool


def _pool(tmp, n=2):
    from flink_tpu_torch.tenancy.frontend import FrontendPool

    cache = _shm_cache(tmp)
    plane = _StubPlane(cache)
    return FrontendPool(plane, n_frontends=n), plane, cache


@native
def test_pool_spawns_never_forks():
    with tempfile.TemporaryDirectory() as tmp:
        pool, _, cache = _pool(tmp, n=1)
        try:
            assert pool._ctx.get_start_method() == "spawn"
            pool.wait_ready()
            assert pool.live_frontends() == [0]
        finally:
            pool.close()
            cache.close()


@native
def test_hit_path_and_miss_crossing_bit_identical():
    with tempfile.TemporaryDirectory() as tmp:
        pool, plane, cache = _pool(tmp)
        try:
            keys, vals = _prime(cache)
            assert pool.lookup_batch(JOB, OP, [3, 7, 11]) == \
                [vals[3], vals[7], vals[11]]
            assert plane.miss_calls == []
            out = pool.lookup_batch(JOB, OP, [1, 900, 2, 901, 3])
            assert out == [vals[1], {"cold": 900.0}, vals[2],
                           {"cold": 901.0}, vals[3]]
            assert plane.miss_calls == [[900, 901]]
            rows = cache.fe_stats(pool.n_frontends)
            tot = {k: sum(r[k] for r in rows) for k in rows[0]}
            assert tot["probes"] == 8 and tot["hits"] == 6
            assert tot["miss_crossings"] == 2
        finally:
            pool.close()
            cache.close()


@native
def test_dead_frontend_fails_over_to_sibling():
    with tempfile.TemporaryDirectory() as tmp:
        pool, plane, cache = _pool(tmp)
        try:
            keys, vals = _prime(cache)
            pool._kill(pool._frontends[0])
            assert pool.lookup_batch(JOB, OP, [8, 9], frontend=0) == \
                [vals[8], vals[9]]
            assert pool.failovers == 1 and pool.live_frontends() == [1]
            assert pool.metrics()["frontends_live"] == 1.0
            assert pool.lookup_batch(JOB, OP, [5]) == [vals[5]]
        finally:
            pool.close()
            cache.close()


@native
def test_frontend_chaos_point_kills_mid_burst_and_fails_over():
    """The ``serving.frontend`` point's ``drop`` kind kills the chosen
    frontend process at dispatch; the burst completes on its sibling."""
    from flink_tpu_torch.chaos import injection as chaos

    with tempfile.TemporaryDirectory() as tmp:
        pool, plane, cache = _pool(tmp)
        try:
            keys, vals = _prime(cache)
            plan = chaos.FaultPlan(rules=[chaos.FaultRule(
                pattern="serving.frontend", nth=2, kind="drop")])
            with chaos.chaos_active(plan, seed=3):
                outs = [pool.lookup_batch(JOB, OP, [k, k + 1])
                        for k in range(0, 20, 2)]
            assert outs == [[vals[k], vals[k + 1]] for k in range(0, 20, 2)]
            assert len(pool.live_frontends()) == 1
        finally:
            pool.close()
            cache.close()


@native
def test_all_frontends_dead_fails_fast():
    with tempfile.TemporaryDirectory() as tmp:
        pool, plane, cache = _pool(tmp)
        try:
            _prime(cache)
            for fe in pool._frontends:
                pool._kill(fe)
            with pytest.raises(RuntimeError, match="no live frontend"):
                pool.lookup_batch(JOB, OP, [1])
        finally:
            pool.close()
            cache.close()


def test_pool_requires_shm_plane():
    from flink_tpu_torch.tenancy.frontend import FrontendPool
    from flink_tpu_torch.tenancy.hot_cache import HotRowCache

    with pytest.raises(RuntimeError, match="shm"):
        FrontendPool(_StubPlane(HotRowCache()), n_frontends=1)


@native
def test_drive_loop_reports_real_counters():
    with tempfile.TemporaryDirectory() as tmp:
        pool, plane, cache = _pool(tmp, n=2)
        try:
            keys, _ = _prime(cache, n=128)
            res = pool.drive(JOB, OP, keys, batch=32, batches=20)
            assert len(res) == 2
            for r in res:
                assert r["probes"] == 32 * 20 and r["hits"] == r["probes"]
                assert r["wall_s"] > 0.0
            assert all(r["probes"] >= 32 * 20 for r in cache.fe_stats(2))
        finally:
            pool.close()
            cache.close()


# --------------------------------------- cross-process seqlock fuzzing

_READER_SRC = r"""
import json, sys, time
import numpy as np
from flink_tpu_torch.tenancy.hot_cache_native import FrontendCacheClient

shm_dir, fe_id, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
client = FrontendCacheClient(shm_dir, frontend_id=fe_id)
keys = np.arange(64, dtype=np.int64)
probes = hits = bad = 0
gens = set()
deadline = time.monotonic() + seconds
hard = deadline + 20.0
while (time.monotonic() < deadline
       or (len(gens) < 2 and time.monotonic() < hard)):
    n, probe, misses = client.probe("job-a", "window_agg", keys)
    probes += len(keys)
    hits += n
    if probe is None:
        continue
    for i in range(len(keys)):
        if not probe.hit[i]:
            continue
        row = probe.materialize(i)[0]
        g, v = row["g"], row["v"]
        gens.add(g)
        if v != g * 1_000_000.0 + float(keys[i]):
            bad += 1
client.close()
print(json.dumps({"probes": probes, "hits": hits, "bad": bad,
                  "gens": sorted(gens)}))
"""


@native
def test_readers_never_see_torn_rows_under_live_writer():
    with tempfile.TemporaryDirectory() as tmp:
        cache = _shm_cache(tmp)
        try:
            keys = list(range(64))

            def write_gen(gen):
                cache.put_many(JOB, OP, keys, gen,
                               [{0: {"g": float(gen),
                                     "v": gen * 1_000_000.0 + float(k)}}
                                for k in keys])

            write_gen(1)
            env = dict(os.environ)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            readers = [subprocess.Popen(
                [sys.executable, "-c", _READER_SRC, cache.shm_dir, str(fe),
                 "2.0"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=env, text=True) for fe in (1, 2)]
            gen = 1
            deadline = time.monotonic() + 60.0
            while (any(r.poll() is None for r in readers)
                   and time.monotonic() < deadline):
                gen += 1
                write_gen(gen)
            reports = []
            for r in readers:
                out, err = r.communicate(timeout=30)
                assert r.returncode == 0, err
                reports.append(json.loads(out.strip().splitlines()[-1]))
            for rep in reports:
                assert rep["bad"] == 0 and rep["hits"] > 0, rep
            assert gen > 2
            assert any(len(rep["gens"]) > 1 for rep in reports), reports
            rows = cache.fe_stats(3)
            assert rows[1]["probes"] > 0 and rows[2]["probes"] > 0
        finally:
            cache.close()


# ------------------------------------------- a cluster's real replicas


@native
def test_frontends_serve_a_running_jobs_replica(tmp_path):
    """A session cluster with ``serving_shm_dir``: the job's replica
    publishes prime the shm table, a frontend process answers lookups of
    the running job (its misses cross to the cluster's replica path), and
    at the held cut its answers equal the cluster's own lookups."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.held import (
        HeldDataGenSource,
        release,
        settle,
        wait_held,
    )
    from flink_tpu_torch.cluster.local_executor import StateQueryBatchRequest
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.tenancy.frontend import FrontendPool
    from flink_tpu_torch.tenancy.session_cluster import SessionCluster
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    op = "window_agg(SumAggregate)"
    hold = str(tmp_path / "hold")
    env = StreamExecutionEnvironment(Configuration({
        "execution.device": "cpu", "execution.micro-batch.size": 2048,
        "parallelism.default": 4}))
    (env.add_source(HeldDataGenSource(
        hold, total_records=40_000, num_keys=64,
        events_per_second_of_eventtime=5_000, seed=5),
        WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key").window(TumblingEventTimeWindows.of(3_000))
        .sum("value").sink_to(CollectSink()))
    cluster = SessionCluster(quantum_records=2048,
                             serving_shm_dir=str(tmp_path / "shm"))
    cluster.submit(env, "fe-job")
    pool = FrontendPool(cluster.serving, n_frontends=1)
    th = threading.Thread(target=lambda: cluster.run(timeout_s=120))
    th.start()
    try:
        pool.wait_ready()
        wait_held(hold, timeout_s=120)
        control = cluster.jobs["fe-job"].control

        def ask():
            req = StateQueryBatchRequest(op, list(range(64)))
            control.put(req)
            return req.wait(60)

        live = settle(ask)
        keys = list(range(64))
        owner = cluster.lookup_batch("fe-job", op, keys)
        via_frontend = pool.lookup_batch("fe-job", op, keys)
        assert via_frontend == owner == live and any(live)
        via_frontend = pool.lookup_batch("fe-job", op, keys)
        assert via_frontend == live
        m = pool.metrics()
        assert m["frontend_probes"] >= 128 and m["frontend_hits"] > 0
    finally:
        release(hold)
        th.join(timeout=120)
        pool.close()
        cluster.serving.hot_cache.close()


# ------------------------------------------------------------- metrics


class _StubCoalescer:
    def __init__(self, n, b, ms):
        self._s = (n, b, list(ms))

    def stats_snapshot(self):
        return self._s


def test_aggregate_lookup_stats_folds_frontend_counters_as_reference():
    from flink_tpu.tenancy.serving import aggregate_lookup_stats as jagg
    from flink_tpu_torch.tenancy.serving import aggregate_lookup_stats

    fe = [{"probes": 100, "hits": 90, "torn_retries": 1,
           "miss_crossings": 10},
          {"probes": 50, "hits": 40, "torn_retries": 0,
           "miss_crossings": 10}]
    s = aggregate_lookup_stats([_StubCoalescer(20, 2, (1.0, 2.0))],
                               frontend_stats=fe)
    assert s == jagg([_StubCoalescer(20, 2, (1.0, 2.0))], frontend_stats=fe)
    assert s["frontend_hits"] == 130.0 and s["lookups_total"] == 150
    s2 = aggregate_lookup_stats([_StubCoalescer(20, 2, (1.0,))])
    assert s2 == jagg([_StubCoalescer(20, 2, (1.0,))])
    assert not any(k.startswith("frontend_") for k in s2)


@native
def test_serving_plane_metrics_include_frontend_counters():
    from flink_tpu_torch.tenancy.frontend import FrontendPool
    from flink_tpu_torch.tenancy.serving import ServingPlane

    with tempfile.TemporaryDirectory() as tmp:
        plane = ServingPlane(workers=1, shm_dir=os.path.join(tmp, "shm"))
        try:
            keys, vals = _prime(plane.hot_cache)
            pool = FrontendPool(plane, n_frontends=1)
            try:
                assert pool.lookup_batch(JOB, OP, [3]) == [vals[3]]
                m = plane.metrics()
                assert m["frontend_probes"] >= 1.0
                assert m["frontend_hits"] >= 1.0
            finally:
                pool.close()
        finally:
            plane.shutdown_workers()
            plane.hot_cache.close()


@native
def test_row9_gates_pass_at_a_cut_size(tmp_path):
    """BASELINE row 9 (``benchmarks/serving_mp.py``) at a cut
    size: hit rate, live priming, no torn read surfaced, parity."""
    from flink_tpu_torch.benchmarks import serving_mp

    r = serving_mp.row9(frontends=2, batches=100, root=str(tmp_path))
    assert r["failures"] == [], r["failures"]
    assert r["hit_rate"] >= 0.98 and r["torn_surfaced"] == 0
    assert r["parity_mismatches"] == 0 and r["generations"] >= 3


# ------------------------------------------------------------- routing


def _routers(fns=None, assignment=None):
    """The port's and the reference's LookupRouter over 4 hosts x 2
    shards, host 0 local, each host answering ``{host, key}``."""
    from flink_tpu.tenancy.frontend import LookupRouter as JRouter
    from flink_tpu_torch.tenancy.frontend import LookupRouter

    fns = fns if fns is not None else {
        h: (lambda job, op, ks, h=h: [{"host": h, "key": int(k)}
                                      for k in ks])
        for h in range(4)}
    return [cls(num_hosts=4, local_devices=2, max_parallelism=128,
                local_host=0, lookup_fns=fns, assignment=a)
            for cls, a in ((LookupRouter, assignment[0] if assignment
                            else None),
                           (JRouter, assignment[1] if assignment
                            else None))]


def test_lookup_router_routes_by_owning_host_in_input_order():
    port, ref = _routers()
    keys = list(range(64))
    hosts = port.plan(keys)
    assert (hosts == ref.plan(keys)).all()
    assert len(set(hosts.tolist())) > 1
    out = port.lookup_batch("j", "op", keys)
    assert out == ref.lookup_batch("j", "op", keys)
    assert out == [{"host": int(h), "key": k} for h, k in zip(hosts, keys)]
    assert port.metrics() == ref.metrics()
    assert port.metrics()["router_remote_keys"] > 0


def test_lookup_router_follows_the_live_assignment():
    from flink_tpu.state.keygroups import KeyGroupAssignment as JAsg
    from flink_tpu_torch.state.keygroups import KeyGroupAssignment

    table = np.full(128, 7, dtype=np.int32)   # every group on shard 7
    port, ref = _routers()
    port.set_assignment(KeyGroupAssignment(0, 8, table))
    ref.set_assignment(JAsg(0, 8, table))
    keys = list(range(32))
    assert (port.plan(keys) == 3).all() and (ref.plan(keys) == 3).all()
    assert port.lookup_batch("j", "op", keys[:8]) == \
        ref.lookup_batch("j", "op", keys[:8])


def test_lookup_router_missing_endpoint_raises():
    for r in _routers(fns={0: lambda job, op, ks: [None] * len(ks)}):
        with pytest.raises(KeyError, match="host"):
            r.lookup_batch("j", "op", list(range(64)))
