"""The port's serving plane (``flink_tpu_torch/tenancy/serving.py``)
against the reference's (``flink_tpu/tenancy/serving.py``) on the CPU.

- ``LookupCoalescer`` and ``ServingPlane`` retirement on the legacy-path
  cases of ``tests/test_tenancy.py`` (shared flushes, a short reply
  failing every rider, a failed flush recovering, a stats scrape during
  lookups, unbind keeping cumulative totals, a lookup racing the job's end
  failing fast), each run on both packages.
- The legacy path end to end: a ``ServingPlane`` bound to a
  ``LocalExecutor`` job's control queue, client threads issuing
  ``lookup`` / ``lookup_batch`` / ``lookup_batch_packed`` while the job
  runs; at the held end of stream every answer equals the reference
  plane's on the reference's job, and an injected ``serving.lookup``
  fault at the executor retries in place.
- The replica path (``bind_replica``, the worker pool, the hot-row cache
  probe, ``_flush_replica``) driven by one stub adapter, the same class
  for both packages: the same sequence of lookups, publishes and probes
  gives the same answers and counters. The real adapters are held in
  ``tests/test_torch_replica.py`` and ``tests/test_torch_tenancy.py``.
Tolerance: none; answers compared with ``same_answers``.
"""

import queue
import threading
import time

import numpy as np
import pytest

import flink_tpu
import flink_tpu_torch
from flink_tpu.cluster import local_executor as jle
from flink_tpu.state.keygroups import hash_keys_to_i64 as j_hash
from flink_tpu.tenancy import serving as jserving
from flink_tpu_torch.benchmarks.held import release, settle, wait_held
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.cluster import local_executor as tle
from flink_tpu_torch.state.keygroups import hash_keys_to_i64 as t_hash
from flink_tpu_torch.tenancy import serving as tserving

from test_torch_queries import same_answers
from test_torch_queryable_state import OP, _job

SERVING = {"ref": jserving, "port": tserving}
LE = {"ref": jle, "port": tle}
HASH = {"ref": j_hash, "port": t_hash}


@pytest.fixture(params=["ref", "port"])
def sv(request):
    return SERVING[request.param]


# ------------------------------------------------------ LookupCoalescer

def test_concurrent_lookups_share_flushes(sv):
    flushes = []
    gate = threading.Event()

    def flush(keys, ns):
        gate.wait(5)
        flushes.append(list(keys))
        return [k * 10 for k in keys]

    co = sv.LookupCoalescer(flush, max_batch=64, window_ms=30.0)
    results = {}

    def worker(k):
        results[k] = co.lookup(k)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert results == {i: i * 10 for i in range(8)}
    assert co.lookups_total == 8 and len(flushes) < 8


def test_short_flush_reply_errors_every_rider(sv):
    co = sv.LookupCoalescer(lambda keys, ns: [], max_batch=8, window_ms=0.0)
    with pytest.raises(RuntimeError, match="returned 0 results"):
        co.lookup(7)
    assert co.batches_total < 8
    assert co.p99_ms() >= 0.0


def test_flush_error_fans_out_and_recovers(sv):
    calls = {"n": 0}

    def flush(keys, ns):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return list(keys)

    co = sv.LookupCoalescer(flush, window_ms=0.0)
    with pytest.raises(RuntimeError):
        co.lookup(1)
    assert co.lookup(2) == 2


def test_stats_scrape_during_concurrent_lookups(sv):
    co = sv.LookupCoalescer(lambda keys, ns: [0.0] * len(keys), max_batch=8,
                            window_ms=0.0)
    stop = threading.Event()
    errs = []

    def hammer():
        while not stop.is_set():
            co.lookup(1)

    def scrape():
        try:
            while not stop.is_set():
                s = sv.aggregate_lookup_stats([co])
                assert s["lookups_total"] >= s["lookup_batches_total"]
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = ([threading.Thread(target=hammer) for _ in range(4)]
               + [threading.Thread(target=scrape)])
    for t in threads:
        t.start()
    time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errs, errs
    assert co.stats_snapshot()[0] > 0


def test_unbind_retires_coalescers_and_keeps_totals(sv):
    plane = sv.ServingPlane(window_ms=0.0)
    for i in range(5):
        name = f"job-{i}"
        plane.bind_job(name, queue.Queue())
        plane._coalescer(name, "op").note_batch(4, 1.0)
        plane.unbind_job(name)
    assert len(plane._pool) == 0
    assert plane.lookups_total() == 20
    assert plane.lookup_batches_total() == 5
    m = plane.metrics()
    assert (m["lookups_total"], m["lookup_batches_total"]) == (20, 5)
    assert m["lookup_p99_ms"] >= 1.0


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_lookup_racing_job_completion_fails_fast(pkg):
    plane = SERVING[pkg].ServingPlane(timeout_s=5.0)

    class _TerminatingQueue(queue.Queue):
        def put(self, item, *a, **k):
            super().put(item, *a, **k)
            plane.unbind_job("gone")

    plane.bind_job("gone", _TerminatingQueue())
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="not serving"):
        plane._flush("gone", "op", [1, 2], None)
    assert time.perf_counter() - t0 < 1.0
    with pytest.raises(RuntimeError, match="not serving"):
        plane.lookup("never-bound", "op", 1)


def test_packed_lookup_result_is_a_sequence(sv):
    res = sv.PackedLookupResult.from_dicts([{1: {"v": 1.0}}, {}])
    assert len(res) == 2 and res[-1] == {} and res[0:1] == [{1: {"v": 1.0}}]
    assert list(res) == res.to_dicts() and res == [{1: {"v": 1.0}}, {}]
    with pytest.raises(IndexError):
        res[2]


# ------------------------------------------- the legacy path, end to end

def _served_job(pkg, tmp_path, clients=6):
    """A LocalExecutor job with a plane bound to its control queue; client
    threads query it while it runs; at the held cut the plane's answers
    for every key (three entry points) are returned with its metrics."""
    hold = str(tmp_path / pkg)
    env = _job(pkg, hold, flink_tpu.connectors.sinks.DiscardingSink()
               if pkg == "ref" else
               flink_tpu_torch.connectors.sinks.DiscardingSink(), "sliding",
               extra={"parallelism.default": 8})
    plane = SERVING[pkg].ServingPlane(window_ms=1.0)
    control = queue.Queue()
    plane.bind_job("serve", control)
    cfg = env.config if pkg == "port" else env._effective_config()
    graph = env.get_stream_graph()
    done = {}
    t = threading.Thread(target=lambda: done.setdefault(
        "r", LE[pkg].LocalExecutor(cfg).run(graph, "serve",
                                            control_queue=control)),
        daemon=True)
    t.start()
    stop = threading.Event()
    errors = []

    def client(i):
        rng = np.random.default_rng(i)
        while not stop.is_set():
            try:
                keys = rng.integers(0, 320, 32).tolist()
                plane.lookup_batch("serve", OP["sum"], keys)
                plane.lookup("serve", OP["sum"], int(keys[0]))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for c in threads:
        c.start()
    try:
        wait_held(hold, timeout_s=120)
        keys = list(range(320))
        batch = settle(lambda: plane.lookup_batch("serve", OP["sum"], keys))
        packed = plane.lookup_batch_packed("serve", OP["sum"], keys)
        assert packed == batch
        one = plane.lookup("serve", OP["sum"], 9)
        only = plane.lookup_batch("serve", OP["sum"], [9], max(one))
    finally:
        stop.set()
        for c in threads:
            c.join(timeout=10)
        release(hold)
        t.join(timeout=120)
        plane.unbind_job("serve")
    assert not errors, errors
    assert "r" in done
    m = plane.metrics()
    assert 0 < m["lookup_batches_total"] <= m["lookups_total"]
    return batch, one, only


def test_legacy_path_answers_equal_reference(tmp_path):
    got = _served_job("port", tmp_path)
    want = _served_job("ref", tmp_path)
    same_answers(got, want)
    batch, one, only = got
    assert batch[9] == one and len(only[0]) == 1
    assert sum(1 for a in batch if a) == 300


def test_serving_lookup_fault_via_executor_retries(tmp_path):
    """An injected ``serving.lookup`` fault at the executor (where the
    job's name matches) retries and the plane's answer is unchanged."""
    hold = str(tmp_path / "f")
    env = _job("port", hold,
               flink_tpu_torch.connectors.sinks.DiscardingSink(), "tumbling")
    plane = tserving.ServingPlane(window_ms=0.0)
    control = queue.Queue()
    plane.bind_job("qs", control)
    t = threading.Thread(target=lambda: tle.LocalExecutor(env.config).run(
        env.get_stream_graph(), "qs", control_queue=control), daemon=True)
    t.start()
    try:
        wait_held(hold, timeout_s=120)
        clean = settle(lambda: plane.lookup_batch("qs", OP["sum"], [3, 5]))
        plan = tchaos.FaultPlan(rules=[tchaos.FaultRule(
            pattern="serving.lookup", nth=1, recoverable=True,
            where={"job": "qs"})])
        with tchaos.chaos_active(plan, seed=1) as ctl:
            faulted = plane.lookup_batch("qs", OP["sum"], [3, 5])
            assert ctl.faults_injected.get("serving.lookup", 0) == 1
            assert ctl.retries >= 1
    finally:
        release(hold)
        t.join(timeout=120)
    assert faulted == clean and all(clean)


# ------------------------------------------- the replica path, one stub

class StubReplica:
    """The replica adapter interface the plane drives (``ready``,
    ``key_id``, ``generation``, ``shard_of``, ``lookup_batch``,
    ``attach_cache``, ``cold_fetch``, ``plane``), over a dict of composed
    results: ``publish`` seals a new generation and drops the changed
    keys from the attached cache (presence implies validity)."""

    def __init__(self, hash_fn, data):
        self._hash = hash_fn
        self.data = {int(self._hash(np.asarray([k]))[0]): v
                     for k, v in data.items()}
        self.gen = 1
        self.batches = 0
        self.cold_fetch = None
        self.plane = self
        self._cache = None

    def attach_cache(self, cache, job, op):
        self._cache, self._job, self._op = cache, job, op

    def ready(self):
        return True

    def key_id(self, key):
        return int(self._hash(np.asarray([key]))[0])

    def generation(self):
        return self.gen

    def shard_of(self, kid):
        return int(kid) % 4

    def lookup_batch(self, keys):
        self.batches += 1
        return [self.data.get(self.key_id(k), {}) for k in keys], self.gen

    def publish(self, updates):
        self.gen += 1
        for k, v in updates.items():
            kid = self.key_id(k)
            self.data[kid] = v
            self._cache.drop(self._job, self._op, kid)

    # the ReplicaPlane face the plane's metrics read
    def staleness_ms(self):
        return 0.0

    def counters(self):
        return {"publishes": self.gen - 1}


def _replica_session(pkg):
    plane = SERVING[pkg].ServingPlane(window_ms=0.0, workers=2)
    data = {k: {1000 * (k % 3 + 1): {"sum_v": float(k) / 7,
                                     "count": k}} for k in range(0, 200, 2)}
    ad = StubReplica(HASH[pkg], data)
    plane.bind_job("rep", queue.Queue())
    plane.bind_replica("rep", "op", ad)
    out = []
    try:
        out.append(plane.lookup("rep", "op", 4))          # miss -> worker
        out.append(plane.lookup("rep", "op", 4))          # hot-row hit
        keys = list(range(0, 60, 3))
        out.append(plane.lookup_batch("rep", "op", keys))
        out.append(plane.lookup_batch("rep", "op", keys))  # now all hits
        out.append(plane.lookup_batch_packed("rep", "op", keys).to_dicts())
        out.append(plane.lookup_batch("rep", "op", keys, 2000))
        ad.publish({4: {2000: {"sum_v": -1.5, "count": 99}}})
        out.append(plane.lookup("rep", "op", 4))
        out.append(plane.lookup_batch_packed("rep", "op", [4, 6, 7])
                   .to_dicts())
        m = plane.metrics()
        out.append((m["lookups_total"], m["replica_generations"],
                    ad.batches))
    finally:
        plane.shutdown_workers()
        plane.unbind_job("rep")
    return out


def test_replica_path_with_a_stub_adapter_equals_reference():
    got, want = _replica_session("port"), _replica_session("ref")
    same_answers(got, want)
    assert got[0] == {2000: {"sum_v": 4 / 7, "count": 4}}
    assert got[6] == {2000: {"sum_v": -1.5, "count": 99}}
    assert got[-1][2] < got[-1][0]       # hits never reached the adapter


def test_cache_probe_drop_fault_takes_the_miss_path():
    """A ``drop`` at ``serving.cache_probe`` sends the lookup to the miss
    path (the adapter answers), never a mixed value."""
    plane = tserving.ServingPlane(window_ms=0.0, workers=1)
    ad = StubReplica(t_hash, {5: {1: {"v": 2.0}}})
    plane.bind_job("rep", queue.Queue())
    plane.bind_replica("rep", "op", ad)
    try:
        assert plane.lookup("rep", "op", 5) == {1: {"v": 2.0}}
        before = ad.batches
        plan = tchaos.FaultPlan(rules=[tchaos.FaultRule(
            pattern="serving.cache_probe", nth=1, kind="drop")])
        with tchaos.chaos_active(plan, seed=3):
            assert plane.lookup("rep", "op", 5) == {1: {"v": 2.0}}
        assert ad.batches == before + 1
    finally:
        plane.shutdown_workers()
