"""Queryable state through the port's executors and control plane against
the reference's on the CPU: ``StateQueryBatchRequest`` (and
``StateQueryRequest``, a batch of one) through ``LocalExecutor`` at P=1
and P=8, the session operator, the stage executor at 4 subtasks, the
MiniCluster's Dispatcher, and ``QueryableStateClient`` (the RPC route,
the serving-plane route, the packed form, ``forget_job`` and ``stats``).
Counterparts of ``tests/test_queryable_state.py``.

Every job runs with a source that holds its end of stream
(``flink_tpu_torch/benchmarks/held.py``): once it holds, sequential
queries settle at the cut where every record was consumed, and the same
keys are queried in both packages there. Tolerance: none — answers equal
as structures, floats bit for bit, scalars of the same Python type; after
the release the jobs finish and their rows equal the reference's.
"""

import queue
import threading
import types

import numpy as np
import pytest

import flink_tpu
import flink_tpu_torch
from flink_tpu.cluster import local_executor as jle
from flink_tpu.cluster import queryable_state as jqs
from flink_tpu.cluster import stage_executor as jse
from flink_tpu.connectors import sinks as jsinks
from flink_tpu.tenancy import serving as jserving
from flink_tpu.windowing import assigners as jasg
from flink_tpu_torch.benchmarks.held import release, settle, wait_held
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.cluster import local_executor as tle
from flink_tpu_torch.cluster import queryable_state as tqs
from flink_tpu_torch.cluster import stage_executor as tse
from flink_tpu_torch.connectors import sinks as tsinks
from flink_tpu_torch.tenancy import serving as tserving
from flink_tpu_torch.windowing import assigners as tasg

from test_torch_minicluster import Port, Ref, _cluster, _ns
from test_torch_queries import same_answers

PKGS = {
    "ref": dict(mod=flink_tpu, le=jle, se=jse, sinks=jsinks, asg=jasg,
                held=Ref.HeldDataGen, qs=jqs, serving=jserving,
                conf={}),
    "port": dict(mod=flink_tpu_torch, le=tle, se=tse, sinks=tsinks,
                 asg=tasg, held=Port.HeldDataGen, qs=tqs, serving=tserving,
                 conf={"execution.device": "cpu"}),
}
TOTAL, KEYS, RATE, BATCH = 30_000, 300, 5_000, 1024


def _env(pkg, extra=None):
    p = PKGS[pkg]
    return p["mod"].StreamExecutionEnvironment(p["mod"].Configuration(
        {"execution.micro-batch.size": BATCH, **p["conf"], **(extra or {})}))


def _job(pkg, hold, sink, window="sliding", agg="sum", extra=None,
         string_keys=False, total=TOTAL, keys=KEYS):
    p = PKGS[pkg]
    env = _env(pkg, extra)
    ds = env.add_source(
        p["held"](hold, total_records=total, num_keys=keys,
                  events_per_second_of_eventtime=RATE, seed=3),
        _wm(pkg), name="gen")
    if string_keys:
        ds = ds.map(_word_column, name="words")
    keyed = ds.key_by("word" if string_keys else "key")
    if window == "session":
        w = keyed.window(p["asg"].EventTimeSessionWindows.with_gap(300))
    elif window == "sliding":
        w = keyed.window(p["asg"].SlidingEventTimeWindows.of(4000, 1000))
    else:
        w = keyed.window(p["asg"].TumblingEventTimeWindows.of(2000))
    (w.sum("value") if agg == "sum" else w.count()).sink_to(sink)
    return env


def _wm(pkg):
    mod = "flink_tpu" if pkg == "ref" else "flink_tpu_torch"
    import importlib

    return importlib.import_module(f"{mod}.runtime.watermarks") \
        .WatermarkStrategy.for_bounded_out_of_orderness(0)


def _word_column(batch):
    """A string key column (row 1's key shape) from the int keys."""
    words = np.asarray([f"w{int(k)}" for k in batch["key"]], dtype=object)
    cols = dict(batch.columns)
    cols["word"] = words
    return type(batch)(cols)


def _rows(sink):
    return sorted(tuple(r.values()) for b in sink.batches
                  for r in b.to_rows())


def _local(pkg, hold, env, queries):
    """Run ``env``'s job on the package's LocalExecutor in a thread; once
    the source holds, ``queries(ask)`` runs with ``ask(request)`` putting
    a request on the control queue and waiting for its answer; then the
    stream is released. Returns (queries' result, the sink's rows)."""
    p = PKGS[pkg]
    control = queue.Queue()
    cfg = env.config if pkg == "port" else env._effective_config()
    graph = env.get_stream_graph()
    out = {}

    def run():
        try:
            out["result"] = p["le"].LocalExecutor(cfg).run(
                graph, "qs", control_queue=control)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        wait_held(hold, timeout_s=120)

        def ask(req):
            control.put(req)
            return req.wait(timeout=30)

        got = queries(ask, p["le"])
    finally:
        release(hold)
        t.join(timeout=120)
    assert "error" not in out, out.get("error")
    return got


def _both(fn):
    return {pkg: fn(pkg) for pkg in PKGS}


OP = {"sum": "window_agg(SumAggregate)",
      "count": "window_agg(CountAggregate)"}


@pytest.mark.parametrize("parallelism", [1, 8])
@pytest.mark.parametrize("window", ["sliding", "tumbling"])
def test_local_executor_batch_query_at_held_cut(tmp_path, window,
                                                parallelism):
    """Every key (and keys never seen) in one batch, a single-key request,
    and a batch restricted to one window end."""
    keys = list(range(KEYS + 20))

    def fn(pkg):
        hold = str(tmp_path / pkg)
        sink = PKGS[pkg]["sinks"].CollectSink()
        env = _job(pkg, hold, sink, window,
                   extra={"parallelism.default": parallelism})

        def queries(ask, le):
            batch = settle(lambda: ask(le.StateQueryBatchRequest(
                OP["sum"], keys)))
            one = ask(le.StateQueryRequest(OP["sum"], 7))
            end = max(one)
            only = ask(le.StateQueryBatchRequest(OP["sum"], keys[:50], end))
            return batch, one, only

        return _local(pkg, hold, env, queries), _rows(sink)

    got = _both(fn)
    same_answers(got["port"][0], got["ref"][0])
    assert got["port"][1] == got["ref"][1] and got["port"][1]
    batch, one, only = got["port"][0]
    assert batch[7] == one and sum(1 for a in batch if a) == KEYS
    assert all(len(a) <= 1 for a in only)


def test_string_keys_meet_the_index(tmp_path):
    """String keys (row 1's shape) hash with ``hash_keys_to_i64`` at ingest
    and at query alike."""
    words = [f"w{i}" for i in range(0, KEYS + 10, 3)]

    def fn(pkg):
        hold = str(tmp_path / pkg)
        env = _job(pkg, hold, PKGS[pkg]["sinks"].DiscardingSink(), "tumbling",
                   agg="count", string_keys=True)
        return _local(pkg, hold, env, lambda ask, le: settle(
            lambda: ask(le.StateQueryBatchRequest(OP["count"], words))))

    got = _both(fn)
    same_answers(got["port"], got["ref"])
    assert sum(1 for a in got["port"] if a) == len(
        [w for w in words if int(w[1:]) < KEYS])


@pytest.mark.parametrize("parallelism", [1, 8])
def test_session_operator_queries(tmp_path, parallelism):
    def fn(pkg):
        hold = str(tmp_path / pkg)
        env = _job(pkg, hold, PKGS[pkg]["sinks"].DiscardingSink(), "session",
                   extra={"parallelism.default": parallelism})
        return _local(pkg, hold, env, lambda ask, le: settle(
            lambda: ask(le.StateQueryBatchRequest(
                OP["sum"], list(range(KEYS + 5))))))

    got = _both(fn)
    same_answers(got["port"], got["ref"])
    assert sum(1 for a in got["port"] if a) > 0


def test_unknown_operator_and_fault_retry(tmp_path):
    """An unknown operator raises ``KeyError`` naming the operators that
    exist; an injected ``serving.lookup`` fault retries in place and the
    answer is the fault-free one."""

    def fn(pkg):
        hold = str(tmp_path / pkg)
        env = _job(pkg, hold, PKGS[pkg]["sinks"].DiscardingSink(), "tumbling")

        def queries(ask, le):
            with pytest.raises(KeyError, match="available"):
                ask(le.StateQueryBatchRequest("nope", [1]))
            clean = settle(lambda: ask(le.StateQueryBatchRequest(
                OP["sum"], [1, 2, 3])))
            if pkg == "port":
                tchaos.arm(tchaos.FaultPlan(rules=[tchaos.FaultRule(
                    pattern="serving.lookup", nth=1, recoverable=True)]),
                    seed=1)
                try:
                    faulted = ask(le.StateQueryBatchRequest(
                        OP["sum"], [1, 2, 3]))
                finally:
                    c = tchaos.disarm()
                assert c.faults_injected.get("serving.lookup") == 1
                assert faulted == clean
            return clean

        return _local(pkg, hold, env, queries)

    got = _both(fn)
    same_answers(got["port"], got["ref"])


def test_stage_executor_fans_out_to_owning_subtasks(tmp_path):
    """``execution.stage-parallelism`` 4 at one source subtask without the
    local combiner: one message per owning subtask, each answering its
    part on its own thread; the answers equal the reference's stage
    executor and the port's single-slot run bit for bit."""
    keys = list(range(KEYS + 10))
    stage = {"execution.stage-parallelism": 4,
             "execution.source-parallelism": 1,
             "execution.local-agg": False}

    def fn(pkg, extra):
        hold = str(tmp_path / f"{pkg}-{len(extra)}")
        env = _job(pkg, hold, PKGS[pkg]["sinks"].DiscardingSink(),
                   "sliding", extra=extra)
        p = PKGS[pkg]
        control = queue.Queue()
        cfg = env.config if pkg == "port" else env._effective_config()
        done = {}
        executor = (p["se"].StageParallelExecutor(cfg) if extra
                    else p["le"].LocalExecutor(cfg))
        t = threading.Thread(target=lambda: done.setdefault(
            "r", executor.run(env.get_stream_graph(), "stage",
                              control_queue=control)), daemon=True)
        t.start()
        try:
            wait_held(hold, timeout_s=120)

            def ask(req):
                control.put(req)
                return req.wait(timeout=30)

            batch = settle(lambda: ask(p["le"].StateQueryBatchRequest(
                OP["sum"], keys)), rounds=6)
            one = ask(p["le"].StateQueryRequest(OP["sum"], 5))
            with pytest.raises(KeyError, match="available"):
                ask(p["le"].StateQueryBatchRequest("nope", [1]))
        finally:
            release(hold)
            t.join(timeout=120)
        assert "r" in done
        return batch, one

    port = fn("port", stage)
    same_answers(port, fn("ref", stage))
    same_answers(port, fn("port", {}))
    assert port[0][5] == port[1]


# ---------------------------------------------------- QueryableStateClient

def test_client_against_minicluster(tmp_path):
    """``get_state`` / ``get_state_batch`` / ``get_state_batch_packed``
    over the RPC route at the held cut, and the client's stats."""
    from test_torch_minicluster import _count_job, _env as _cenv

    def fn(pkg):
        ns = _ns("reference" if pkg == "ref" else "port")
        cluster = _cluster(ns)
        hold = str(tmp_path / pkg)
        try:
            env = _cenv(ns, {"execution.micro-batch.size": 512,
                             "parallelism.default": 8})
            _count_job(ns, env, ns.sinks.DiscardingSink(), 40_000, keys=200,
                       window=4000, hold_dir=hold)
            client = cluster.submit(env, "qs")
            wait_held(hold)
            qs = PKGS[pkg]["qs"].QueryableStateClient(cluster)
            op = OP["count"]
            keys = list(range(210))
            batch = settle(lambda: qs.get_state_batch(client.job_id, op,
                                                      keys))
            one = qs.get_state(client.job_id, op, 11)
            packed = qs.get_state_batch_packed(client.job_id, op, keys)
            assert packed == batch and packed.to_dicts() == batch
            with pytest.raises(KeyError):
                qs.get_state(client.job_id, "nope", 3)
            stats = qs.stats()
            qs.forget_job(client.job_id)
            release(hold)
            assert client.wait(timeout=60)["status"] == "FINISHED"
            return batch, one, stats["lookup_batches_total"] >= 3
        finally:
            cluster.shutdown()

    got = _both(fn)
    same_answers(got["port"], got["ref"])
    assert got["port"][0][11] == got["port"][1]
    assert sum(1 for a in got["port"][0] if a) == 200


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_forget_job_drops_coalescers_keeps_totals(pkg):
    client = PKGS[pkg]["qs"].QueryableStateClient(cluster=None)
    for i in range(4):
        jid = f"job-{i}"
        client._coalescer(jid, "op").note_batch(3, 1.0)
        client.forget_job(jid)
    assert len(client._pool) == 0
    s = client.stats()
    assert (s["lookups_total"], s["lookup_batches_total"],
            s["avg_batch_size"]) == (12, 4, 3.0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_lookup_racing_retire_folds_into_retained_totals(pkg):
    client = PKGS[pkg]["qs"].QueryableStateClient(cluster=None)
    co = client._coalescer("job", "op")
    co.note_batch(2, 1.0)
    client.forget_job("job")
    co.note_batch(3, 1.0)
    assert len(client._pool) == 0
    s = client.stats()
    assert (s["lookups_total"], s["lookup_batches_total"]) == (5, 2)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_explicit_batch_recorded_in_client_stats(pkg):
    gw = types.SimpleNamespace(
        query_state_batch=lambda j, o, keys, ns: [{}] * len(keys))
    cluster = types.SimpleNamespace(dispatcher_gateway=lambda: gw)
    client = PKGS[pkg]["qs"].QueryableStateClient(cluster)
    client.get_state_batch("j", "op", [1, 2, 3])
    s = client.stats()
    assert (s["lookups_total"], s["lookup_batches_total"],
            s["avg_batch_size"]) == (3, 1, 3.0)


def _plane_cluster(pkg, served):
    packed = PKGS[pkg]["serving"].PackedLookupResult

    class _Plane:
        def lookup_batch(self, job, op, keys, namespace=None):
            served.append(("dict", job, op, list(keys)))
            return [{1: {"v": float(k)}} for k in keys]

        def lookup_batch_packed(self, job, op, keys):
            served.append(("packed", job, op, list(keys)))
            return packed.from_dicts([{1: {"v": float(k)}} for k in keys])

        def lookup(self, job, op, key, namespace=None):
            served.append(("point", job, op, key))
            return {1: {"v": float(key)}}

    def _gw():
        raise AssertionError("RPC gateway used despite a plane")

    return types.SimpleNamespace(serving=_Plane(), dispatcher_gateway=_gw)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_client_routes_through_a_serving_plane(pkg):
    served = []
    client = PKGS[pkg]["qs"].QueryableStateClient(
        _plane_cluster(pkg, served))
    assert client.get_state_batch("j", "op", [1, 2]) == [
        {1: {"v": 1.0}}, {1: {"v": 2.0}}]
    assert served[0][0] == "dict"
    assert client.get_state("j", "op", 7) == {1: {"v": 7.0}}
    assert served[-1][0] == "point"
    assert client.stats()["lookups_total"] == 3
    res = client.get_state_batch_packed("j", "op", [3, 4, 5])
    assert isinstance(res, PKGS[pkg]["serving"].PackedLookupResult)
    assert len(res) == 3 and res[1] == {1: {"v": 4.0}}
    assert res == client.get_state_batch("j", "op", [3, 4, 5])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_packed_wraps_an_rpc_cluster(pkg):
    gw = types.SimpleNamespace(
        query_state_batch=lambda j, o, keys, ns: [{0: {"v": 1.0}}] * len(
            keys))
    client = PKGS[pkg]["qs"].QueryableStateClient(
        types.SimpleNamespace(dispatcher_gateway=lambda: gw))
    res = client.get_state_batch_packed("j", "op", [1, 2])
    assert res.to_dicts() == [{0: {"v": 1.0}}] * 2


def test_group_agg_operator_query_state():
    """``GroupAggOperator.query_state`` (the SQL ``GROUP BY`` operator)
    over its table's ``query``: every namespace or one, equal to the
    reference's operator on the same batches, keys never seen empty."""
    from flink_tpu.core.records import RecordBatch as JBatch
    from flink_tpu.runtime.group_agg import GroupAggOperator as JOp
    from flink_tpu.windowing import aggregates as jagg
    from flink_tpu_torch.core.records import RecordBatch as TBatch
    from flink_tpu_torch.runtime.group_agg import GroupAggOperator as TOp
    from flink_tpu_torch.windowing import aggregates as tagg

    qkeys = np.random.default_rng(18).integers(0, 60, 30).tolist()
    got = {}
    for name, Op, agg, Batch in (("ref", JOp, jagg, JBatch),
                                 ("port", TOp, tagg, TBatch)):
        op = Op(agg.MultiAggregate([agg.SumAggregate("v", output="s"),
                                    agg.CountAggregate(output="n")]), "k")
        op.open(types.SimpleNamespace(max_parallelism=128, device="cpu",
                                      memory_manager=None))
        r = np.random.default_rng(7)
        for b in range(3):
            keys = r.integers(0, 50, 400).astype(np.int64)
            op.process_batch(Batch({
                "__key_id__": keys, "k": keys,
                "__ts__": np.full(400, b, np.int64),
                "v": r.standard_normal(400).astype(np.float32)}))
        got[name] = [op.query_state(k) for k in qkeys]
        got[name].append(op.query_state(3, 0))
    same_answers(got["port"], got["ref"])
    assert sum(1 for a in got["port"] if a) > 20
