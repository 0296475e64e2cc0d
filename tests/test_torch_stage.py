"""The stage executor (``execution.stage-parallelism``) of the port against
the reference's ``StageParallelExecutor`` on the CPU: the reference's
``test_stage_parallel.py``, ``test_multi_stage.py``,
``test_stage_joins.py``, ``test_unaligned_checkpoint.py`` and
``test_sort_merge_shuffle.py`` run through both packages.

Tolerances: none. Float sums are compared bit for bit where each key's
records reach their subtask in stream order, which holds at
``execution.source-parallelism=1``; at S > 1 the reference's own result
depends on how the source channels interleave, so those jobs count
(integer results, equal exactly) or compare multisets of join rows.
Sink rows are compared as sorted lists: the subtasks share one sink and
write in thread order. A merged checkpoint is compared with the
reference's through ``convert.py``.
"""

import importlib
import queue
import threading
import time

import numpy as np
import pytest

import flink_tpu
import flink_tpu_torch

PKGS = {"ref": "flink_tpu", "port": "flink_tpu_torch"}


def mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _env(pkg, stage_par, extra=None):
    conf = {"execution.micro-batch.size": 1000,
            "state.slot-table.capacity": 8192}
    if stage_par:
        conf["execution.stage-parallelism"] = stage_par
    if pkg == "port":
        conf["execution.device"] = "cpu"
    conf.update(extra or {})
    top = flink_tpu if pkg == "ref" else flink_tpu_torch
    return top.StreamExecutionEnvironment(top.Configuration(conf))


def _datagen(pkg, total=20_000, keys=200, seed=5, rate=10_000):
    return mod(pkg, "connectors.sources").DataGenSource(
        total_records=total, num_keys=keys,
        events_per_second_of_eventtime=rate, seed=seed)


def _wm(pkg):
    return mod(pkg, "runtime.watermarks").WatermarkStrategy \
        .for_bounded_out_of_orderness(0)


def _assigner(pkg, kind):
    a = mod(pkg, "windowing.assigners")
    return {"tumble": lambda: a.TumblingEventTimeWindows.of(1000),
            "slide": lambda: a.SlidingEventTimeWindows.of(2000, 500),
            "session": lambda: a.EventTimeSessionWindows.with_gap(40)}[kind]()


class FailingMap:
    """Raises after letting ``fail_after`` records through."""

    def __init__(self, fail_after):
        self.seen = 0
        self.fail_after = fail_after

    def __call__(self, batch):
        self.seen += len(batch)
        if self.seen > self.fail_after:
            raise RuntimeError("injected failure")
        return batch


def _window_job(pkg, env, sink, kind="tumble", total=20_000, keys=200,
                fail_after=None, agg="sum"):
    ds = env.from_source(_datagen(pkg, total, keys), _wm(pkg))
    # the failing map's name is the same in the crashed and the restored
    # graph: the checkpoint's operator ids must match
    ds = ds.map(FailingMap(fail_after) if fail_after else (lambda b: b),
                name="failmap")
    w = ds.key_by("key").window(_assigner(pkg, kind))
    (w.sum("value") if agg == "sum" else w.count()).sink_to(sink)


def _sink(pkg):
    return mod(pkg, "connectors.sinks").CollectSink()


def _rows(sink):
    return sorted(tuple(sorted(r.items())) for r in sink.rows())


def _run(pkg, stage_par, build, extra=None, job="job", **kw):
    env = _env(pkg, stage_par, extra)
    sink = _sink(pkg)
    build(pkg, env, sink, **kw)
    result = env.execute(job)
    return sink, result


# --------------------------------------------------------------- shuffle SPI


def test_local_credit_flow_blocks_without_credit():
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.runtime.shuffle_spi import LocalShuffleService

    svc = LocalShuffleService()
    w = svc.create_partition("p0", 2, credits_per_channel=2)
    gate0 = svc.create_gate(["p0"], 0)
    b = RecordBatch.from_pydict({"x": np.arange(4)})
    w.emit(0, b)
    w.emit(0, b)
    done = threading.Event()

    def third():
        w.emit(0, b)
        done.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not done.wait(0.2), "emit must block with no credit left"
    ch, item = gate0.poll(timeout=1)
    assert ch == 0 and len(item) == 4
    assert done.wait(2), "a consumed batch grants the credit back"
    t.join(timeout=2)
    assert not t.is_alive()


def test_events_ride_credit_free():
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.runtime.shuffle_spi import (
        END_OF_PARTITION,
        LocalShuffleService,
    )

    svc = LocalShuffleService()
    w = svc.create_partition("p1", 1, credits_per_channel=1)
    gate = svc.create_gate(["p1"], 0)
    w.emit(0, RecordBatch.from_pydict({"x": np.arange(2)}))
    w.broadcast_event(77)
    w.close()
    assert isinstance(gate.poll(timeout=1)[1], RecordBatch)
    assert gate.poll(timeout=1)[1] == 77
    assert gate.poll(timeout=1)[1] is END_OF_PARTITION


@pytest.mark.parametrize("name,exc,match", [
    ("netty", ValueError, "unknown shuffle.service"),
    ("grpc", NotImplementedError, "Queue A item 12c"),
])
def test_unknown_and_unported_services_raise(name, exc, match):
    from flink_tpu_torch.runtime.shuffle_spi import create_shuffle_service

    with pytest.raises(exc, match=match):
        create_shuffle_service(name)


PARTITIONERS = {
    "KeyGroupPartitioner": ("__key_id__", 128),
    "RebalancePartitioner": (),
    "ForwardPartitioner": (1,),
    "BroadcastPartitioner": (),
    "RescalePartitioner": (1, 2),
}


@pytest.mark.parametrize("pname", sorted(PARTITIONERS))
def test_partitioners_split_like_the_reference(pname):
    """The five partitioners give the reference's sub-batches."""
    rng = np.random.default_rng(3)
    cols = {"__key_id__": rng.integers(0, 10_000, 500).astype(np.int64),
            "v": rng.random(500)}
    outs = {}
    for pkg in PKGS:
        spi = mod(pkg, "runtime.shuffle_spi")
        rb = mod(pkg, "core.records").RecordBatch
        part = getattr(spi, pname)(*PARTITIONERS[pname])
        got = []
        for _ in range(2):  # round robin advances between calls
            for sub, b in part.partition(rb(dict(cols)), 4):
                got.append((sub, {k: np.asarray(v).tolist()
                                  for k, v in b.columns.items()}))
        outs[pkg] = got
    assert outs["port"] == outs["ref"]


# ------------------------------------------------------------ the planner


def test_plan_has_two_stages_like_the_reference():
    plans = {}
    for pkg in PKGS:
        env = _env(pkg, 0)
        sink = _sink(pkg)
        _two_stage_job(pkg, env, sink, total=100, keys=5)
        plan = mod(pkg, "cluster.stage_executor").plan_stages(
            env.get_stream_graph())
        plans[pkg] = [([t.name for t in st.chain], st.out_key_field,
                       [o.target_stage for o in st.outputs])
                      for st in plan.stages]
    assert plans["port"] == plans["ref"]
    assert len(plans["port"]) == 2


def test_unsupported_shape_fails_by_default_and_falls_back_when_asked():
    from flink_tpu_torch.cluster.stage_executor import StagePlanError

    def stateless(pkg, env, sink):
        env.from_source(_datagen(pkg, 100, 5), _wm(pkg)) \
            .map(lambda b: b).sink_to(sink)

    with pytest.raises(StagePlanError, match="stage-fallback"):
        _run("port", 2, stateless)
    with pytest.warns(UserWarning, match="no keyed exchange"):
        sink, result = _run("port", 2, stateless,
                            extra={"execution.stage-fallback": True})
    assert len(sink.rows()) == 100
    assert "no keyed exchange" in result.metrics["stage_fallback"]


# ------------------------------------------------------------------- jobs


@pytest.mark.parametrize("kind", ["tumble", "slide", "session"])
def test_window_job_rows_equal_the_reference(kind):
    """4 subtasks, S=1: float sums bit for bit. The local combiner sums
    each batch's (key, slice) rows before the exchange, so the single-slot
    run's bits come back without it."""
    got = {pkg: _run(pkg, 4, _window_job, kind=kind) for pkg in PKGS}
    assert _rows(got["port"][0]) == _rows(got["ref"][0])
    single, _ = _run("port", 0, _window_job, kind=kind)
    no_combine, _ = _run("port", 4, _window_job, kind=kind,
                         extra={"execution.local-agg": False})
    assert _rows(no_combine) == _rows(single)
    for key in ("records", "records_shuffled", "subtask_records_in",
                "stage_parallelism", "source_parallelism"):
        assert got["port"][1].metrics[key] == got["ref"][1].metrics[key], key


def test_routing_metrics_and_local_combiner():
    """Every subtask takes only its key groups; the combiner shrinks the
    exchange; without it every record crosses."""
    _, res = _run("port", 4, _window_job)
    per = res.metrics["subtask_records_in"]
    assert len(per) == 4 and all(c > 0 for c in per)
    assert sum(per) == res.metrics["records_shuffled"]
    assert res.metrics["records_shuffled"] < res.metrics["records"]
    _, res2 = _run("port", 4, _window_job,
                   extra={"execution.local-agg": False})
    assert res2.metrics["records_shuffled"] == res2.metrics["records"]


def test_source_parallelism_two_counts_equal_the_reference():
    """S=2: the channels interleave as the threads fall, so the job
    counts (exact at any interleaving)."""
    extra = {"execution.source-parallelism": 2}
    got = {pkg: _run(pkg, 3, _window_job, extra=extra, agg="count")
           for pkg in PKGS}
    assert _rows(got["port"][0]) == _rows(got["ref"][0])
    assert got["port"][1].metrics["records"] == 20_000


def _two_stage_job(pkg, env, sink, total=20_000, keys=200, fail_after=None):
    a = mod(pkg, "windowing.assigners")
    ds = env.from_source(_datagen(pkg, total, keys), _wm(pkg))
    ds = ds.map(FailingMap(fail_after) if fail_after else (lambda b: b),
                name="failmap")
    (ds.key_by("key").window(a.TumblingEventTimeWindows.of(1000))
       .count()
       .key_by("window_start").window(a.TumblingEventTimeWindows.of(1000))
       .sum("count")
       .sink_to(sink))


def test_two_exchange_pipeline_equals_the_reference():
    extra = {"execution.source-parallelism": 2}
    got = {pkg: _run(pkg, 4, _two_stage_job, extra=extra) for pkg in PKGS}
    single, _ = _run("port", 0, _two_stage_job)
    assert _rows(got["port"][0]) == _rows(got["ref"][0]) == _rows(single)
    assert got["port"][1].metrics["keyed_stages"] == 2
    assert got["port"][1].metrics["per_stage_records_in"][0] == \
        got["ref"][1].metrics["per_stage_records_in"][0]


def test_side_output_from_a_keyed_stage_equals_the_reference():
    def build(pkg, env, sink, side):
        proc = mod(pkg, "runtime.process")
        big = proc.OutputTag("big")

        class SplitBig(proc.ProcessFunction):
            def process_batch(self, batch, ctx):
                is_big = batch["count"] > 100
                ctx.output(big, batch.filter(is_big))
                ctx.collect(batch.filter(~is_big))

        m = (env.from_source(_datagen(pkg, 20_000, 100), _wm(pkg))
             .key_by("key").window(_assigner(pkg, "tumble")).count()
             .process(SplitBig()))
        m.sink_to(sink)
        m.get_side_output(big).sink_to(side)

    out = {}
    for pkg in PKGS:
        env = _env(pkg, 4, {"execution.source-parallelism": 2})
        main, side = _sink(pkg), _sink(pkg)
        build(pkg, env, main, side)
        env.execute("side")
        out[pkg] = (_rows(main), _rows(side))
    assert out["port"] == out["ref"]
    assert out["port"][0] and out["port"][1]


def test_q7_diamond_equals_the_reference_and_its_oracle():
    rows = {}
    for pkg in PKGS:
        nx = mod(pkg, "benchmarks.nexmark")
        env = _env(pkg, 4, {"execution.source-parallelism": 2})
        sink = _sink(pkg)
        nx.build_q7(env, nx.BidSource(total_records=20_000, num_auctions=50,
                                      events_per_second_of_eventtime=10_000),
                    size_ms=2_000).sink_to(sink)
        env.execute("q7")
        rows[pkg] = sorted((int(r["window_end"]), int(r["auction"]),
                            float(r["price"])) for r in sink.rows())
    assert rows["port"] == rows["ref"] and rows["port"]
    from flink_tpu_torch.benchmarks.nexmark import BidSource, oracle_q7

    src = BidSource(total_records=20_000, num_auctions=50,
                    events_per_second_of_eventtime=10_000)
    src.open(0, 1)
    bids = []
    while (b := src.poll_batch(10_000)) is not None:
        bids += list(zip(b["auction"].tolist(), b["bidder"].tolist(),
                         b["price"].tolist(), b.timestamps.tolist()))
    oracle = oracle_q7(bids, 2_000)
    by_window = {}
    for we, auction, _ in rows["port"]:
        by_window.setdefault(we, set()).add(auction)
    for we, auctions in by_window.items():
        assert auctions == {a for a, _ in oracle[we][1]}, we


def test_mesh_by_stage_equals_the_reference():
    """Two subtasks, each over a four-shard engine of its own key-group
    range on the one device."""
    extra = {"execution.stage-mesh-devices": 4}
    got = {pkg: _run(pkg, 2, _window_job, extra=extra) for pkg in PKGS}
    assert _rows(got["port"][0]) == _rows(got["ref"][0])
    single, _ = _run("port", 0, _window_job)
    no_combine, _ = _run("port", 2, _window_job,
                         extra={**extra, **NO_COMBINE})
    assert _rows(no_combine) == _rows(single)


def _window_join(pkg, env, sink):
    a = env.from_source(_datagen(pkg, 5_000, 60, seed=3), _wm(pkg))
    b = env.from_source(_datagen(pkg, 2_500, 60, seed=4, rate=5_000),
                        _wm(pkg))
    (a.join(b).where("key").equal_to("key")
     .window(_assigner(pkg, "tumble"))
     .apply(name="stage_join").sink_to(sink))


def _interval_join(pkg, env, sink):
    a = env.from_source(_datagen(pkg, 3_000, 40, seed=5), _wm(pkg))
    b = env.from_source(_datagen(pkg, 3_000, 40, seed=6), _wm(pkg))
    (a.key_by("key").interval_join(b.key_by("key"))
     .between(-100, 100).sink_to(sink))


@pytest.mark.parametrize("build", [_window_join, _interval_join],
                         ids=["window", "interval"])
def test_joins_equal_the_reference(build):
    """Two-input keyed stages at S=2 (join rows as multisets)."""
    extra = {"execution.source-parallelism": 2}
    got = {pkg: _run(pkg, 3, build, extra=extra)[0] for pkg in PKGS}
    assert _rows(got["port"]) == _rows(got["ref"])
    assert len(got["port"].rows()) > 0


def test_adaptive_parallelism_in_batch_mode_equals_the_reference():
    extra = {"execution.runtime-mode": "batch",
             "execution.batch.target-records-per-subtask": 6_000}
    got = {pkg: _run(pkg, -1, _window_job, extra=extra) for pkg in PKGS}
    assert _rows(got["port"][0]) == _rows(got["ref"][0])
    assert got["port"][1].metrics["stage_parallelism"] == \
        got["ref"][1].metrics["stage_parallelism"] == 4
    from flink_tpu_torch.cluster.stage_executor import StagePlanError

    with pytest.raises(StagePlanError, match="requires"):
        _run("port", -1, _window_job)


# ------------------------------------------------------------ checkpoints


#: the restore tests fold every record raw (no local combiner), so the
#: crashed and restored runs together give the clean run's bits
NO_COMBINE = {"execution.local-agg": False}


def _by_window(*sinks):
    """The committed result of runs that may re-emit a window after a
    restore: the last row of each (key, window) wins, as the reference's
    recovery tests merge them."""
    out = {}
    for sink in sinks:
        for r in sink.rows():
            out[(r["key"], r["window_start"], r["window_end"])] = r
    return {k: tuple(sorted(v.items())) for k, v in out.items()}


def _crash(pkg, ckpt, stage_par, build=_window_job, extra=None, **kw):
    conf = {"state.checkpoints.dir": ckpt,
            "execution.checkpointing.every-n-source-batches": 5,
            **NO_COMBINE, **(extra or {})}
    env = _env(pkg, stage_par, conf)
    sink = _sink(pkg)
    build(pkg, env, sink, fail_after=14_000, **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        env.execute("crashing")
    return sink


def _restore(pkg, ckpt, stage_par, extra=None, **kw):
    env = _env(pkg, stage_par, {**NO_COMBINE, **(extra or {})})
    sink = _sink(pkg)
    _window_job(pkg, env, sink, **kw)
    return sink, env.execute("restored", restore_from=ckpt)


def _clean(pkg, **kw):
    return _by_window(_run(pkg, 0, _window_job, **kw)[0])


def test_crash_restore_matches_the_clean_run(tmp_path):
    """Crash at 4 subtasks, restore at 4: the two runs together give the
    reference's clean rows bit for bit, equal the reference's own crash and
    restore, and the restore reports its time."""
    want = _clean("ref", kind="slide")
    got = {}
    for pkg in PKGS:
        ckpt = str(tmp_path / pkg)
        crashed = _crash(pkg, ckpt, 4, kind="slide")
        assert mod(pkg, "checkpoint.storage").CheckpointStorage(
            ckpt).latest_checkpoint_id() is not None
        sink, res = _restore(pkg, ckpt, 4, kind="slide")
        got[pkg] = _by_window(crashed, sink)
        if pkg == "port":
            assert res.metrics["restore_ms"] > 0
    assert got["port"] == got["ref"] == want == _clean("port", kind="slide")


@pytest.mark.parametrize("par", [2, 0], ids=["two-subtasks", "single-slot"])
def test_restore_across_subtask_counts(tmp_path, par):
    """A checkpoint of 4 subtasks restores at 2 and single-slot (key-group
    re-filtering), bit for bit against the reference's clean run and its
    own restore of its own checkpoint at the same count."""
    got = {}
    for pkg in PKGS:
        ckpt = str(tmp_path / pkg)
        crashed = _crash(pkg, ckpt, 4, kind="slide")
        got[pkg] = _by_window(crashed, _restore(pkg, ckpt, par,
                                                kind="slide")[0])
    assert got["port"] == got["ref"] == _clean("ref", kind="slide")

def _savepoint_at_batch(pkg, path, at_batch, stage_par=4):
    """A 4-subtask job whose source queues a savepoint as it hands out
    batch ``at_batch`` and then idles until the barrier has cut it: the
    savepoint covers exactly the first ``at_batch`` batches in both
    packages."""
    src_mod = mod(pkg, "connectors.sources")
    le = mod(pkg, "cluster.local_executor")
    q = queue.Queue()
    req = le.SavepointRequest(path)

    class SavepointSource(src_mod.DataGenSource):
        polled = 0
        idle_until = None

        def poll_batch(self, n):
            if self.idle_until is not None:
                if time.monotonic() < self.idle_until:
                    return self.empty_batch()
                self.idle_until = None
            self.polled += 1
            if self.polled == at_batch + 1:
                q.put(req)
                self.idle_until = time.monotonic() + 0.5
                return self.empty_batch()
            return super().poll_batch(n)

        def empty_batch(self):
            rb = mod(pkg, "core.records").RecordBatch
            return rb.from_pydict({"key": np.zeros(0, np.int64)})

    env = _env(pkg, stage_par, NO_COMBINE)
    sink = _sink(pkg)
    (env.from_source(SavepointSource(total_records=20_000, num_keys=200,
                                     events_per_second_of_eventtime=10_000,
                                     seed=5), _wm(pkg))
        .key_by("key").window(_assigner(pkg, "slide")).sum("value")
        .sink_to(sink))
    mod(pkg, "cluster.stage_executor").StageParallelExecutor(
        env.config).run(env.get_stream_graph(), "sp", control_queue=q)
    return req.wait(timeout=60)


def test_merged_checkpoint_equals_the_references(tmp_path):
    """Both packages cut a savepoint of the same 4-subtask job after the
    same batch; its merged state (the single-slot format) is the
    reference's, read through ``convert.py``, bit for bit."""
    from flink_tpu_torch.checkpoint.storage import read_checkpoint_chain
    from flink_tpu_torch.convert import from_jax_checkpoint_state
    from flink_tpu.checkpoint.storage import \
        read_checkpoint_chain as j_read

    paths = {pkg: _savepoint_at_batch(pkg, str(tmp_path / pkg), 9)
             for pkg in PKGS}
    got = _canonical(read_checkpoint_chain(paths["port"]))
    want = _canonical(from_jax_checkpoint_state(j_read(paths["ref"])))
    assert sorted(got) == sorted(want)
    _assert_state_equal(got, want)
    rows = sum(len(v["windower"]["table"]["key_id"]) for v in got.values()
               if isinstance(v, dict) and "windower" in v)
    assert rows > 0


def _canonical(state):
    """The subtasks' table rows concatenate in ack order (thread timing,
    in both packages): order every row table by (key, namespace)."""
    if not isinstance(state, dict):
        return state
    out = {k: _canonical(v) for k, v in state.items()}
    if "key_id" in out and "namespace" in out:
        order = np.lexsort((np.asarray(out["namespace"]),
                            np.asarray(out["key_id"])))
        n = len(order)
        for k, v in out.items():
            if isinstance(v, np.ndarray) and v.shape[:1] == (n,):
                out[k] = v[order]
    return out


def _assert_state_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, path
        if x.dtype.kind == "f":
            assert x.tobytes() == y.astype(x.dtype).tobytes(), path
        else:
            assert x.tolist() == y.tolist(), path
    else:
        assert a == b, path


def test_unaligned_checkpoint_restores_rows_once_each(tmp_path):
    """Unaligned barriers overtake queued batches; the overtaken batches
    are channel state and replay on restore. Both packages crash and
    restore; each gives the reference's clean rows once each."""
    extra = {"execution.checkpointing.unaligned": True,
             "shuffle.credits-per-channel": 4}
    got = {}
    for pkg in PKGS:
        ckpt = str(tmp_path / pkg)
        crashed = _crash(pkg, ckpt, 4, extra=extra)
        got[pkg] = _by_window(crashed, _restore(pkg, ckpt, 4, extra)[0])
    assert got["port"] == got["ref"] == _clean("ref") == _clean("port")


def _stop_and_resume(pkg, path):
    """Savepoint-and-stop a 3-subtask count job a little way in, resume it
    at 2 subtasks: the rows of both runs."""
    class SlowSource(mod(pkg, "connectors.sources").DataGenSource):
        def poll_batch(self, n):
            time.sleep(0.002)
            return super().poll_batch(n)

    def build(env, sink):
        (env.from_source(SlowSource(total_records=60_000, num_keys=200,
                                    events_per_second_of_eventtime=10_000,
                                    seed=5), _wm(pkg))
           .map(lambda b: b, name="failmap")
           .key_by("key").window(_assigner(pkg, "tumble")).count()
           .sink_to(sink))

    env = _env(pkg, 3)
    sink = _sink(pkg)
    build(env, sink)
    q = queue.Queue()
    req = mod(pkg, "cluster.local_executor").SavepointRequest(path, stop=True)
    threading.Timer(0.15, q.put, args=(req,)).start()
    res = mod(pkg, "cluster.stage_executor").StageParallelExecutor(
        env.config).run(env.get_stream_graph(), "stopped", control_queue=q)
    assert res.metrics["savepoint"] == req.wait(timeout=60)
    env2 = _env(pkg, 2)
    sink2 = _sink(pkg)
    build(env2, sink2)
    env2.execute("resumed", restore_from=req.result)
    return sorted(_rows(sink) + _rows(sink2))


def test_savepoint_and_stop_then_resume(tmp_path):
    """Each package stops with a savepoint and resumes; the stop falls on
    a timer, so each run is held to the reference's clean counts (exact
    at any cut) and not to the other's cut."""
    want = _rows(_run("ref", 0, _window_job, total=60_000, agg="count")[0])
    assert want == _rows(_run("port", 0, _window_job, total=60_000,
                              agg="count")[0])
    for pkg in PKGS:
        assert _stop_and_resume(pkg, str(tmp_path / pkg)) == want, pkg


# ---------------------------------------------------- sort-merge shuffle


def test_sort_merge_unit_round_trip():
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.runtime.shuffle_spi import (
        END_OF_PARTITION,
        create_shuffle_service,
    )

    svc = create_shuffle_service("sort-merge")
    w = svc.create_partition("p", 2)
    gates = [svc.create_gate(["p"], j) for j in range(2)]
    for i in range(3):
        w.emit(i % 2, RecordBatch.from_pydict(
            {"x": np.arange(i * 10, i * 10 + 5)}))
    w.broadcast_event(5)
    w.close()
    for j, gate in enumerate(gates):
        items = []
        while True:
            e = gate.poll(timeout=1)
            assert e is not None
            items.append(e[1])
            if e[1] is END_OF_PARTITION:
                break
        # a region flush concatenates a subpartition's buffered batches
        xs = [x for b in items if isinstance(b, RecordBatch)
              for x in np.asarray(b["x"]).tolist()]
        want = [x for i in range(3) if i % 2 == j
                for x in range(i * 10, i * 10 + 5)]
        assert xs == want
        assert 5 in items
    svc.close()


def test_sort_merge_batch_job_equals_the_reference():
    extra = {"execution.runtime-mode": "batch",
             "shuffle.service": "sort-merge"}
    got = {pkg: _run(pkg, 3, _window_job, extra=extra) for pkg in PKGS}
    local, _ = _run("port", 3, _window_job,
                    extra={"execution.runtime-mode": "batch"})
    assert _rows(got["port"][0]) == _rows(got["ref"][0]) == _rows(local)
