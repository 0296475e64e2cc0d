"""Process functions of the port against the reference's on the CPU: side
outputs, keyed state with event-time and processing-time timers, timer
dedup and delete, value/map/list state, snapshot and restore (across the
two packages too), co-process, the broadcast-state pattern, and async I/O
ordered, unordered and with a timeout — every case of
``tests/test_process.py`` but the running sum (ROADMAP item 11b). Each
job runs through both packages on the same rows, and the outputs are
equal row for row, in order (tolerance: none). The ``CountWithTimeout``
job of ``flink_tpu_torch/benchmarks/process_timeout.py`` (chip_smoke phase
19(a)) runs at 20,000 records over 5,000 keys in batches of 512 through
both packages, sync and async, and against its NumPy oracle.
"""

import time

import numpy as np
import pytest
import torch

import flink_tpu
import flink_tpu_torch
from flink_tpu.connectors import sinks as jsinks
from flink_tpu.core.records import RecordBatch as JBatch
from flink_tpu.runtime import async_operator as jasync
from flink_tpu.runtime import process as jproc
from flink_tpu.runtime.operators import OperatorContext as JCtx
from flink_tpu.state import async_state as jas
from flink_tpu.state import keyed_state as jks
from flink_tpu_torch.benchmarks import process_timeout as pt
from flink_tpu_torch.connectors import sinks as tsinks
from flink_tpu_torch.core.records import RecordBatch as TBatch
from flink_tpu_torch.runtime import async_operator as tasync
from flink_tpu_torch.runtime import process as tproc
from flink_tpu_torch.runtime.operators import OperatorContext as TCtx
from flink_tpu_torch.state import keyed_state as tks

PKG = {
    "ref": dict(mod=flink_tpu, sinks=jsinks, Batch=JBatch, proc=jproc,
                ks=jks, asy=jasync, Ctx=lambda: JCtx(),
                conf={"execution.pipeline.in-flight-batches": 0}),
    "port": dict(mod=flink_tpu_torch, sinks=tsinks, Batch=TBatch,
                 proc=tproc, ks=tks, asy=tasync,
                 Ctx=lambda: TCtx(device="cpu"),
                 conf={"execution.device": "cpu",
                       "execution.pipeline.in-flight-batches": 0}),
}


def _env(pkg, **conf):
    p = PKG[pkg]
    base = {"execution.micro-batch.size": 4, **p["conf"]}
    base.update(conf)
    return p["mod"].StreamExecutionEnvironment(p["mod"].Configuration(base))


def _rows(n, key_mod=2):
    return [{"k": i % key_mod, "v": float(i), "ts": i * 1000}
            for i in range(n)]


def _both(job):
    """``job(pkg)`` in both packages: the port's rows (a list of dicts
    per output) equal to the reference's, in order."""
    out = {pkg: job(pkg) for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    return out["port"]


def _collected(sink):
    return [r for b in sink.batches for r in b.to_rows()]


# --------------------------------------------------------------- side output


def _split_even_odd(pkg):
    p = PKG[pkg]

    class SplitEvenOdd(p["mod"].ProcessFunction):
        ODD = p["mod"].OutputTag("odd")

        def process_batch(self, batch, ctx):
            even = batch["v"].astype(np.int64) % 2 == 0
            ctx.collect(batch.filter(even))
            ctx.output(self.ODD, batch.filter(~even))

    return SplitEvenOdd


def test_side_output_routing():
    def job(pkg):
        fn = _split_even_odd(pkg)
        env = _env(pkg)
        s = env.from_collection(_rows(10), timestamp_field="ts")
        main = s.process(fn())
        side_sink, main_sink = PKG[pkg]["sinks"].CollectSink(), \
            PKG[pkg]["sinks"].CollectSink()
        main.get_side_output(fn.ODD).sink_to(side_sink)
        main.sink_to(main_sink)
        env.execute()
        return _collected(main_sink), _collected(side_sink)

    main, side = _both(job)
    assert sorted(r["v"] for r in main) == [0, 2, 4, 6, 8]
    assert sorted(r["v"] for r in side) == [1, 3, 5, 7, 9]


def test_side_output_by_tag_name_and_main_output_skips_side_edges():
    def job(pkg):
        fn = _split_even_odd(pkg)
        env = _env(pkg)
        main = env.from_collection(_rows(10), timestamp_field="ts") \
            .process(fn())
        side_sink = PKG[pkg]["sinks"].CollectSink()
        main.get_side_output("odd").sink_to(side_sink)
        main.get_side_output("nothing").sink_to(
            PKG[pkg]["sinks"].CollectSink())
        result = env.execute()
        counts = {k.split("#")[0]: v["records_in"]
                  for k, v in result.metrics["per_operator"].items()}
        return _collected(side_sink), counts

    side, counts = _both(job)
    assert [r["v"] for r in side] == [1.0, 3.0, 5.0, 7.0, 9.0]
    assert counts["side_output(nothing)"] == 0


# ------------------------------------------------------- keyed state + timer


def _count_then_flush(pkg):
    p = PKG[pkg]

    class CountThenFlushAtTimer(p["mod"].KeyedProcessFunction):
        COUNT = p["mod"].ReducingStateDescriptor("count", np.add, np.int64,
                                                 0)

        def process_batch(self, batch, ctx):
            kid = batch.key_ids
            ctx.state(self.COUNT).add(kid,
                                      np.ones(len(batch), dtype=np.int64))
            fire_at = (batch.timestamps // 5000 + 1) * 5000 - 1
            ctx.timer_service().register_event_time_timers(kid, fire_at)

        def on_timer(self, key_ids, timestamps, ctx):
            counts = ctx.state(self.COUNT).get(key_ids)
            ctx.collect(p["Batch"].from_pydict(
                {"key": key_ids, "count": counts}, timestamps=timestamps))

    return CountThenFlushAtTimer


def test_keyed_process_with_timers():
    def job(pkg):
        env = _env(pkg)
        s = env.from_collection(_rows(10, key_mod=2), timestamp_field="ts")
        return s.key_by("k").process(
            _count_then_flush(pkg)()).execute_and_collect().to_rows()

    rows = _both(job)
    by_ts = {}
    for r in rows:
        by_ts.setdefault(r["__ts__"], []).append(r["count"])
    assert sorted(by_ts[4999]) == [4, 4]
    assert sorted(by_ts[9999]) == [5, 5]


def test_timer_dedup_and_delete():
    for proc in (jproc, tproc):
        ts = proc.TimerService()
        ts.register_event_time_timers([1, 1, 2], [100, 100, 200])
        ts.delete_event_time_timers([2], [200])
        keys, tss = ts.advance_watermark(1000)
        assert keys.tolist() == [1] and tss.tolist() == [100]


def test_timers_fire_in_timestamp_then_key_order_and_snapshot_equal():
    got = {}
    for name, proc in (("ref", jproc), ("port", tproc)):
        ts = proc.TimerService()
        rng = np.random.default_rng(5)
        k = rng.integers(0, 50, 400)
        t = rng.integers(0, 30, 400)
        ts.register_event_time_timers(k, t)
        ts.register_processing_time_timers(k[:9], t[:9] + 5)
        ts.delete_event_time_timers(k[:40], t[:40])
        snap = ts.snapshot()
        fired = [ts.advance_watermark(w) for w in (3, 3, 17, 40)]
        got[name] = (snap, [(a.tolist(), b.tolist()) for a, b in fired])
    assert got["port"] == got["ref"]


def test_processing_time_timers_fire_with_injected_clock():
    def job(pkg):
        p = PKG[pkg]
        now = [0]

        class _Fn(p["mod"].ProcessFunction):
            def process_batch(self, batch, ctx):
                ctx.timer_service().register_processing_time_timers(
                    batch.key_ids, batch.timestamps + 10)

            def on_timer(self, key_ids, timestamps, ctx):
                ctx.collect(p["Batch"].from_pydict(
                    {"key": key_ids}, timestamps=timestamps))

        op = p["proc"].ProcessOperator(_Fn(), keyed=True,
                                       clock=lambda: now[0])
        op.open(p["Ctx"]())
        b = p["Batch"].from_pydict(
            {"__key_id__": np.array([7], dtype=np.int64)},
            timestamps=np.array([100], dtype=np.int64))
        assert op.process_batch(b) == []
        now[0] = 200
        outs = op.process_watermark(0)
        return [o.to_rows() for o in outs]

    outs = _both(job)
    assert len(outs) == 1 and outs[0][0]["key"] == 7


def test_processing_time_timers_fire_through_the_executor():
    """Through ``env.execute()`` processing-time timers fire at the end of
    each invocation (and on the executor's wall-clock tick, since the
    operator ``uses_processing_time``): a timer due now fires in the batch
    that registered it, and re-registering a fired timer fires it again."""
    def job(pkg):
        p = PKG[pkg]
        assert p["proc"].ProcessOperator.uses_processing_time

        class _Fn(p["mod"].ProcessFunction):
            def process_batch(self, batch, ctx):
                ctx.timer_service().register_processing_time_timers(
                    batch.key_ids, np.zeros(len(batch), dtype=np.int64))

            def on_timer(self, key_ids, timestamps, ctx):
                ctx.collect(p["Batch"].from_pydict({"key": key_ids}))

        env = _env(pkg)
        return env.from_collection(_rows(6, key_mod=3), timestamp_field="ts") \
            .key_by("k").process(_Fn()).execute_and_collect().to_rows()

    assert len(_both(job)) == 5  # keys {0, 1, 2}, then {1, 2}


def test_value_and_map_and_list_state():
    def job(pkg):
        ks = PKG[pkg]["ks"]
        store = ks.KeyedStateStore(capacity=1024)
        vs = store.get_state(ks.ValueStateDescriptor("v", np.float64, -1.0))
        kid = np.array([10, 20, 10], dtype=np.int64)
        first = vs.get(kid).tolist()
        vs.put(kid, np.array([1.0, 2.0, 3.0]))
        ls = store.get_state(ks.ListStateDescriptor("l"))
        ls.add(kid, np.array([1, 2, 3]))
        ms = store.get_state(ks.MapStateDescriptor("m"))
        ms.put(10, "a", 1)
        snap = store.snapshot()
        store2 = ks.KeyedStateStore(capacity=1024)
        store2.restore(snap)
        vs2 = store2.get_state(ks.ValueStateDescriptor("v", np.float64,
                                                       -1.0))
        return (first, vs.get(np.array([10, 20])).tolist(), ls.get(10),
                ls.get(20), ms.get(10, "a"), ms.contains(20, "a"),
                vs2.get(np.array([10, 20])).tolist(),
                store2.get_state(ks.ListStateDescriptor("l")).get(10),
                store2.get_state(ks.MapStateDescriptor("m")).get(10, "a"),
                snap["keys"].tolist(), snap["slots"].tolist())

    out = _both(job)
    assert out[:9] == ([-1.0] * 3, [3.0, 2.0], [1, 3], [2], 1, False,
                       [3.0, 2.0], [1, 3], 1)


def _op_snapshot(pkg, keys, ts):
    p = PKG[pkg]
    op = p["proc"].ProcessOperator(_count_then_flush(pkg)(), keyed=True)
    op.open(p["Ctx"]())
    op.process_batch(p["Batch"].from_pydict(
        {"__key_id__": np.asarray(keys, dtype=np.int64)},
        timestamps=np.asarray(ts, dtype=np.int64)))
    return op.snapshot_state()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("reader", ["ref", "port"])
def test_process_operator_snapshot_restore(writer, reader):
    """Snapshots restore across the two packages: the timers plus
    ``keyed_state`` are NumPy and plain Python."""
    snap = _op_snapshot(writer, [1, 1, 2], [100, 200, 300])
    p = PKG[reader]
    op2 = p["proc"].ProcessOperator(_count_then_flush(reader)(), keyed=True)
    op2.open(p["Ctx"]())
    op2.restore_state(snap)
    outs = op2.process_watermark(10_000)
    assert len(outs) == 1
    got = dict(zip(outs[0]["key"].tolist(), outs[0]["count"].tolist()))
    assert got == {1: 2, 2: 1}


def test_operator_snapshots_equal_reference():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 300, 2000)
    ts = rng.integers(0, 20_000, 2000)
    j, t = _op_snapshot("ref", keys, ts), _op_snapshot("port", keys, ts)
    assert t["timers"] == j["timers"]
    for f in ("keys", "slots"):
        np.testing.assert_array_equal(t["keyed_state"][f],
                                      j["keyed_state"][f])
    np.testing.assert_array_equal(
        t["keyed_state"]["states"]["count"]["values"],
        j["keyed_state"]["states"]["count"]["values"])


# ------------------------------------------------------------------- connect


def test_connected_streams_co_process():
    def job(pkg):
        p = PKG[pkg]

        class Zipper(p["mod"].CoProcessFunction):
            def process_batch1(self, batch, ctx):
                ctx.collect(batch.with_column("side", np.full(len(batch), 1)))

            def process_batch2(self, batch, ctx):
                ctx.collect(batch.with_column("side", np.full(len(batch), 2)))

        env = _env(pkg)
        a = env.from_collection([{"v": 1.0, "ts": 0}], timestamp_field="ts")
        b = env.from_collection([{"v": 2.0, "ts": 0}], timestamp_field="ts")
        return a.connect(b).process(Zipper()).execute_and_collect().to_rows()

    rows = _both(job)
    assert sorted((r["v"], r["side"]) for r in rows) == [(1.0, 1), (2.0, 2)]


def test_keyed_connected_streams_map_and_process():
    def job(pkg):
        env = _env(pkg)
        a = env.from_collection(_rows(6, 3), timestamp_field="ts")
        b = env.from_collection(_rows(4, 2), timestamp_field="ts")
        c = a.connect(b).key_by("k", "k")
        mapped = c.map(lambda x: x.with_column("w", x["v"] * 2),
                       lambda x: x.with_column("w", x["v"] * -1))
        return mapped.execute_and_collect().to_rows()

    rows = _both(job)
    assert len(rows) == 10 and all("__key_id__" in r for r in rows)


def test_broadcast_state_pattern():
    def job(pkg):
        p = PKG[pkg]

        class FilterByBroadcastRule(p["mod"].BroadcastProcessFunction):
            def process_batch(self, batch, ctx, bstate):
                allowed = bstate.get("allowed", set())
                mask = np.array([k in allowed for k in batch["k"].tolist()],
                                dtype=bool)
                ctx.collect(batch.filter(mask))

            def process_broadcast(self, batch, ctx, bstate):
                s = bstate.setdefault("allowed", set())
                s.update(batch["allow"].tolist())

        env = _env(pkg)
        rules = env.from_collection([{"allow": 1, "ts": 0}],
                                    timestamp_field="ts")
        data = env.from_collection(_rows(8, key_mod=3),
                                   timestamp_field="ts")
        return (data.connect(rules.broadcast())
                .process(FilterByBroadcastRule())
                .execute_and_collect().to_rows())

    rows = _both(job)
    assert rows and {r["k"] for r in rows} == {1}


def test_broadcast_operator_snapshot_carries_broadcast_state():
    for pkg in ("ref", "port"):
        p = PKG[pkg]

        class _Fn(p["mod"].BroadcastProcessFunction):
            def process_broadcast(self, batch, ctx, bstate):
                bstate["n"] = bstate.get("n", 0) + len(batch)

        op = p["proc"].BroadcastProcessOperator(_Fn())
        op.open(p["Ctx"]())
        op.process_batch(p["Batch"].from_pydict({"x": np.arange(3)}), 1)
        op2 = p["proc"].BroadcastProcessOperator(_Fn())
        op2.open(p["Ctx"]())
        op2.restore_state(op.snapshot_state())
        assert op2.broadcast_state == {"n": 3}


# ------------------------------------------------------------------ async IO


def test_async_unordered_and_ordered():
    def slow_enrich(batch):
        # later batches finish faster — exercises reordering
        time.sleep(0.02 if batch["v"][0] < 4 else 0.001)
        return batch.with_column("r", batch["v"] * 10)

    for ordered in (True, False):
        out = {}
        for pkg in ("ref", "port"):
            env = _env(pkg)
            s = env.from_collection(_rows(8, key_mod=8), timestamp_field="ts")
            ads = PKG[pkg]["mod"].AsyncDataStream
            wait = ads.ordered_wait if ordered else ads.unordered_wait
            out[pkg] = wait(s, slow_enrich, timeout_ms=5_000,
                            capacity=2).execute_and_collect().to_rows()
            assert sorted(r["r"] for r in out[pkg]) == [
                v * 10.0 for v in range(8)]
        if ordered:
            # the unordered emission order is the threads' finishing order
            assert out["port"] == out["ref"]
            assert [r["v"] for r in out["port"]] == [float(v)
                                                     for v in range(8)]
        else:
            key = sorted(out["port"], key=lambda r: r["v"])
            assert key == sorted(out["ref"], key=lambda r: r["v"])


def test_async_timeout_fallback():
    def job(pkg):
        class Flaky(PKG[pkg]["asy"].AsyncFunction):
            def invoke(self, batch):
                time.sleep(10)
                return batch

            def timeout(self, batch):
                return batch.with_column("r", np.full(len(batch), -1.0))

        env = _env(pkg, **{"execution.micro-batch.size": 100})
        s = env.from_collection(_rows(3, key_mod=3), timestamp_field="ts")
        return PKG[pkg]["mod"].AsyncDataStream.ordered_wait(
            s, Flaky(), timeout_ms=50, capacity=2).execute_and_collect() \
            .to_rows()

    rows = _both(job)
    assert [r["r"] for r in rows] == [-1.0, -1.0, -1.0]


def test_async_wait_operator_snapshot_replays_pending_inputs():
    for pkg in ("ref", "port"):
        asy, Batch = PKG[pkg]["asy"], PKG[pkg]["Batch"]
        op = asy.AsyncWaitOperator(lambda b: b.with_column("r", b["x"] + 1),
                                   capacity=4)
        op.open(PKG[pkg]["Ctx"]())
        op._pool.shutdown(wait=True)  # nothing runs: the input stays queued
        op._inflight.append((None, Batch.from_pydict({"x": np.arange(2)})))
        snap = op.snapshot_state()
        op2 = asy.AsyncWaitOperator(lambda b: b.with_column("r", b["x"] + 1))
        op2.open(PKG[pkg]["Ctx"]())
        op2.restore_state(snap)
        assert op2.close()[0]["r"].tolist() == [1, 2]


# ------------------------------------------- chip_smoke 19(a) at a cut size

#: 20,000 records over 5,000 keys, batches of 512; 200 events/s of event
#: time, so that the 60 s timers fire throughout the run
SMALL = dict(records=20_000, keys=5_000, batch=512, rate=200)


def _ref_timeout_job(use_async: bool):
    from flink_tpu.connectors.sources import DataGenSource

    env = _env("ref", **{"execution.micro-batch.size": SMALL["batch"]})
    fn = pt.CountWithTimeout(jas.DeviceValueStateDescriptor, JBatch,
                             use_async=use_async)
    sink = jsinks.CollectSink()
    src = DataGenSource(total_records=SMALL["records"], num_keys=SMALL["keys"],
                        events_per_second_of_eventtime=SMALL["rate"], seed=7)
    from flink_tpu.runtime.watermarks import WatermarkStrategy

    env.from_source(src, WatermarkStrategy.for_bounded_out_of_orderness(0),
                    name="datagen").key_by("key").process(
        fn, name="count_with_timeout").sink_to(sink)
    env.execute("count_with_timeout")
    return jsinks.CollectSink.result(sink), fn


@pytest.mark.parametrize("use_async", [False, True])
def test_count_with_timeout_equals_reference_and_oracle(use_async):
    """Phase 19(a)'s job: the port's rows equal the reference's and the
    NumPy oracle's in emission order, exactly, with the two int64 states
    as DeviceValueStates on the CPU; timers fire throughout the run."""
    out = pt.run("cpu", SMALL["records"], SMALL["keys"], SMALL["batch"],
                 use_async=use_async, rate=SMALL["rate"])
    ref, jfn = _ref_timeout_job(use_async)
    rows = out["rows"]
    for col in ("key_id", "count", "__ts__"):
        np.testing.assert_array_equal(rows[col], ref[col])
    assert pt.rows_equal(rows, pt.oracle(SMALL["records"], SMALL["keys"],
                                         SMALL["batch"], SMALL["rate"]))
    fn = out["fn"]
    assert (fn.registered, fn.fired, len(fn.fire_ms)) == (
        jfn.registered, jfn.fired, len(jfn.fire_ms))
    assert len(fn.fire_ms) > 10 and 0 < len(rows) < SMALL["records"]


def test_from_jax_keyed_state_carries_a_reference_snapshot_across():
    """A reference ProcessOperator's snapshot (DeviceValueStates, timers)
    converted by ``convert.from_jax_keyed_state`` restores into the port's
    operator with the device states as tensors on the CPU; the rest of
    the run emits the reference's rows."""
    from flink_tpu_torch.convert import from_jax_keyed_state

    def batches(Batch):
        rng = np.random.default_rng(9)
        for i in range(6):
            yield Batch.from_pydict(
                {"__key_id__": rng.integers(0, 300, 400).astype(np.int64)},
                timestamps=np.sort(rng.integers(i * 30_000, (i + 1) * 30_000,
                                                400)))

    jop = jproc.ProcessOperator(pt.CountWithTimeout(
        jas.DeviceValueStateDescriptor, JBatch), keyed=True)
    jop.open(JCtx())
    tb = list(batches(TBatch))
    for i, b in enumerate(batches(JBatch)):
        if i == 3:
            snap = jop.snapshot_state()
        jop.process_batch(b)
        if i >= 3:
            jop.process_watermark(int(b.timestamps.max()) - 1)
    want = [o.to_rows() for o in jop.process_watermark(10 ** 9)]
    conv = from_jax_keyed_state(snap, "cpu",
                                device_states=("count", "last_modified"))
    assert isinstance(conv["keyed_state"]["states"]["count"]["values"],
                      torch.Tensor)
    top = tproc.ProcessOperator(pt.CountWithTimeout(), keyed=True)
    top.open(TCtx(device="cpu"))
    top.restore_state(conv)
    for b in tb[3:]:
        top.process_batch(b)
        top.process_watermark(int(b.timestamps.max()) - 1)
    assert [o.to_rows() for o in top.process_watermark(10 ** 9)] == want
    with pytest.raises(KeyError, match="no state named"):
        from_jax_keyed_state(snap, "cpu", device_states=("nope",))
