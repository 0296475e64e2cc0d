"""The DataStream V2 facade of the port against the reference, on the CPU.

The cases are those of ``tests/test_datastream_v2.py``. Each builds the
same V2 program in both packages (the process functions subclass each
package's own V2 base classes) over the same DataGen stream, and the sink
rows compare bit for bit in order (as multisets where two sources
interleave); the refusals raise with the reference's messages. The port
runs every job on ``execution.device: cpu``; its keyed state is the
port's keyed state store.
"""

import numpy as np
import pytest

from tests.test_torch_sql import PKGS, assert_batches_equal
from tests.test_torch_mesh_sessions import _bits


def _v2(p):
    return p.mod("datastream.v2")


def _env(p, **cfg):
    return _v2(p).ExecutionEnvironment.get_instance(
        p.config(**{"execution.micro-batch.size": 4096, **cfg}))


def _src(p, n=20_000, keys=50):
    return p.mod("connectors.sources").DataGenSource(
        total_records=n, num_keys=keys, events_per_second_of_eventtime=10_000)


def _reducing(p):
    return p.mod("state.keyed_state").ReducingStateDescriptor(
        "n", np.add, np.int64, 0)


def _fns(p):
    """The test's process functions over package ``p``'s base classes."""
    v2 = _v2(p)
    key_id = p.records.KEY_ID_FIELD

    class Doubler(v2.OneInputStreamProcessFunction):
        def process_batch(self, batch, out, ctx):
            out.collect(batch.with_column(
                "value", np.asarray(batch["value"]) * 2))

    class KeyedCounter(v2.OneInputStreamProcessFunction):
        def open(self, ctx):
            self.desc = _reducing(p)

        def process_batch(self, batch, out, ctx):
            keys = batch[key_id]
            ctx.state(self.desc).add(keys, np.ones(len(keys), np.int64))
            ctx.timer_service().register_event_time_timers(
                keys, np.full(len(keys), 1 << 50))

        def on_timer(self, key_ids, timestamps, out, ctx):
            out.collect(p.RecordBatch({
                key_id: key_ids, "count": ctx.state(self.desc).get(key_ids)}))

    class Splitter(v2.TwoOutputStreamProcessFunction):
        def process_batch(self, batch, out1, out2, ctx):
            v = np.asarray(batch["key"])
            out1.collect(batch.filter(v % 2 == 0))
            out2.collect(batch.filter(v % 2 == 1))

    class Zipper(v2.TwoInputNonBroadcastStreamProcessFunction):
        def process_batch_first(self, batch, out, ctx):
            out.collect(batch.with_column("side", np.zeros(len(batch))))

        def process_batch_second(self, batch, out, ctx):
            out.collect(batch.with_column("side", np.ones(len(batch))))

    class Enricher(v2.TwoInputBroadcastStreamProcessFunction):
        def process_broadcast_batch(self, batch, out, ctx, bstate):
            for k, v in zip(batch["key"].tolist(), batch["value"].tolist()):
                bstate[int(k) % 10] = v

        def process_batch(self, batch, out, ctx, bstate):
            dims = np.asarray([bstate.get(int(k) % 10, -1.0)
                               for k in batch["key"].tolist()])
            out.collect(batch.with_column("dim", dims))

    class KeyedSplitCounter(v2.TwoOutputStreamProcessFunction):
        def open(self, ctx):
            self.desc = _reducing(p)

        def process_batch(self, batch, out1, out2, ctx):
            keys = batch[key_id]
            ctx.state(self.desc).add(keys, np.ones(len(keys), np.int64))
            counts = ctx.state(self.desc).get(keys)
            out1.collect(batch.filter(counts % 2 == 1))
            out2.collect(batch.filter(counts % 2 == 0))

    class KeyedZip(v2.TwoInputNonBroadcastStreamProcessFunction):
        def open(self, ctx):
            self.desc = _reducing(p)

        def process_batch_first(self, batch, out, ctx):
            keys = batch[key_id]
            ctx.state(self.desc).add(keys, np.ones(len(keys), np.int64))

        def process_batch_second(self, batch, out, ctx):
            keys = batch[key_id]
            ctx.state(self.desc).add(keys, np.ones(len(keys), np.int64))
            out.collect(batch.with_column(
                "tally", ctx.state(self.desc).get(keys)))

    class Bad(v2.OneInputStreamProcessFunction):
        def process_batch(self, batch, out, ctx):
            ctx.state(_reducing(p))

    return {c.__name__: c for c in (Doubler, KeyedCounter, Splitter, Zipper,
                                    Enricher, KeyedSplitCounter, KeyedZip,
                                    Bad)}


def _sorted(batch):
    cols = [c for c in batch.columns]
    order = np.lexsort([_bits(np.asarray(batch[c]))
                        for c in reversed(cols)])
    return batch.take(order)


def run_both(build, ordered=True, **cfg):
    """``build(p, env, fns) -> [sinks]`` in each package, run, and hold
    every sink's rows equal; returns the port's sink results."""
    out = {}
    for name, p in PKGS.items():
        env = _env(p, **cfg)
        sinks = build(p, env, _fns(p))
        env.execute("v2")
        out[name] = [s.result() for s in sinks]
    for got, want in zip(out["port"], out["reference"]):
        if ordered:
            assert_batches_equal(got, want)
        else:
            assert_batches_equal(_sorted(got), _sorted(want))
    return out["port"]


def test_process_and_keyed_state_end_to_end():
    def build(p, env, f):
        sink = p.CollectSink()
        (env.from_source(_src(p)).process(f["Doubler"]()).key_by("key")
            .process(f["KeyedCounter"]()).to_sink(sink))
        return [sink]

    (b,) = run_both(build)
    key_id = PKGS["port"].records.KEY_ID_FIELD
    got = dict(zip(b[key_id].tolist(), b["count"].tolist()))
    assert len(got) == 50 and sum(got.values()) == 20_000


def test_two_output_process_function():
    def build(p, env, f):
        evens, odds = p.CollectSink(), p.CollectSink()
        main, side = env.from_source(_src(p, n=8000)).process_two_output(
            f["Splitter"]())
        main.to_sink(evens)
        side.to_sink(odds)
        return [evens, odds]

    e, o = run_both(build)
    assert len(e) + len(o) == 8000
    assert (np.asarray(e["key"]) % 2 == 0).all()
    assert (np.asarray(o["key"]) % 2 == 1).all()


def test_connect_and_process_two_inputs():
    def build(p, env, f):
        sink = p.CollectSink()
        a = env.from_source(_src(p, n=5000))
        b = env.from_source(_src(p, n=3000))
        a.connect_and_process(b, f["Zipper"]()).to_sink(sink)
        return [sink]

    (b,) = run_both(build, ordered=False)
    sides = np.asarray(b["side"])
    assert (sides == 0).sum() == 5000 and (sides == 1).sum() == 3000


def test_broadcast_connect():
    def build(p, env, f):
        sink = p.CollectSink()
        data = env.from_source(_src(p, n=4000))
        dim = env.from_source(_src(p, n=1000)).broadcast()
        data.connect_and_process(dim, f["Enricher"]()).to_sink(sink)
        return [sink]

    (b,) = run_both(build)
    assert len(b) == 4000 and "dim" in b.columns


def test_non_keyed_context_rejects_state_and_timers():
    msgs = {}
    for name, p in PKGS.items():
        env = _env(p)
        env.from_source(_src(p, n=1000)).process(_fns(p)["Bad"]()).to_sink(
            p.CollectSink())
        with pytest.raises(RuntimeError, match="KeyedPartitionStream") as e:
            env.execute("v2-bad")
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]


@pytest.mark.parametrize("parallelism", [1, 8])
def test_windows_on_keyed_streams(parallelism):
    def build(p, env, f):
        sink = p.CollectSink()
        win = p.mod("windowing.assigners").TumblingEventTimeWindows
        (env.from_source(_src(p, n=10_000)).key_by("key").window(
            win.of(1000)).sum("value").sink_to(sink))
        return [sink]

    (b,) = run_both(build, **{"parallelism.default": parallelism})
    assert len(b) == 50


def test_keyed_two_output_with_state():
    def build(p, env, f):
        s1, s2 = p.CollectSink(), p.CollectSink()
        main, side = env.from_source(_src(p, n=6000)).key_by("key") \
            .process_two_output(f["KeyedSplitCounter"]())
        main.to_sink(s1)
        side.to_sink(s2)
        return [s1, s2]

    a, b = run_both(build)
    assert len(a) + len(b) == 6000 and len(a) > 0 and len(b) > 0


def test_keyed_connect_and_process_shares_state():
    def build(p, env, f):
        sink = p.CollectSink()
        a = env.from_source(_src(p, n=4000)).key_by("key")
        b = env.from_source(_src(p, n=4000)).key_by("key")
        a.connect_and_process(b, f["KeyedZip"]()).to_sink(sink)
        return [sink]

    # the tally depends on how the two sources interleave: with source
    # pump threads (in-flight batches > 0, in both packages) that is
    # thread timing; polled inline, both take turns batch by batch
    (b,) = run_both(build, **{"execution.pipeline.in-flight-batches": 0})
    assert len(b) == 4000 and int(np.asarray(b["tally"]).max()) > 1


def test_refusals_as_the_reference():
    msgs = {}
    for name, p in PKGS.items():
        env = _env(p)
        f = _fns(p)
        a = env.from_source(_src(p, n=100)).key_by("key")
        b = env.from_source(_src(p, n=100))
        with pytest.raises(TypeError, match="both streams keyed") as e1:
            a.connect_and_process(b, f["KeyedZip"]())
        with pytest.raises(TypeError, match="process_two_output") as e2:
            env.from_source(_src(p, n=100)).key_by("key").process(
                f["KeyedSplitCounter"]())
        with pytest.raises(TypeError, match="process_two_output") as e3:
            env.from_source(_src(p, n=100)).process(f["Splitter"]())
        msgs[name] = (str(e1.value), str(e2.value), str(e3.value))
    assert msgs["port"] == msgs["reference"]


def test_from_source_name_reaches_the_graph():
    for p in PKGS.values():
        env = _env(p)
        env.from_source(_src(p, n=100), name="orders").process(
            _fns(p)["Doubler"]()).to_sink(p.CollectSink())
        ops = env.execute("v2-named").metrics.get("per_operator", {})
        assert any("orders" in k for k in ops), ops


def test_v2_environment_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from flink_tpu_torch.datastream.v2 import ExecutionEnvironment

    env = ExecutionEnvironment.get_instance()
    env.from_source(_src(PKGS["port"], n=100)).key_by("key").window(
        PKGS["port"].mod("windowing.assigners").TumblingEventTimeWindows.of(
            1000)).sum("value").sink_to(PKGS["port"].CollectSink())
    with pytest.raises(RuntimeError, match="execution.device"):
        env.execute("v2-card")
