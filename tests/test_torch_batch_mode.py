"""Batch execution mode in the port (``execution.runtime-mode=batch``,
ROADMAP Queue C item 11) against the reference's, on the CPU; modelled on
``tests/test_batch_mode.py``.

In batch mode the executor emits no intermediate watermark and no
fire-deadline split, so every window fires once, on the MAX_WATERMARK at
source exhaustion, and an unbounded source is rejected at submit. The
comparisons hold the port's sink rows equal to the reference's in order,
every column bit for bit (tolerance: none).
"""

import numpy as np
import pytest

from flink_tpu import (
    Configuration as JConfiguration,
    StreamExecutionEnvironment as JEnv,
)
from flink_tpu.connectors.sinks import CollectSink as JCollectSink
from flink_tpu.connectors.sources import DataGenSource as JDataGen
from flink_tpu.runtime.watermarks import WatermarkStrategy as JWS
from flink_tpu.windowing import assigners as jasg
from flink_tpu_torch import Configuration, StreamExecutionEnvironment
from flink_tpu_torch.connectors.sinks import CollectSink
from flink_tpu_torch.connectors.sources import (
    DataGenSource,
    SocketSource,
    Source,
)
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
from flink_tpu_torch.windowing import assigners as tasg

from tests.test_torch_mesh_sessions import _bits

#: Queue C item 11's input: eight rows over keys 0/1, a row at 5000 ms,
#: then four rows of key 0 back in window 0 — late in streaming mode
ROWS = ([{"key": i % 2, "value": 1.0, "ts": 100 * i} for i in range(8)]
        + [{"key": 0, "value": 1.0, "ts": 5000}]
        + [{"key": 0, "value": 10.0, "ts": 150}] * 4)


def _collection_job(env_cls, cfg_cls, sink, asg, ws, mode, rows=ROWS,
                    extra=None):
    env = env_cls(cfg_cls({"execution.micro-batch.size": 9,
                           "execution.runtime-mode": mode, **(extra or {})}))
    env.from_collection(rows, timestamp_field="ts",
                        watermark_strategy=ws.for_bounded_out_of_orderness(0)
                        ).key_by("key").window(
        asg.TumblingEventTimeWindows.of(1000)).sum("value").sink_to(sink)
    env.execute("batch-job")
    return sink.rows()


def _port(mode, **extra):
    return _collection_job(StreamExecutionEnvironment, Configuration,
                           CollectSink(), tasg, WatermarkStrategy, mode,
                           extra={"execution.device": "cpu", **extra})


def _ref(mode):
    return _collection_job(JEnv, JConfiguration, JCollectSink(), jasg, JWS,
                           mode)


def _key0_window0(rows):
    return [r["sum_value"] for r in rows
            if r["key"] == 0 and r["window_start"] == 0]


@pytest.mark.parametrize("parallelism", [1, 8])
def test_queue_c_item_11_job_gives_44_as_the_reference(parallelism):
    ref = _ref("batch")
    got = _port("batch", **{"parallelism.default": parallelism})
    assert _key0_window0(ref) == [44.0]
    assert _key0_window0(got) == [44.0]
    assert sorted(map(str, got)) == sorted(map(str, ref))
    # streaming mode drops the four rows as late, in both packages
    assert _key0_window0(_port("streaming")) == _key0_window0(
        _ref("streaming")) == [4.0]


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _datagen_job(env, sink, asg, src, ws):
    env.from_source(src, ws.for_bounded_out_of_orderness(0), name="gen") \
        .key_by("key").window(asg.SlidingEventTimeWindows.of(2000, 500)) \
        .sum("value").sink_to(sink)
    env.execute("batch")


@pytest.mark.parametrize("parallelism", [1, 8])
def test_batch_rows_equal_reference(parallelism):
    """A 20k-record datagen job (sliding 2 s / 0.5 s, float32 Sum) in
    batch mode: the port's rows equal the reference's, in order."""
    kw = dict(total_records=20_000, num_keys=100,
              events_per_second_of_eventtime=10_000, seed=2)
    base = {"execution.micro-batch.size": 1000,
            "execution.runtime-mode": "batch",
            "parallelism.default": parallelism}
    jsink = JCollectSink()
    _datagen_job(JEnv(JConfiguration(dict(base))), jsink, jasg,
                 JDataGen(**kw), JWS)
    tsink = CollectSink()
    _datagen_job(StreamExecutionEnvironment(Configuration(
        {**base, "execution.device": "cpu"})), tsink, tasg,
        DataGenSource(**kw), WatermarkStrategy)
    want = [b.to_pydict() for b in jsink.batches]
    got = [b.to_pydict() for b in tsink.batches]
    ends = [b["window_end"][0] for b in want]
    assert len(ends) > 1 and len(set(ends)) == len(ends)  # one fire each
    _assert_rows_equal(got, want)


def test_single_fire_per_window():
    sink = CollectSink()
    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": 1000,
        "execution.runtime-mode": "batch", "execution.device": "cpu"}))
    env.from_source(DataGenSource(total_records=20_000, num_keys=100,
                                  events_per_second_of_eventtime=10_000,
                                  seed=2),
                    WatermarkStrategy.for_bounded_out_of_orderness(0)) \
        .key_by("key").window(tasg.TumblingEventTimeWindows.of(1000)) \
        .sum("value").sink_to(sink)
    env.execute("batch")
    rows = sink.rows()
    keys = [(r["key"], r["window_start"]) for r in rows]
    assert len(keys) == len(set(keys)) == 100 * 2


def test_session_windows_in_batch_mode_equal_reference():
    """The gate holds for the mesh session engine too: one fire per
    session, the reference's rows."""
    rows = [{"key": k, "value": float(v), "ts": t}
            for k, v, t in zip([1, 2, 1, 1, 2, 1, 3],
                               [1, 2, 3, 4, 5, 6, 7],
                               [0, 10, 50, 400, 30, 120, 5])]
    out = []
    for env_cls, cfg_cls, sink, asg, ws, extra in (
            (JEnv, JConfiguration, JCollectSink(), jasg, JWS, {}),
            (StreamExecutionEnvironment, Configuration, CollectSink(),
             tasg, WatermarkStrategy, {"execution.device": "cpu"})):
        env = env_cls(cfg_cls({"execution.micro-batch.size": 2,
                               "execution.runtime-mode": "batch",
                               "parallelism.default": 8, **extra}))
        env.from_collection(rows, timestamp_field="ts",
                            watermark_strategy=ws
                            .for_bounded_out_of_orderness(0)) \
            .key_by("key").window(asg.EventTimeSessionWindows.with_gap(100)) \
            .sum("value").sink_to(sink)
        env.execute("sessions")
        out.append(sorted((r["key"], r["window_start"], r["window_end"],
                           r["sum_value"]) for r in sink.rows()))
    assert out[0] == out[1]
    assert (1, 0, 220, 10.0) in out[1]


class _Endless(Source):
    bounded = False

    def poll_batch(self, n):
        raise AssertionError("an unbounded source must not be polled")


@pytest.mark.parametrize("source", [
    lambda: _Endless(),
    lambda: SocketSource("127.0.0.1", 9),
])
def test_unbounded_source_rejected_at_submit(source):
    env = StreamExecutionEnvironment(Configuration({
        "execution.runtime-mode": "batch", "execution.device": "cpu"}))
    env.from_source(source(), WatermarkStrategy.for_bounded_out_of_orderness(0)
                    ).key_by("key").window(
        tasg.TumblingEventTimeWindows.of(1000)).sum("value").sink_to(
        CollectSink())
    with pytest.raises(RuntimeError, match="unbounded"):
        env.execute("rejected")


def test_every_port_source_says_whether_it_is_bounded():
    assert SocketSource.bounded is False
    assert DataGenSource.bounded is True
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.connectors.sources import CollectionSource

    assert CollectionSource.bounded and BidSource.bounded
