"""Processing-time windows in the port (``TumblingProcessingTimeWindows``,
``SlidingProcessingTimeWindows``, the operator's arrival-time stamping and
``on_processing_time``, the executor's wall-clock tick) — the invariants
of ``tests/test_processing_time.py``, each checked in both packages on the
same paced source: windows fire on the wall clock mid-stream, a sliding
window counts each record size/slide times, the end of input flushes open
windows, and an idle stream's windows fire from the tick alone.

Wall-clock results cannot be compared row for row (each run stamps its own
arrival times), so the tests compare the invariants; the totals are exact.
"""

import time

import numpy as np
import pytest

from flink_tpu import Configuration as JConfiguration
from flink_tpu import StreamExecutionEnvironment as JEnv
from flink_tpu.connectors.sinks import CollectSink as JCollectSink
from flink_tpu.connectors.sources import Source as JSource
from flink_tpu.core.records import RecordBatch as JBatch
from flink_tpu.runtime.watermarks import WatermarkStrategy as JWS
from flink_tpu.windowing import assigners as jasg
from flink_tpu_torch import Configuration, StreamExecutionEnvironment
from flink_tpu_torch.connectors.sinks import CollectSink
from flink_tpu_torch.connectors.sources import Source
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
from flink_tpu_torch.windowing import assigners as tasg


def _paced(base, batch_cls):
    class PacedSource(base):
        """``per_wave`` records every ``pause_s`` for ``waves`` waves; with
        ``idle_polls`` the pause is spent returning empty batches (an
        idle stream the executor keeps ticking)."""

        def __init__(self, waves=3, per_wave=50, pause_s=0.25, keys=5,
                     idle=False):
            self.waves, self.per_wave = waves, per_wave
            self.pause_s, self.keys, self.idle = pause_s, keys, idle
            self._emitted_waves = 0
            self._resume_at = 0.0
            self.wave_times = []

        def poll_batch(self, n):
            if self._emitted_waves >= self.waves:
                return None
            if self.idle and time.time() < self._resume_at:
                return batch_cls({})
            if self._emitted_waves and not self.idle:
                time.sleep(self.pause_s)
            self._emitted_waves += 1
            self._resume_at = time.time() + self.pause_s
            self.wave_times.append(time.time())
            k = np.arange(self.per_wave, dtype=np.int64) % self.keys
            return batch_cls.from_pydict(
                {"key": k,
                 "value": np.ones(self.per_wave, dtype=np.float32)},
                timestamps=np.zeros(self.per_wave, dtype=np.int64))

    return PacedSource


class _TimedSink:
    """A collect sink that notes when each batch arrived."""

    def __init__(self, base):
        self.sink = base()
        self.times = []
        sink = self.sink
        write = sink.write

        def timed(batch):
            self.times.append(time.time())
            write(batch)

        sink.write = timed


PACKAGES = {
    "port": (StreamExecutionEnvironment, Configuration, CollectSink,
             _paced(Source, RecordBatch), WatermarkStrategy, tasg,
             {"execution.device": "cpu",
              "execution.pipeline.in-flight-batches": 0}),
    "reference": (JEnv, JConfiguration, JCollectSink,
                  _paced(JSource, JBatch), JWS, jasg,
                  {"execution.pipeline.in-flight-batches": 0}),
}


def _run(pkg, assigner, batch=64, **src_kw):
    env_cls, cfg_cls, sink_cls, paced, ws, asg, extra = PACKAGES[pkg]
    env = env_cls(cfg_cls({"execution.micro-batch.size": batch, **extra}))
    timed = _TimedSink(sink_cls)
    src = paced(**src_kw)
    env.from_source(src, ws.no_watermarks(), name="paced") \
        .key_by("key").window(assigner(asg)).count().sink_to(timed.sink)
    env.execute("pt")
    return timed.sink.result().to_rows(), timed.times, src.wave_times


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_tumbling_pt_windows_fire_on_wall_clock(pkg):
    rows, _, _ = _run(pkg, lambda a: a.TumblingProcessingTimeWindows.of(200),
                      waves=3, pause_s=0.3)
    assert sum(r["count"] for r in rows) == 150
    assert len({r["window_end"] for r in rows}) >= 2
    assert all(r["window_end"] - r["window_start"] == 200 for r in rows)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_sliding_pt_windows_count_overlap(pkg):
    rows, _, _ = _run(
        pkg, lambda a: a.SlidingProcessingTimeWindows.of(400, 100),
        waves=2, per_wave=40, pause_s=0.25)
    assert sum(r["count"] for r in rows) == 80 * 4
    assert all(r["window_end"] - r["window_start"] == 400 for r in rows)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_end_of_input_flushes_open_pt_windows(pkg):
    rows, times, _ = _run(
        pkg, lambda a: a.TumblingProcessingTimeWindows.of(60_000),
        batch=1024, waves=1, per_wave=100, pause_s=0)
    assert sum(r["count"] for r in rows) == 100
    assert len(times) == 1  # one flush, by the end-of-input MAX watermark


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_idle_stream_windows_fire_from_the_tick(pkg):
    """The source returns empty batches between its two waves: the first
    wave's 100 ms windows fire from the executor's wall-clock tick before
    the second wave arrives."""
    rows, times, waves = _run(
        pkg, lambda a: a.TumblingProcessingTimeWindows.of(100),
        waves=2, per_wave=30, pause_s=0.4, keys=3, idle=True)
    assert sum(r["count"] for r in rows) == 60
    assert times and times[0] < waves[1]


def test_event_time_watermarks_do_not_fire_pt_windows():
    """An event-time watermark below MAX is ignored by a processing-time
    window operator; only its own tick fires it."""
    from flink_tpu_torch.runtime.operators import WindowAggOperator
    from flink_tpu_torch.runtime.operators import OperatorContext
    from flink_tpu_torch.windowing.aggregates import CountAggregate

    op = WindowAggOperator(tasg.TumblingProcessingTimeWindows.of(100),
                           CountAggregate(), "key")
    assert op.uses_processing_time
    op.open(OperatorContext(device="cpu"))
    b = RecordBatch({"key": np.arange(4, dtype=np.int64),
                     "__key_id__": np.arange(4, dtype=np.int64)})
    op.process_batch(b)
    assert op.process_watermark(1 << 40) == []
    now = int(time.time() * 1000)
    fired = op.on_processing_time(now + 1000)
    assert sum(len(x) for x in fired) == 4
