"""``runtime/debloater.py`` of the port against the reference's: the same
observation sequence gives the same batch sizes (exact integers), and the
executor resizes its micro-batches by it under
``execution.micro-batch.latency-target-ms``."""

import numpy as np
import pytest

from flink_tpu.runtime.debloater import BatchSizeController as JController
from flink_tpu_torch.runtime.debloater import BatchSizeController


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(initial=8192, min_size=256, max_size=8192, target_latency_ms=20),
    dict(initial=1 << 15, min_size=16, max_size=1 << 20,
         target_latency_ms=250, alpha=0.5, headroom=0.25),
    dict(initial=100, min_size=1000, max_size=500, target_latency_ms=5),
])
def test_sizes_equal_reference(seed, kw):
    rng = np.random.default_rng(seed)
    j, t = JController(**kw), BatchSizeController(**kw)
    assert t.size == j.size
    for _ in range(200):
        records = int(rng.integers(-5, 1 << 16))
        elapsed = float(rng.choice([0.0, -1.0, *rng.exponential(0.01, 6)]))
        assert t.observe(records, elapsed) == j.observe(records, elapsed)
        assert t.size == j.size


def test_executor_resizes_batches():
    """A latency target far below one batch's cost shrinks the batches
    the source is polled with (the job's rows stay the fixed-size job's)."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    class Recording(DataGenSource):
        sizes = []

        def poll_batch(self, max_records):
            Recording.sizes.append(max_records)
            return super().poll_batch(max_records)

    def run(extra):
        Recording.sizes = []
        env = StreamExecutionEnvironment(Configuration({
            "execution.device": "cpu", "execution.micro-batch.size": 4096,
            **extra}))
        sink = CollectSink()
        env.from_source(Recording(total_records=40_000, num_keys=50,
                                  events_per_second_of_eventtime=10_000),
                        WatermarkStrategy.for_bounded_out_of_orderness(0)) \
            .key_by("key").window(TumblingEventTimeWindows.of(1000)) \
            .count().sink_to(sink)
        env.execute("debloat")
        return sorted((r["key"], r["window_start"], r["count"])
                      for r in sink.rows()), list(Recording.sizes)

    want, fixed = run({})
    got, sizes = run({"execution.micro-batch.latency-target-ms": 1,
                      "execution.micro-batch.min-size": 64})
    assert set(fixed) == {4096}
    assert min(sizes) < 4096 and min(sizes) >= 64
    assert got == want
