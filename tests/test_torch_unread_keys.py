"""Reference configuration keys the port does not read (ROADMAP Queue C
item 12): each, set to a value the port cannot honour, raises at
``execute()`` naming its ROADMAP item; at its default (and at the values
the port already behaves as) the job runs and gives the rows it gives
without the key.
"""

import pathlib
import re

import pytest

from flink_tpu_torch import Configuration, StreamExecutionEnvironment
from flink_tpu_torch.connectors.sinks import CollectSink
from flink_tpu_torch.core.config import UNREAD_KEYS
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

_ROADMAP = (pathlib.Path(__file__).resolve().parent.parent
            / "ROADMAP.md").read_text()

ROWS = [{"key": i % 3, "value": float(i), "ts": 100 * i} for i in range(30)]


def _run(extra):
    env = StreamExecutionEnvironment(Configuration(
        {"execution.device": "cpu", "execution.micro-batch.size": 7,
         **extra}))
    sink = CollectSink()
    env.from_collection(ROWS, timestamp_field="ts",
                        watermark_strategy=WatermarkStrategy
                        .for_bounded_out_of_orderness(0)) \
        .key_by("key").window(TumblingEventTimeWindows.of(1000)) \
        .sum("value").sink_to(sink)
    env.execute("keys")
    return sink.rows()


#: key -> (values that raise, values that run)
CASES = {
    "memory.device.size": ([1 << 30], [0]),
    "autoscale.enabled": ([True, "true"], [False]),
    "shuffle.hosts": ([1, 2], [0]),
    "execution.pipeline.in-flight-batches": ([1, 2], [0, -1]),
    "execution.stage-parallelism": ([2, 4], [0]),
}


def _item(message: str) -> str:
    m = re.search(r"Queue A item (\w+)", message)
    assert m, message
    assert f"**Item {m.group(1)} " in _ROADMAP, m.group(1)
    return m.group(1)


def test_every_unread_key_has_a_case():
    assert sorted(o.key for o, *_ in UNREAD_KEYS) == sorted(CASES)


@pytest.mark.parametrize("key", sorted(CASES))
def test_unread_key_raises_naming_its_item(key):
    for value in CASES[key][0]:
        with pytest.raises(NotImplementedError) as e:
            _run({key: value})
        assert key in str(e.value)
        _item(str(e.value))


@pytest.mark.parametrize("key", sorted(CASES))
def test_unread_key_at_its_default_runs(key):
    want = _run({})
    for value in CASES[key][1]:
        assert _run({key: value}) == want


@pytest.mark.parametrize("family", ["scatter", "fire", "rank"])
def test_stateplane_backend_keys_are_rejected(family):
    for backend in ("pallas", "xla"):
        with pytest.raises(NotImplementedError,
                           match="one route per tensor device") as e:
            _run({f"stateplane.backend.{family}": backend})
        assert _item(str(e.value)) == "12"


def test_debloater_keys_are_read_not_rejected():
    """``latency-target-ms`` and ``min-size`` drive the debloater: a job
    with them runs and gives the fixed-batch job's rows."""
    want = _run({})
    assert _run({"execution.micro-batch.latency-target-ms": 50,
                 "execution.micro-batch.min-size": 16}) == want


def _process_job(extra):
    """A keyed process job whose state carries TTL (a descriptor's
    ``StateTtlConfig``, the DataStream user's way to TTL: the reference's
    one TTL key, ``table.exec.state.ttl``, is read only by its Table
    layer, ROADMAP item 11c) and a device value state."""
    import numpy as np

    from flink_tpu_torch import (
        KeyedProcessFunction,
        RecordBatch,
        ReducingStateDescriptor,
    )
    from flink_tpu_torch.state.async_state import DeviceValueStateDescriptor
    from flink_tpu_torch.state.ttl import StateTtlConfig

    class Fn(KeyedProcessFunction):
        N = ReducingStateDescriptor("n", np.add, np.int64, 0,
                                    ttl=StateTtlConfig(10 ** 9))
        LAST = DeviceValueStateDescriptor("last", np.float64, 0.0)

        def process_batch(self, batch, ctx):
            ctx.async_state(self.N).add(batch.key_ids,
                                        np.ones(len(batch), np.int64))
            ctx.async_state(self.LAST).put(batch.key_ids, batch["value"])
            ctx.timer_service().register_event_time_timers(
                batch.key_ids, batch.timestamps // 1000 * 1000 + 999)

        def on_timer(self, key_ids, timestamps, ctx):
            ctx.collect(RecordBatch.from_pydict(
                {"k": key_ids, "n": ctx.state(self.N).get(key_ids),
                 "last": ctx.state(self.LAST).get(key_ids)},
                timestamps=timestamps))

    env = StreamExecutionEnvironment(Configuration(
        {"execution.device": "cpu", "execution.micro-batch.size": 7,
         **extra}))
    sink = CollectSink()
    env.from_collection(ROWS, timestamp_field="ts",
                        watermark_strategy=WatermarkStrategy
                        .for_bounded_out_of_orderness(0)) \
        .key_by("key").process(Fn()).sink_to(sink)
    env.execute("process")
    return sink.rows()


@pytest.mark.parametrize("key", sorted(CASES))
def test_unread_keys_raise_for_process_jobs_too(key):
    """The slice's process functions, TTL'd state and device value state
    honour no reference key of ``UNREAD_KEYS``: each still raises at
    ``execute()`` for a process job, and at the values the port behaves
    as the job runs and gives the rows it gives without the key."""
    want = _process_job({})
    assert len(want) == 9  # 3 keys x 3 seconds
    for value in CASES[key][0]:
        with pytest.raises(NotImplementedError) as e:
            _process_job({key: value})
        _item(str(e.value))
    for value in CASES[key][1]:
        assert _process_job({key: value}) == want
