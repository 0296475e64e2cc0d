"""Reference configuration keys the port does not read (ROADMAP Queue C
item 12, closed): each, set to a value the port cannot honour, raises at
``execute()`` naming its ROADMAP item; at its default (and at the values
the port already behaves as) the job runs and gives the rows it gives
without the key.

The keys the port has since come to read (``HONOURED``: the stage
executor, the source pumps and managed device memory) give the
reference's rows at the values that used to raise, on a window job and a
process job through both packages (sorted: the stage executor's subtasks
share one sink; float values compared exactly).
"""

import importlib
import pathlib
import re

import pytest

import flink_tpu
import flink_tpu_torch
from flink_tpu_torch.core.config import UNREAD_KEYS

_ROADMAP = (pathlib.Path(__file__).resolve().parent.parent
            / "ROADMAP.md").read_text()

ROWS = [{"key": i % 3, "value": float(i), "ts": 100 * i} for i in range(30)]


PKGS = {"port": flink_tpu_torch, "ref": flink_tpu}


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg].__name__}.{name}")


def _env(pkg, extra):
    top = PKGS[pkg]
    conf = {"execution.micro-batch.size": 7, **extra}
    if pkg == "port":
        conf["execution.device"] = "cpu"
    env = top.StreamExecutionEnvironment(top.Configuration(conf))
    ws = _mod(pkg, "runtime.watermarks").WatermarkStrategy
    src = env.from_collection(
        ROWS, timestamp_field="ts",
        watermark_strategy=ws.for_bounded_out_of_orderness(0))
    return env, src, _mod(pkg, "connectors.sinks").CollectSink()


def _run(extra, pkg="port"):
    env, src, sink = _env(pkg, extra)
    asg = _mod(pkg, "windowing.assigners")
    src.key_by("key").window(asg.TumblingEventTimeWindows.of(1000)) \
        .sum("value").sink_to(sink)
    env.execute("keys")
    return sink.rows()


#: key -> (values that raise, values that run)
CASES = {
    "autoscale.enabled": ([True, "true"], [False]),
    "shuffle.hosts": ([1, 2], [0]),
}

#: keys the port reads now -> (the values that raised before it did, the
#: values that ran)
HONOURED = {
    "memory.device.size": ([1 << 30], [0]),
    "execution.pipeline.in-flight-batches": ([1, 2], [0, -1]),
    "execution.stage-parallelism": ([2, 4], [0]),
}


def _sorted(rows):
    return sorted(tuple(sorted((k, v.item() if hasattr(v, "item") else v)
                               for k, v in r.items())) for r in rows)


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
        assert _item(str(e.value)) == "12h"


def test_debloater_keys_are_read_not_rejected():
    """``latency-target-ms`` and ``min-size`` drive the debloater: a job
    with them runs and gives the fixed-batch job's rows."""
    want = _run({})
    assert _run({"execution.micro-batch.latency-target-ms": 50,
                 "execution.micro-batch.min-size": 16}) == want


def _process_job(extra, pkg="port"):
    """A keyed process job whose state carries TTL (a descriptor's
    ``StateTtlConfig``, the DataStream user's way to TTL: the reference's
    one TTL key, ``table.exec.state.ttl``, is read only by its Table
    layer, ROADMAP item 11c) and a device value state."""
    import numpy as np

    top = PKGS[pkg]
    KeyedProcessFunction = top.KeyedProcessFunction
    RecordBatch = top.RecordBatch
    ReducingStateDescriptor = top.ReducingStateDescriptor
    DeviceValueStateDescriptor = _mod(
        pkg, "state.async_state").DeviceValueStateDescriptor
    StateTtlConfig = _mod(pkg, "state.ttl").StateTtlConfig

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

    env, src, sink = _env(pkg, extra)
    src.key_by("key").process(Fn()).sink_to(sink)
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


@pytest.mark.parametrize("key", sorted(HONOURED))
def test_honoured_key_gives_the_references_window_rows(key):
    """A key that used to raise (ROADMAP items 12a/12b) runs at those
    values and gives the reference's rows."""
    for value in HONOURED[key][0]:
        got = _sorted(_run({key: value}))
        assert got == _sorted(_run({key: value}, "ref"))
        assert got == _sorted(_run({}))


@pytest.mark.parametrize("key", sorted(HONOURED))
def test_honoured_key_gives_the_references_process_rows(key):
    for value in HONOURED[key][0]:
        got = _sorted(_process_job({key: value}))
        assert len(got) == 9
        assert got == _sorted(_process_job({key: value}, "ref"))


@pytest.mark.parametrize("key", sorted(HONOURED))
def test_honoured_key_at_the_values_that_ran_is_unchanged(key):
    want = _run({})
    for value in HONOURED[key][1]:
        assert _run({key: value}) == want
        assert _sorted(_process_job({key: value})) == \
            _sorted(_process_job({}))
