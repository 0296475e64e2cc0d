"""Managed device memory (``core/memory.py``, ``memory.device.size``)
against the reference's ``MemoryManager`` on the CPU: the pool's
arithmetic and errors, and every layout's reservations (slot table, pane
ring, mesh planes) equal to the reference's in bytes after the same job.
Tolerance: none (byte counts)."""

import numpy as np
import pytest

import flink_tpu
import flink_tpu_torch
from flink_tpu.core.memory import MemoryManager as JMemory
from flink_tpu_torch.core.memory import MemoryManager, MemoryReservationError

PKGS = {"ref": flink_tpu, "port": flink_tpu_torch}


def test_reserve_release_like_the_reference():
    for cls in (MemoryManager, JMemory):
        m = cls(1000)
        m.reserve("a", 400)
        m.reserve("b", 500)
        assert m.reserved_bytes == 900
        with pytest.raises(RuntimeError, match="a=400"):
            m.reserve("c", 200)
        m.release("a", 400)
        m.reserve("c", 200)
        assert m.usage() == {"b": 500, "c": 200}
        assert m.release_all("b") == 500
        assert m.reserved_bytes == 200
    m = MemoryManager(0)
    m.reserve("x", 1 << 40)
    assert m.reserved_bytes == 1 << 40


def _job(pkg, conf, parallelism=1):
    top = PKGS[pkg]
    from importlib import import_module

    src = import_module(f"{top.__name__}.connectors.sources")
    sinks = import_module(f"{top.__name__}.connectors.sinks")
    wm = import_module(f"{top.__name__}.runtime.watermarks")
    asg = import_module(f"{top.__name__}.windowing.assigners")
    full = {"execution.micro-batch.size": 1000,
            "parallelism.default": parallelism, **conf}
    if pkg == "port":
        full["execution.device"] = "cpu"
    env = top.StreamExecutionEnvironment(top.Configuration(full))
    sink = sinks.CollectSink()
    (env.from_source(src.DataGenSource(
        total_records=20_000, num_keys=3_000,
        events_per_second_of_eventtime=10_000, seed=5),
        wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
       .key_by("key").window(asg.TumblingEventTimeWindows.of(1000))
       .sum("value").sink_to(sink))
    return env, sink


@pytest.mark.parametrize("layout,parallelism", [
    ("slots", 1), ("panes", 1), ("slots", 8)])
def test_job_reserves_what_the_reference_reserves(layout, parallelism):
    """The same job in both packages inside a 64 MiB budget: equal rows,
    and the pool holds the same bytes at the end (the state grew past its
    initial capacity on the way)."""
    out = {}
    for pkg in PKGS:
        env, sink = _job(pkg, {"state.slot-table.capacity": 1024,
                               "state.window-layout": layout,
                               "memory.device.size": 64 << 20},
                         parallelism)
        # the executor builds the job's pool: record it
        pools = []
        import flink_tpu.core.memory as jm
        import flink_tpu_torch.core.memory as tm

        mod = tm if pkg == "port" else jm
        real = mod.MemoryManager

        class Recorded(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                pools.append(self)

        mod.MemoryManager = Recorded
        try:
            env.execute("budgeted")
        finally:
            mod.MemoryManager = real
        assert len(pools) == 1
        out[pkg] = (sorted(tuple(sorted(r.items())) for r in sink.rows()),
                    pools[0].reserved_bytes)
    assert out["port"] == out["ref"]
    assert out["port"][1] > 0


@pytest.mark.parametrize("layout", ["slots", "panes"])
def test_over_budget_fails_with_the_breakdown(layout):
    env, _ = _job("port", {"state.slot-table.capacity": 1 << 16,
                           "state.window-layout": layout,
                           "memory.device.size": 1024})
    with pytest.raises(MemoryReservationError, match="memory.device.size"):
        env.execute("starved")


def test_growth_reserves_and_dispose_releases():
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.runtime.operators import (
        OperatorContext,
        WindowAggOperator,
    )
    from flink_tpu_torch.state.keygroups import hash_keys_to_i64
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    mm = MemoryManager(1 << 30)
    op = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                           SumAggregate("v"), "key", capacity=1024)
    op.open(OperatorContext(max_parallelism=128, device="cpu",
                            memory_manager=mm))
    base = mm.reserved_bytes
    assert base > 0
    n = 5000
    b = RecordBatch.from_pydict(
        {"key": np.arange(n, dtype=np.int64), "v": np.ones(n)},
        timestamps=np.zeros(n, dtype=np.int64))
    b = b.with_column("__key_id__", hash_keys_to_i64(b["key"]))
    op.process_batch(b)
    assert mm.reserved_bytes > base
    op.dispose()
    assert mm.reserved_bytes == 0
