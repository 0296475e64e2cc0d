"""Reference methods the port lacked outright (ROADMAP Queue C item 15,
closed): each against the reference's on the same inputs on the CPU.
Tolerance: none."""

import numpy as np
import pytest

import flink_tpu
import flink_tpu_torch
from flink_tpu.core import config as jconfig
from flink_tpu.runtime.watermarks import WatermarkValve as JValve
from flink_tpu.windowing import assigners as jasg
from flink_tpu_torch.core import config as tconfig
from flink_tpu_torch.runtime.watermarks import WatermarkValve
from flink_tpu_torch.windowing import assigners as tasg


def test_valve_idleness():
    """The port's counterpart of the reference's
    ``tests/test_source_v2.py::test_valve_idleness``."""
    v = WatermarkValve(2)
    assert v.advance(0, 100) is None  # input 1 still at MIN
    assert v.mark_idle(1) == 100  # an idle input no longer holds it back
    assert v.advance(0, 200) == 200
    assert v.advance(1, 150) is None  # reactivates below combined
    assert v.advance(1, 300) is None  # min(200, 300) = 200, no advance
    assert v.advance(0, 300) == 300


def test_valve_sequences_equal_the_references():
    rng = np.random.default_rng(7)
    ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 2)),
            int(rng.integers(0, 1000))) for _ in range(400)]
    outs = []
    for cls in (JValve, WatermarkValve):
        v, out = cls(3), []
        for kind, ch, wm in ops:
            out.append(v.mark_idle(ch) if kind == 0 else v.advance(ch, wm))
        outs.append((out, v.combined))
    assert outs[0] == outs[1]
    # every input idle holds the last combined value
    v = WatermarkValve(2)
    v.advance(0, 5)
    v.advance(1, 9)
    assert v.mark_idle(0) == 9 and v.mark_idle(1) is None
    assert v.combined == 9


def test_environment_settings_equal_the_references():
    conf = {"state.window-layout": "panes", "shuffle.mode": "device",
            "state.backend": "host-heap"}
    got = [(e.window_layout, e.shuffle_mode, e.state_backend)
           for e in (flink_tpu.StreamExecutionEnvironment(
               flink_tpu.Configuration(conf)),
               flink_tpu_torch.StreamExecutionEnvironment(
                   flink_tpu_torch.Configuration(conf)))]
    assert got[0] == got[1] == ("panes", "device", "host-heap")
    defaults = [(e.window_layout, e.shuffle_mode, e.state_backend)
                for e in (flink_tpu.StreamExecutionEnvironment(),
                          flink_tpu_torch.StreamExecutionEnvironment())]
    assert defaults[0] == defaults[1]


@pytest.mark.parametrize("make", [
    lambda m: m.TumblingEventTimeWindows.of(1000),
    lambda m: m.SlidingEventTimeWindows.of(2000, 500),
    lambda m: m.SlidingEventTimeWindows.of(3000, 1000),
    lambda m: m.EventTimeSessionWindows.with_gap(40),
], ids=["tumble", "slide", "slide-3", "session"])
def test_assigner_methods_equal_the_references(make):
    j, t = make(jasg), make(tasg)
    assert t.is_merging == j.is_merging
    if j.is_merging:
        return
    w = t.slice_width
    for se in range(-20 * w, 20 * w, w):
        assert t.last_window_end_for_slice(se) == \
            j.last_window_end_for_slice(se), se
    ses = np.arange(-20 * w, 20 * w, w, dtype=np.int64)
    assert t.last_window_ends(ses).tolist() == [
        t.last_window_end_for_slice(int(s)) for s in ses]


def test_record_batch_empty_like_and_rename():
    from flink_tpu.core.records import RecordBatch as JBatch
    from flink_tpu_torch.core.records import RecordBatch

    cols = {"a": np.arange(5), "b": np.linspace(0, 1, 5)}
    out = []
    for cls in (JBatch, RecordBatch):
        b = cls.from_pydict(cols, timestamps=np.arange(5) * 10)
        e = cls.empty_like(b)
        r = b.rename({"a": "k", "missing": "x"})
        out.append(([(n, np.asarray(v).dtype.str, len(v))
                     for n, v in e.columns.items()],
                    {n: np.asarray(v).tolist()
                     for n, v in r.columns.items()}))
    assert out[0] == out[1]
    assert out[1][0] and all(n == 0 for _, _, n in out[1][0])
    assert "k" in out[1][1] and "a" not in out[1][1]


def test_configuration_methods_equal_the_references():
    got = []
    for m in (jconfig, tconfig):
        opt = m.ConfigOption("x.size", default=3, type=int)
        opt9 = opt.with_default(9)
        base = m.Configuration({"x.size": "5", "y": 1})
        top = m.Configuration({"y": 2, "z": "on"}).with_fallback(base)
        cp = top.copy()
        cp.set("w", 4)
        got.append((opt9.default, opt9.key, top.get(opt), top.get(opt9),
                    top.contains("x.size"), top.contains(opt),
                    top.contains("nope"), top.get_raw("y"),
                    top.get_raw("nope", "dflt"), top.to_dict(),
                    sorted(top.keys()), cp.to_dict(), top.contains("w"),
                    m.Configuration().get(opt9)))
    assert got[0] == got[1]
    assert got[1][3] == 5 and got[1][7] == 2


def test_mesh_engine_counts_late_records_like_the_reference():
    import jax

    from flink_tpu.core.records import RecordBatch as JBatch
    from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
    from flink_tpu.parallel.sharded_windower import MeshWindowEngine as JEng
    from flink_tpu.windowing.aggregates import SumAggregate as JSum
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    assert len(jax.devices()) >= 4
    engines = [
        (JEng(jasg.TumblingEventTimeWindows.of(100), JSum("v"),
              jmake_mesh(4), capacity_per_shard=1024), JBatch),
        (MeshWindowEngine(tasg.TumblingEventTimeWindows.of(100),
                          SumAggregate("v"), make_mesh(4, "cpu"),
                          capacity_per_shard=1024), RecordBatch)]
    counts = []
    for eng, cls in engines:
        for step in range(6):
            keys = np.arange(40, dtype=np.int64)
            ts = np.full(40, 100 * step + 5, dtype=np.int64)
            ts[::7] = 3  # behind every watermark after the first
            eng.process_batch(cls.from_pydict(
                {"__key_id__": keys, "v": np.ones(40, np.float32)},
                timestamps=ts))
            eng.on_watermark(100 * step + 50)
        counts.append(eng.late_records_dropped)
    assert counts[0] == counts[1] > 0


def test_slot_groups_and_size_estimates_equal_the_references():
    """``DataStream.slot_sharing_group`` / ``StreamGraph.slot_groups`` and
    ``Source.estimate_records`` (the stage executor's inputs, ROADMAP item
    12b)."""
    import importlib

    got = []
    for top in (flink_tpu, flink_tpu_torch):
        src = importlib.import_module(f"{top.__name__}.connectors.sources")
        sinks = importlib.import_module(f"{top.__name__}.connectors.sinks")
        nx = importlib.import_module(f"{top.__name__}.benchmarks.nexmark")
        env = top.StreamExecutionEnvironment(top.Configuration(
            {"execution.device": "cpu"} if top is flink_tpu_torch else {}))
        gen = src.DataGenSource(total_records=1234, num_keys=5,
                                events_per_second_of_eventtime=100)
        ds = env.from_source(gen).map(lambda b: b, name="m") \
            .slot_sharing_group("hot")
        ds.key_by("key").map(lambda b: b, name="n").sink_to(
            sinks.CollectSink())
        graph = env.get_stream_graph()
        groups = graph.slot_groups()
        got.append(([(t.name, groups[t.uid]) for t in graph.nodes],
                    graph.distinct_slot_groups(), gen.estimate_records(),
                    src.CollectionSource.of_rows(
                        [{"a": i} for i in range(7)], 3).estimate_records(),
                    nx.BidSource(total_records=99).estimate_records(),
                    src.Source().estimate_records()))
    assert got[0] == got[1]
    assert got[1][1] == ["default", "hot"]
