"""The two-phase aggregation's local half (``runtime/local_agg.py``
``LocalWindowCombiner``) against the reference's on the CPU: the
combined batch bit for bit, and combined batches folded by every window
layout (slots, panes, the mesh engine) to the reference's rows bit for
bit. Tolerance: none."""

import importlib

import numpy as np
import pytest

import flink_tpu
import flink_tpu_torch

PKGS = {"ref": flink_tpu, "port": flink_tpu_torch}


def _m(pkg, name):
    return importlib.import_module(f"{PKGS[pkg].__name__}.{name}")


def _agg(pkg):
    a = _m(pkg, "windowing.aggregates")
    return a.MultiAggregate([a.SumAggregate("v"), a.CountAggregate(),
                             a.MaxAggregate("v")])


def _batch(pkg, n=5000, keys=40, seed=0):
    rng = np.random.default_rng(seed)
    return _m(pkg, "core.records").RecordBatch.from_pydict(
        {"key": rng.integers(0, keys, n),
         "v": rng.random(n).astype(np.float32)},
        timestamps=rng.integers(0, 10_000, n))


def test_combined_batch_equals_the_references():
    out = {}
    for pkg in PKGS:
        la = _m(pkg, "runtime.local_agg")
        asg = _m(pkg, "windowing.assigners").SlidingEventTimeWindows.of(
            2000, 500)
        comb = la.LocalWindowCombiner(asg, _agg(pkg), "key")
        b = comb.combine(_batch(pkg))
        assert la.is_partial_batch(b)
        assert comb.combine(b) is b  # a combined batch passes through
        out[pkg] = {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes())
                    for k, v in b.columns.items()}
    assert out["port"] == out["ref"]


def test_a_merging_assigner_is_rejected():
    from flink_tpu_torch.runtime.local_agg import LocalWindowCombiner
    from flink_tpu_torch.windowing.aggregates import CountAggregate
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    with pytest.raises(ValueError, match="aligned"):
        LocalWindowCombiner(EventTimeSessionWindows.with_gap(100),
                            CountAggregate(), "key")


@pytest.mark.parametrize("layout,parallelism", [
    ("slots", 1), ("panes", 1), ("slots", 4)])
def test_combined_batches_fold_to_the_references_rows(layout,
                                                      parallelism):
    """Pre-combined batches through the window operator: the reference's
    rows bit for bit (sum, count and max)."""
    rows = {}
    for pkg in PKGS:
        top = PKGS[pkg]
        conf = {"execution.micro-batch.size": 500,
                "state.window-layout": layout,
                "parallelism.default": parallelism}
        if pkg == "port":
            conf["execution.device"] = "cpu"
        env = top.StreamExecutionEnvironment(top.Configuration(conf))
        sink = _m(pkg, "connectors.sinks").CollectSink()
        asg = _m(pkg, "windowing.assigners")
        src = _m(pkg, "connectors.sources").DataGenSource(
            total_records=20_000, num_keys=100,
            events_per_second_of_eventtime=10_000, seed=3)
        a = _m(pkg, "windowing.aggregates")
        agg = a.MultiAggregate([a.SumAggregate("value"),
                                a.CountAggregate(), a.MaxAggregate("value")])
        comb = _m(pkg, "runtime.local_agg").LocalWindowCombiner(
            asg.SlidingEventTimeWindows.of(2000, 1000), agg, "key")
        (env.from_source(src, _m(pkg, "runtime.watermarks")
                         .WatermarkStrategy.for_bounded_out_of_orderness(0))
         .map(comb.combine, name="local_combine")
         .key_by("key").window(asg.SlidingEventTimeWindows.of(2000, 1000))
         .aggregate(agg).sink_to(sink))
        env.execute("combined")
        rows[pkg] = sorted(
            (int(r["key"]), int(r["window_start"]),
             np.float32(r["sum_value"]).tobytes(), int(r["count"]),
             np.float32(r["max_value"]).tobytes())
            for r in sink.rows())
    assert rows["port"] == rows["ref"]
    assert len(rows["port"]) > 50
