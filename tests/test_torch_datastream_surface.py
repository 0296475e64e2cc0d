"""The DataStream surface of the port against the reference's on the CPU:
``filter``, ``flat_map``, ``union``, ``print``, ``execute_and_collect``,
``WindowedStream.aggregate_all``, the environment's settings and
``from_batches``, and the ``DiscardingSink``, ``PrintSink`` and
``JsonLinesFileSink`` sinks. Each job runs in both packages on the same
rows; the sink rows are equal in order, bit for bit (tolerance: none).
The public classes carry the reference's stability markers.
"""

import json

import numpy as np
import pytest

import flink_tpu
import flink_tpu_torch
from flink_tpu.connectors import sinks as jsinks
from flink_tpu.core.records import RecordBatch as JBatch
from flink_tpu.runtime.watermarks import WatermarkStrategy as JWS
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing import assigners as jasg
from flink_tpu_torch.connectors import sinks as tsinks
from flink_tpu_torch.core.records import RecordBatch as TBatch
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy as TWS
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing import assigners as tasg

from tests.test_torch_mesh_sessions import _bits

PKGS = {
    "ref": (flink_tpu, jsinks, JBatch, JWS, jagg, jasg,
            {"execution.pipeline.in-flight-batches": 0}),
    "port": (flink_tpu_torch, tsinks, TBatch, TWS, tagg, tasg,
             {"execution.device": "cpu",
              "execution.pipeline.in-flight-batches": 0}),
}

ROWS = [{"key": i % 5, "value": float(i % 7) - 2.5, "ts": 37 * i,
         "text": f"a b {i % 3}"} for i in range(400)]


def _env(pkg, **cfg):
    mod, _, _, _, _, _, extra = PKGS[pkg]
    return mod.StreamExecutionEnvironment(mod.Configuration(
        {"execution.micro-batch.size": 64, **extra, **cfg}))


def _source(env, pkg, rows=ROWS):
    ws = PKGS[pkg][3]
    return env.from_collection(
        rows, timestamp_field="ts",
        watermark_strategy=ws.for_bounded_out_of_orderness(0))


def _split(pkg):
    batch_cls = PKGS[pkg][2]

    def split(b):
        words, keys, ts = [], [], []
        for t, k, tm in zip(b["text"], b["key"], b.timestamps):
            for w in str(t).split():
                words.append(w)
                keys.append(k)
                ts.append(tm)
        arr = np.empty(len(words), dtype=object)
        arr[:] = words
        return [batch_cls.from_pydict(
            {"word": arr, "key": np.asarray(keys, dtype=np.int64),
             "one": np.ones(len(words), dtype=np.int64)},
            timestamps=np.asarray(ts, dtype=np.int64))]

    return split


def _jobs(pkg):
    """name -> job(env, sink) over the package's API."""
    _, _, _, _, agg, asg, _ = PKGS[pkg]
    tumble = asg.TumblingEventTimeWindows.of(1000)

    def filt(env, sink):
        _source(env, pkg).filter(lambda b: b["value"] > 0) \
            .key_by("key").window(tumble).sum("value").sink_to(sink)

    def flat(env, sink):
        _source(env, pkg).flat_map(_split(pkg)).key_by("word") \
            .window(asg.SlidingEventTimeWindows.of(2000, 1000)) \
            .sum("one").sink_to(sink)

    def union(env, sink):
        a = _source(env, pkg, ROWS[::2])
        b = _source(env, pkg, ROWS[1::2])
        c = _source(env, pkg, ROWS[:50]).map(
            lambda x: x.with_column("value", x["value"] * 2))
        a.union(b, c).key_by("key").window(tumble).sum("value") \
            .sink_to(sink)

    def agg_all(env, sink):
        _source(env, pkg).key_by("key").window(tumble).aggregate_all(
            [agg.CountAggregate(), agg.SumAggregate("value"),
             agg.MaxAggregate("value")]).sink_to(sink)

    def agg_all_p8(env, sink):
        env.set_parallelism(8)
        agg_all(env, sink)

    def from_batches(env, sink):
        batch_cls = PKGS[pkg][2]
        bs = [batch_cls.from_pydict(
            {"key": np.arange(i, i + 10, dtype=np.int64) % 4,
             "value": np.full(10, 0.5 + i, dtype=np.float32)},
            timestamps=np.arange(i * 100, i * 100 + 10, dtype=np.int64))
            for i in range(6)]
        env.from_batches(bs, PKGS[pkg][3].for_bounded_out_of_orderness(0)) \
            .key_by("key").window(tumble).sum("value").sink_to(sink)

    return {"filter": filt, "flat_map": flat, "union": union,
            "aggregate_all": agg_all, "aggregate_all_p8": agg_all_p8,
            "from_batches": from_batches}


def _run(pkg, job):
    env = _env(pkg)
    sink = PKGS[pkg][1].CollectSink()
    _jobs(pkg)[job](env, sink)
    env.execute(job)
    return [b.to_pydict() for b in sink.batches]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            if a.dtype.kind == "O" or b.dtype.kind == "O":
                assert a.tolist() == b.tolist(), name
            else:
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=name)


@pytest.mark.parametrize("job", sorted(_jobs("port")))
def test_job_rows_equal_reference(job):
    _assert_batches_equal(_run("port", job), _run("ref", job))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_execute_and_collect(pkg):
    env = _env(pkg)
    out = _source(env, pkg).filter(lambda b: b["key"] == 3) \
        .key_by("key").window(PKGS[pkg][5].TumblingEventTimeWindows.of(
            5000)).count().execute_and_collect()
    assert sorted(out["count"].tolist()) == [26, 27, 27]


def test_execute_and_collect_equals_reference():
    rows = {}
    for pkg in PKGS:
        env = _env(pkg)
        out = _source(env, pkg).key_by("key").window(
            PKGS[pkg][5].TumblingEventTimeWindows.of(3000)).avg("value") \
            .execute_and_collect()
        rows[pkg] = out.to_pydict()
    _assert_batches_equal([rows["port"]], [rows["ref"]])


def _sink_job(pkg, sink):
    env = _env(pkg)
    _source(env, pkg).key_by("key").window(
        PKGS[pkg][5].TumblingEventTimeWindows.of(2000)).sum("value") \
        .sink_to(sink)
    env.execute("sinks")


def test_print_sink_output_equals_reference(capsys):
    out = {}
    for pkg in PKGS:
        env = _env(pkg)
        _source(env, pkg).key_by("key").window(
            PKGS[pkg][5].TumblingEventTimeWindows.of(4000)).sum("value") \
            .print("w")
        env.execute("print")
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["ref"]
    assert out["port"].count("w> ") == 20


@pytest.mark.parametrize("max_rows", [None, 3])
def test_print_sink_rows_equal_reference(capsys, max_rows):
    out = {}
    for pkg in PKGS:
        _sink_job(pkg, PKGS[pkg][1].PrintSink("p", max_rows_per_batch=max_rows))
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["ref"] and out["port"]
    assert ("more" in out["port"]) == (max_rows is not None)


def test_discarding_sink_runs_the_job():
    for pkg in PKGS:
        _sink_job(pkg, PKGS[pkg][1].DiscardingSink())


@pytest.mark.parametrize("scheme", ["", "file://"])
def test_json_lines_sink_equals_reference(tmp_path, scheme):
    lines = {}
    for pkg in PKGS:
        path = f"{scheme}{tmp_path / pkg / 'out.jsonl'}"
        _sink_job(pkg, PKGS[pkg][1].JsonLinesFileSink(path))
        lines[pkg] = (tmp_path / pkg / "out.jsonl").read_text()
        assert PKGS[pkg][1].JsonLinesFileSink.read_rows(path) == [
            json.loads(x) for x in lines[pkg].splitlines()]
    assert lines["port"] == lines["ref"] and lines["port"]


def test_json_lines_sink_appends_across_runs(tmp_path):
    path = str(tmp_path / "a.jsonl")
    _sink_job("port", tsinks.JsonLinesFileSink(path))
    first = len(tsinks.JsonLinesFileSink.read_rows(path))
    _sink_job("port", tsinks.JsonLinesFileSink(path))
    assert len(tsinks.JsonLinesFileSink.read_rows(path)) == 2 * first
    assert tsinks.JsonLinesFileSink.read_rows(str(tmp_path / "no")) == []


def test_non_local_filesystem_scheme_raises_naming_8b():
    """The filesystem SPI is ported (item 8b): ``mem://`` writes and reads
    back as in the reference, and a scheme no filesystem is registered for
    raises the reference's ``ValueError``."""
    _sink_job("port", tsinks.JsonLinesFileSink("mem://bucket/x.jsonl"))
    _sink_job("ref", jsinks.JsonLinesFileSink("mem://bucket/x.jsonl"))
    assert tsinks.JsonLinesFileSink.read_rows("mem://bucket/x.jsonl") == \
        jsinks.JsonLinesFileSink.read_rows("mem://bucket/x.jsonl") != []
    sink = tsinks.JsonLinesFileSink("s3://bucket/x.jsonl")
    with pytest.raises(ValueError, match="no filesystem registered"):
        sink.open()


def test_environment_settings():
    env = flink_tpu_torch.StreamExecutionEnvironment \
        .get_execution_environment(flink_tpu_torch.Configuration(
            {"execution.device": "cpu"}))
    assert env.parallelism == 1 and env.max_parallelism == 128
    assert env.set_parallelism(4) is env and env.parallelism == 4
    assert env.enable_checkpointing(250) is env
    assert env.config.get(flink_tpu_torch.core.config.CheckpointOptions
                          .INTERVAL_MS) == 250


def test_union_passes_timed_and_untimed_batches():
    from flink_tpu_torch.runtime.operators import UnionOperator

    timed = TBatch.from_pydict({"x": np.ones(2)}, timestamps=[0, 1])
    untimed = TBatch({"x": np.ones(2)})
    op = UnionOperator()
    assert op.process_batch(timed) == [timed]
    assert op.process_batch(untimed) == [untimed]


@pytest.mark.parametrize("name", [
    "datastream.environment.StreamExecutionEnvironment",
    "datastream.environment.JobExecutionResult",
    "datastream.stream.DataStream", "datastream.stream.KeyedStream",
    "datastream.stream.WindowedStream",
    "connectors.sinks.Sink", "connectors.sinks.DiscardingSink",
    "connectors.sinks.CollectSink", "connectors.sinks.PrintSink",
    "connectors.sinks.JsonLinesFileSink", "connectors.sources.Source",
    "windowing.assigners.TumblingEventTimeWindows",
    "windowing.assigners.SlidingEventTimeWindows",
    "windowing.assigners.TumblingProcessingTimeWindows",
    "windowing.assigners.SlidingProcessingTimeWindows",
    "windowing.assigners.CumulativeEventTimeWindows",
    "windowing.assigners.EventTimeSessionWindows",
])
def test_stability_markers_equal_reference(name):
    import importlib

    from flink_tpu.core.annotations import stability_of as jstab
    from flink_tpu_torch.core.annotations import stability_of

    mod, cls = name.rsplit(".", 1)
    j = getattr(importlib.import_module(f"flink_tpu.{mod}"), cls)
    t = getattr(importlib.import_module(f"flink_tpu_torch.{mod}"), cls)
    assert stability_of(t) == jstab(j) is not None
