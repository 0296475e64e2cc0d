"""Savepoints and stop-with-savepoint through the port's control queue
against the reference's ``LocalExecutor.run(control_queue=...)`` on the
CPU, with the requests queued at the same batch boundary in both (a
source queues them as it hands out a given batch). The stopped run's
rows, the resumed run's rows and the savepoints' source positions are
equal to the reference's, row for row in order (tolerance: none); the
two runs together equal the uninterrupted job exactly once; with
``drain=True`` every window up to the cut fires at the stop. A state
query queued the same way is answered as the reference answers it; a
rescale request fails naming ROADMAP item 12g.
"""

import queue

import pytest

import flink_tpu
import flink_tpu_torch
from flink_tpu.cluster import local_executor as jle
from flink_tpu.connectors import sinks as jsinks
from flink_tpu.connectors import sources as jsources
from flink_tpu.runtime.watermarks import WatermarkStrategy as JWS
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JTumble
from flink_tpu_torch.checkpoint.savepoint import is_savepoint
from flink_tpu_torch.cluster import local_executor as tle
from flink_tpu_torch.connectors import sinks as tsinks
from flink_tpu_torch.connectors import sources as tsources
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy as TWS
from flink_tpu_torch.windowing.assigners import \
    TumblingEventTimeWindows as TTumble

PKGS = {
    "ref": dict(mod=flink_tpu, le=jle, sinks=jsinks, sources=jsources,
                WS=JWS, Tumble=JTumble,
                conf={"execution.pipeline.in-flight-batches": 0}),
    "port": dict(mod=flink_tpu_torch, le=tle, sinks=tsinks,
                 sources=tsources, WS=TWS, Tumble=TTumble,
                 conf={"execution.device": "cpu",
                       "execution.pipeline.in-flight-batches": 0}),
}
TOTAL, KEYS, RATE, BATCH = 20_000, 50, 2_000, 512


def _source(pkg, control=None, request=None, after=0):
    """DataGen that queues ``request`` on ``control`` as it hands out
    batch ``after``: the executor serves it once that batch went through
    the job."""
    base = PKGS[pkg]["sources"].DataGenSource

    class Queueing(base):
        polled = 0

        def poll_batch(self, n):
            b = super().poll_batch(n)
            self.polled += 1
            if control is not None and self.polled == after:
                control.put(request)
            return b

    return Queueing(total_records=TOTAL, num_keys=KEYS,
                    events_per_second_of_eventtime=RATE, seed=5)


def _job(pkg, source, sink, parallelism=1):
    p = PKGS[pkg]
    env = p["mod"].StreamExecutionEnvironment(p["mod"].Configuration(
        {"execution.micro-batch.size": BATCH,
         "parallelism.default": parallelism, **p["conf"]}))
    env.from_source(source, p["WS"].for_bounded_out_of_orderness(0),
                    name="gen").key_by("key").window(
        p["Tumble"].of(1000)).sum("value").sink_to(sink)
    return env


def _rows(sink):
    return [tuple(r.values()) for b in sink.batches for r in b.to_rows()]


def _stop_run(pkg, tmp_path, drain=False, after=7, parallelism=1):
    p = PKGS[pkg]
    control = queue.Queue()
    sp = str(tmp_path / f"{pkg}-sp")
    req = p["le"].SavepointRequest(sp, stop=True, drain=drain)
    sink = p["sinks"].CollectSink()
    env = _job(pkg, _source(pkg, control, req, after), sink, parallelism)
    result = p["le"].LocalExecutor(env.config if pkg == "port"
                                   else env._effective_config()).run(
        env.get_stream_graph(), "sp-job", control_queue=control)
    path = req.wait(timeout=5)
    assert result.metrics["savepoint"] == path
    return sink, path


def _resume(pkg, path, parallelism=1):
    sink = PKGS[pkg]["sinks"].CollectSink()
    _job(pkg, _source(pkg), sink, parallelism).execute(
        "resumed", restore_from=path)
    return sink


def _uninterrupted(pkg):
    sink = PKGS[pkg]["sinks"].CollectSink()
    _job(pkg, _source(pkg), sink).execute("clean")
    return _rows(sink)


def _windows(rows):
    """(key, window start) of each row."""
    return {(r[0], r[1]): r for r in rows}


def test_stop_with_savepoint_then_resume_equals_reference(tmp_path):
    got = {}
    for pkg in PKGS:
        sink1, path = _stop_run(pkg, tmp_path)
        sink2 = _resume(pkg, path)
        got[pkg] = (_rows(sink1), _rows(sink2))
        assert is_savepoint(path)
    assert got["port"] == got["ref"]
    part1, part2 = got["port"]
    # stopped mid-flight; no window twice; the union is the clean run
    clean = _uninterrupted("port")
    assert 0 < len(part1) < len(clean)
    assert not set(_windows(part1)) & set(_windows(part2))
    assert sorted(part1 + part2) == sorted(clean) == sorted(
        _uninterrupted("ref"))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_resume_from_the_other_packages_stop(tmp_path, writer, reader):
    sink1, path = _stop_run(writer, tmp_path)
    sink2 = _resume(reader, path)
    assert sorted(_rows(sink1) + _rows(sink2)) == sorted(
        _uninterrupted(reader))


def test_stop_with_drain_fires_every_window_at_the_stop(tmp_path):
    from flink_tpu_torch.checkpoint.storage import read_checkpoint_chain

    got = {}
    for pkg in PKGS:
        sink, path = _stop_run(pkg, tmp_path, drain=True)
        emitted = [s["source"]["emitted"]
                   for s in read_checkpoint_chain(path).values()
                   if "source" in s]
        got[pkg] = (_rows(sink), emitted)
    assert got["port"] == got["ref"]
    rows, emitted = got["port"]
    # 7 batches read (3,584 records, event time 0..1,791 ms): both windows
    # they touch fired, the open one [1000, 2000) too, at the stop
    assert emitted == [7 * BATCH]
    assert {r[1] for r in rows} == {0, 1000}
    clean = _windows(_uninterrupted("port"))
    assert all(clean[w] == r for w, r in _windows(rows).items()
               if w[1] == 0)


def test_drain_counts_every_record_read(tmp_path):
    """As ``tests/test_savepoints.py``'s drain case: the Count windows
    fired at a drained stop count exactly the records the savepoint's
    source position says were read."""
    for pkg in PKGS:
        p = PKGS[pkg]
        control = queue.Queue()
        req = p["le"].SavepointRequest(str(tmp_path / f"d-{pkg}"), stop=True,
                                       drain=True)
        sink = p["sinks"].CollectSink()
        env = p["mod"].StreamExecutionEnvironment(p["mod"].Configuration(
            {"execution.micro-batch.size": BATCH, **p["conf"]}))
        env.from_source(_source(pkg, control, req, 5),
                        p["WS"].for_bounded_out_of_orderness(0), name="gen") \
            .key_by("key").window(p["Tumble"].of(1000)).count() \
            .sink_to(sink)
        cfg = env.config if pkg == "port" else env._effective_config()
        p["le"].LocalExecutor(cfg).run(env.get_stream_graph(), "d",
                                       control_queue=control)
        req.wait(timeout=5)
        assert sum(int(r["count"]) for b in sink.batches
                   for r in b.to_rows()) == 5 * BATCH


def test_exactly_once_across_stop_and_resume_at_parallelism_8(tmp_path):
    sink1, path = _stop_run("port", tmp_path, after=11, parallelism=8)
    sink2 = _resume("port", path, parallelism=8)
    part1, part2 = _rows(sink1), _rows(sink2)
    assert not set(_windows(part1)) & set(_windows(part2))
    assert sorted(part1 + part2) == sorted(_uninterrupted("port"))


def test_savepoint_without_stop_keeps_the_job_running(tmp_path):
    control = queue.Queue()
    req = tle.SavepointRequest(str(tmp_path / "sp"))
    sink = tsinks.CollectSink()
    env = _job("port", _source("port", control, req, 3), sink)
    result = tle.LocalExecutor(env.config).run(env.get_stream_graph(), "j",
                                               control_queue=control)
    path = req.wait(timeout=5)
    assert is_savepoint(path) and "savepoint" not in result.metrics
    assert sorted(_rows(sink)) == sorted(_uninterrupted("port"))
    # resuming from it replays from batch 3 on: those windows fire again
    again = _rows(_resume("port", path))
    assert again and set(again) <= set(_rows(sink))


def test_bad_target_fails_the_request_and_the_job_runs_on(tmp_path):
    target = tmp_path / "taken"
    target.mkdir()
    (target / "x").write_text("data")
    control = queue.Queue()
    req = tle.SavepointRequest(str(target), stop=True)
    sink = tsinks.CollectSink()
    env = _job("port", _source("port", control, req, 2), sink)
    result = tle.LocalExecutor(env.config).run(env.get_stream_graph(), "j",
                                               control_queue=control)
    with pytest.raises(FileExistsError):
        req.wait(timeout=5)
    assert "savepoint" not in result.metrics
    assert sorted(_rows(sink)) == sorted(_uninterrupted("port"))


@pytest.mark.parametrize("make", [
    lambda: tle.StateQueryRequest("window_agg(SumAggregate)", 7),
    lambda: tle.RescaleRequest(4)])
def test_query_and_rescale_requests_fail_naming_item_12(make):
    control = queue.Queue()
    req = make()
    sink = tsinks.CollectSink()
    # a rescale needs a mesh engine: that case runs at parallelism 8
    par = 8 if isinstance(req, tle.RescaleRequest) else 1
    env = _job("port", _source("port", control, req, 2), sink, par)
    tle.LocalExecutor(env.config).run(env.get_stream_graph(), "j",
                                      control_queue=control)
    if isinstance(req, tle.RescaleRequest):
        # live rescale (item 12g) is served now: at the same boundary the
        # reference's executor moves the same rows from 8 to 4 shards, and
        # the rescaled job's rows equal the uninterrupted job's
        jcontrol = queue.Queue()
        jreq = jle.RescaleRequest(4)
        jsink = jsinks.CollectSink()
        jenv = _job("ref", _source("ref", jcontrol, jreq, 2), jsink, 8)
        jle.LocalExecutor(jenv._effective_config()).run(
            jenv.get_stream_graph(), "j", control_queue=jcontrol)
        got, want = req.wait(timeout=5), jreq.wait(timeout=5)
        assert (got["from"], got["to"]) == (want["from"], want["to"]) \
            == (8, 4)
        assert got["rows_moved"] == want["rows_moved"] > 0
        assert sorted(_rows(sink)) == sorted(_rows(jsink))
        clean = tsinks.CollectSink()
        _job("port", _source("port"), clean, 8).execute("clean")
        assert sorted(_rows(sink)) == sorted(_rows(clean))
        return
    if isinstance(req, tle.StateQueryRequest):
        # state queries (item 12e) are served now: at the same boundary
        # the reference answers the same {window_end: {column: value}}
        jcontrol = queue.Queue()
        jreq = jle.StateQueryRequest("window_agg(SumAggregate)", 7)
        jenv = _job("ref", _source("ref", jcontrol, jreq, 2),
                    jsinks.CollectSink())
        jle.LocalExecutor(jenv._effective_config()).run(
            jenv.get_stream_graph(), "j", control_queue=jcontrol)
        got, want = req.wait(timeout=5), jreq.wait(timeout=5)
        assert got == want and got
    assert sorted(_rows(sink)) == sorted(_uninterrupted("port"))


def test_requests_left_in_the_queue_fail_when_the_job_ends(tmp_path):
    control = queue.Queue()
    first = tle.SavepointRequest(str(tmp_path / "a"), stop=True)
    late = tle.SavepointRequest(str(tmp_path / "b"))
    control.put(first)
    control.put(late)
    env = _job("port", _source("port"), tsinks.CollectSink())
    # ``first`` stops the job at the first boundary; ``late`` was queued
    # behind it and is failed, not left blocking its client
    tle.LocalExecutor(env.config).run(env.get_stream_graph(), "j",
                                      control_queue=control)
    assert is_savepoint(first.wait(timeout=5))
    with pytest.raises(RuntimeError, match="already terminated"):
        late.wait(timeout=5)
