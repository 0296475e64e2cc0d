"""CPU tests of the per-layer readers of the port's spans, on synthetic runs
with hand-placed flight-recorder records: totals per Mevent, span unions
clipped to the window, thread CPU against wall, and the wait records that
the percentile readers read and the idle split skips.

    python3 -m pytest streambench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from flink_tpu_torch.observe import KNOWN_SPAN_KINDS
from flink_tpu_torch.observe.flight_recorder import FlightRecorder, SpanRecord

from streambench import spec
from streambench.run import Run

NEW = ("route_s_per_mev", "slots_s_per_mev", "stage_s_per_mev",
       "ingest_offcpu_pct", "fire_resolve_s_per_mev", "source_wait_pct",
       "queue_wait_p95_ms", "harvest_wait_p95_ms")


def rec(kind, t0, t1, cpu=0.0, waited=False):
    return SpanRecord(kind=kind, instant=waited, t0=t0, t1=t1, job="j",
                      shard=-1, batch_id=-1, watermark=None, thread="t",
                      cpu_s=cpu, waited=waited)


def make_run(spans=None, totals=None, events=2_000_000, window=(10.0, 20.0)):
    return Run(cell=None, events=events, window=window, setup_s=1.0,
               source=None, rows=None, log=None, reference=None,
               expected=None, span_totals=totals or {}, spans=spans,
               device=None, job_metrics={})


def reader(name):
    return spec.load_module("metrics", name)


@pytest.mark.parametrize("name,kind", [("route_s_per_mev", "prep.route"),
                                       ("slots_s_per_mev", "prep.slots"),
                                       ("stage_s_per_mev", "prep.stage")])
def test_ingest_totals_per_mevent(name, kind):
    totals = {kind: {"count": 8, "total_s": 3.0},
              "batch.ingest": {"count": 1, "total_s": 9.0}}
    assert reader(name).read(make_run(totals=totals)) == pytest.approx(1.5)
    assert reader(name).read(make_run(totals=totals, events=0)) is None


def test_ingest_offcpu_share_of_the_ingest_wall():
    spans = [rec("batch.ingest", 11.0, 12.0, cpu=0.75),
             rec("batch.ingest", 13.0, 16.0, cpu=2.25),
             # no CPU reading, outside the window, another kind: not read
             rec("batch.ingest", 16.0, 19.0, cpu=None),
             rec("batch.ingest", 1.0, 9.0, cpu=0.0),
             rec("prep.route", 11.0, 12.0, cpu=0.0)]
    read = reader("ingest_offcpu_pct").read
    assert read(make_run(spans)) == pytest.approx(25.0)
    # records without CPU seconds (an older recorder's) read nothing
    old = [SimpleNamespace(kind="batch.ingest", instant=False, t0=11.0,
                           t1=12.0)]
    assert read(make_run(old)) is None
    assert read(make_run(None)) is None
    assert read(make_run([rec("batch.ingest", 11.0, 12.0, cpu=None)])) \
        is None


def test_fire_resolve_union_clipped_to_the_window():
    spans = [rec("fire.shard", 9.0, 11.0),      # clipped to [10, 11]
             rec("fire.shard", 10.5, 12.0),     # overlaps: union [10, 12]
             rec("fire.shard", 15.0, 15.5),
             rec("fire.dispatch", 9.0, 16.0)]
    assert reader("fire_resolve_s_per_mev").read(make_run(spans)) == \
        pytest.approx(2.5 / 2.0)


def test_source_wait_share_of_the_window():
    spans = [rec("source.wait", 10.0, 11.0), rec("source.wait", 12.0, 12.5),
             rec("source.wait", 19.5, 21.0),    # clipped to [19.5, 20]
             rec("op.process", 11.0, 12.0)]
    assert reader("source_wait_pct").read(make_run(spans)) == \
        pytest.approx(100.0 * 2.0 / 10.0)


@pytest.mark.parametrize("name,kind", [("queue_wait_p95_ms", "source.queue"),
                                       ("harvest_wait_p95_ms",
                                        "fire.pending")])
def test_wait_percentiles_read_the_wait_records(name, kind):
    d = np.arange(1, 101) * 1e-3                 # 1..100 ms
    spans = [rec(kind, 15.0 - x, 15.0, waited=True) for x in d]
    spans += [rec(kind, 20.0, 30.0, waited=True),    # ends past the window
              rec("op.process", 11.0, 19.0)]
    got = reader(name).read(make_run(spans))
    assert got == pytest.approx(float(np.percentile(d, 95)) * 1e3)
    assert reader(name).read(make_run([rec("op.process", 11, 12)])) is None


def test_a_wait_record_is_read_by_its_percentile_and_skipped_by_idle():
    """Recorded through the recorder itself: the wait reads instant=True,
    so the idle split (which attributes a gap to the innermost span)
    skips it, and the queue-wait reader reads it."""
    from streambench.stats import union_s
    from streambench.trace import DeviceTrace, idle_by_host_span

    r = FlightRecorder(KNOWN_SPAN_KINDS)
    r.instant("batch.ingest", t0=15.0, duration_s=5.0)    # [10, 15]
    r.waited("source.queue", 14.0, 19.0)
    spans = r.snapshot()
    wait = [s for s in spans if s.kind == "source.queue"][0]
    assert wait.instant and wait.waited and wait.cpu_s == 0.0
    iv = np.array([[12.0, 13.0]])
    dev = DeviceTrace(window=(10.0, 20.0), intervals=iv, names=["k"],
                      busy_s=union_s(iv))
    idle = idle_by_host_span(dev, spans)
    # gaps [10, 12] and [13, 20]: the first in batch.ingest, the second's
    # middle (16.5) inside the wait only, so under no span
    assert idle == {"batch.ingest": 2.0,
                    "no span (task loop, source wait)": 7.0}
    assert reader("queue_wait_p95_ms").read(make_run(spans)) == \
        pytest.approx(5000.0)
    # the fire-span reader skips it too
    r.waited("fire.pending", 11.0, 18.0)
    r.instant("fire.harvest", t0=19.0, duration_s=1.0)
    assert reader("fire_s_per_mev").read(make_run(r.snapshot())) == \
        pytest.approx(1.0 / 2.0)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_nothing_where_the_program_records_nothing(name):
    """Where the program lacks the span (an older program), the reader
    returns None and raises nothing."""
    old = [SimpleNamespace(kind=k, instant=False, t0=11.0, t1=12.0)
           for k in ("batch.ingest", "op.process", "fire.dispatch")]
    totals = {"batch.ingest": {"count": 1, "total_s": 1.0}}
    assert reader(name).read(make_run(old, totals)) is None


def test_the_new_metrics_are_declared_with_their_cells():
    with open(spec.ROOT + "/BENCHMARK.json") as f:
        bench = json.load(f)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and set(m["workloads"]) <= cells
        assert callable(reader(name).read)
    assert per_layer["queue_wait_p95_ms"]["moves"] == "result_p95_ms"
    assert per_layer["source_wait_pct"]["layer"] == "executor loop"
