"""The port's single-device window engine (``SliceSharedWindower`` over
``SlotTable``) against the reference's, on the CPU: the same seeded
streams of records and watermarks through both, every fired batch equal —
the same windows in the same order, the same rows in the same order, and
float results bit for bit. The streams are the kinds ``tests/test_windower.py``
drives: tumbling, sliding (slices shared between windows) and late
records, plus top-k projection at fire, asynchronous fires and a device
budget small enough that slices spill to the host and reload.

Tolerance: none — values are compared on their raw bits.
"""

import numpy as np
import pytest

from flink_tpu.core.records import KEY_ID_FIELD, RecordBatch as JBatch
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing import assigners as jasg
from flink_tpu.windowing.fire_projectors import TopKFireProjector as JTopK
from flink_tpu.windowing.windower import SliceSharedWindower as JWindower
from flink_tpu_torch.core.records import RecordBatch as TBatch
from flink_tpu_torch.runtime.pending import PendingFire
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing import assigners as tasg
from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector as TTopK
from flink_tpu_torch.windowing.windower import SliceSharedWindower as TWindower

AGGS = {
    "count": (jagg.CountAggregate, tagg.CountAggregate),
    "sum": (lambda: jagg.SumAggregate("v"), lambda: tagg.SumAggregate("v")),
    "avg": (lambda: jagg.AvgAggregate("v"), lambda: tagg.AvgAggregate("v")),
    "max": (lambda: jagg.MaxAggregate("v"), lambda: tagg.MaxAggregate("v")),
}


def _assigners(kind):
    if kind == "tumbling":
        return (jasg.TumblingEventTimeWindows.of(1000),
                tasg.TumblingEventTimeWindows.of(1000))
    size, slide = {"sliding": (5000, 1000), "sliding_k30": (30_000, 1000)}[
        kind]
    return (jasg.SlidingEventTimeWindows.of(size, slide),
            tasg.SlidingEventTimeWindows.of(size, slide))


def _stream(seed, steps=12, n=600, keys=80, disorder=1500):
    """[(keys, values, timestamps, watermark)]: time advancing 1 s a step
    with ``disorder`` ms of disorder (records behind the watermark are
    late), float32 values of wide range."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        k = rng.integers(0, keys, n).astype(np.int64)
        v = (rng.standard_normal(n)
             * np.exp(rng.uniform(-6, 6, n))).astype(np.float32)
        ts = rng.integers(step * 1000 - disorder, step * 1000 + 1000,
                          n).astype(np.int64)
        out.append((k, v, np.maximum(ts, 0), step * 1000 - 1))
    out.append((None, None, None, 10 ** 9))
    return out


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.kind == "f":
        return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])
    return a


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g.columns) == sorted(w.columns)
        for name in w.columns:
            gc, wc = np.asarray(g[name]), np.asarray(w[name])
            assert gc.dtype == wc.dtype, name
            np.testing.assert_array_equal(_bits(gc), _bits(wc), err_msg=name)


def _drive(jw, tw, stream, async_fires=False):
    """Feed both windowers; returns (port batches, reference batches, the
    most slices the port held in its spill tier after a batch)."""
    got, want, spilled = [], [], 0
    for keys, vals, ts, wm in stream:
        if keys is not None:
            cols = {KEY_ID_FIELD: keys, "v": vals}
            jw.process_batch(JBatch.from_pydict(dict(cols), timestamps=ts))
            tw.process_batch(TBatch.from_pydict(dict(cols), timestamps=ts))
            spilled = max(spilled, len(tw.table.spill))
        want.extend(jw.on_watermark(wm))
        for b in tw.on_watermark(wm, async_ok=async_fires):
            if isinstance(b, PendingFire):
                b = b.harvest()
            if b is not None:
                got.append(b)
    return got, want, spilled


def _pair(agg, window, projector=None, lateness=0, spill=None):
    jmake, tmake = AGGS[agg]
    ja, ta = _assigners(window)
    jp = tp = None
    if projector is not None:
        jp, tp = JTopK(*projector), TTopK(*projector)
    jw = JWindower(ja, jmake(), capacity=1024, allowed_lateness=lateness,
                   spill=dict(spill or {}), fire_projector=jp)
    tw = TWindower(ta, tmake(), capacity=1024, allowed_lateness=lateness,
                   spill={**(spill or {}), "device": "cpu"},
                   fire_projector=tp)
    return jw, tw


@pytest.mark.parametrize("window", ["tumbling", "sliding", "sliding_k30"])
@pytest.mark.parametrize("agg", sorted(AGGS))
def test_fires_equal_reference(agg, window):
    jw, tw = _pair(agg, window)
    got, want, _ = _drive(jw, tw, _stream(len(agg) + len(window)))
    assert want
    _same_batches(got, want)
    assert tw.late_records_dropped == jw.late_records_dropped


@pytest.mark.parametrize("lateness", [0, 700, 3000])
def test_late_records_equal_reference(lateness):
    """Records behind the watermark: dropped, or folded into windows
    still within allowed lateness, as the reference does."""
    jw, tw = _pair("sum", "sliding", lateness=lateness)
    got, want, _ = _drive(jw, tw, _stream(7, disorder=9000))
    _same_batches(got, want)
    assert tw.late_records_dropped == jw.late_records_dropped > 0


@pytest.mark.parametrize("async_fires", [False, True])
@pytest.mark.parametrize("desc", [True, False])
def test_top_k_projected_fires_equal_reference(desc, async_fires):
    """Count windows with many tied counts (few keys hit often): the top 4
    rows of each window, ties broken by row as ``lax.top_k`` does."""
    jw, tw = _pair("count", "sliding", projector=("count", 4, desc))
    got, want, _ = _drive(jw, tw, _stream(11, keys=30), async_fires=async_fires)
    assert want and all(len(b) <= 4 for b in want)
    _same_batches(got, want)


@pytest.mark.parametrize("agg", ["sum", "count"])
def test_fires_under_forced_eviction_equal_reference(agg):
    """A 1024-slot device budget under ~2,000 live (key, slice) rows:
    slices spill, reload on writes, and fire through the hybrid path."""
    spill = {"max_device_slots": 1024}
    for projector in (None, ("sum_v" if agg == "sum" else "count", 8,
                             True)):
        jw, tw = _pair(agg, "sliding", projector=projector, spill=spill)
        got, want, spilled = _drive(jw, tw, _stream(3, n=1200, keys=300))
        assert spilled > 0
        _same_batches(got, want)
        assert tw.spill_counters() == jw.table.spill_counters()
        assert sorted(tw.table.namespaces) == sorted(jw.table.namespaces)


def test_async_fires_equal_sync_fires():
    jw, tw = _pair("avg", "sliding")
    got, want, _ = _drive(jw, tw, _stream(5), async_fires=True)
    _same_batches(got, want)


@pytest.mark.parametrize("spread", [5, 40, 1 << 17])
def test_slice_plan_equals_reference(spread):
    """The O(n) slice plan: contiguous slices, slices with gaps, and a
    spread wide enough to take the np.unique path."""
    rng = np.random.default_rng(spread)
    ts = rng.integers(0, spread * 1000, 5000)
    ja, ta = _assigners("sliding")
    se = ja.assign_slice_ends(ts)
    if spread == 40:
        se = se[(se // 1000) % 3 != 0]
    for g, w in zip(ta.slice_plan(se), ja.slice_plan(se)):
        np.testing.assert_array_equal(g, w)


def test_group_matrix_equals_reference():
    """The fire's key grouping: keys in first-seen order, one row each,
    slot 0 where a key has no row in a slice."""
    from flink_tpu.native import group_matrix as jgroup
    from flink_tpu_torch.native import group_matrix as tgroup

    rng = np.random.default_rng(4)
    # distinct (key, slice) pairs in a random order
    pair = rng.permutation(np.unique(rng.integers(0, 3000 * 5, 20_000)))
    keys, sidx = pair // 5, (pair % 5).astype(np.int32)
    slots = np.arange(1, len(keys) + 1, dtype=np.int32)
    for g, w in zip(tgroup(keys, slots, sidx, 5), jgroup(keys, slots, sidx,
                                                          5)):
        np.testing.assert_array_equal(g, w)
