"""Point queries of every engine of the port against the reference's on
the CPU, single-device engines (the sharded ones are
``tests/test_torch_queries_mesh.py``'s): ``SlotTable.query`` /
``query_batch_pairs`` / ``query_windows``, ``compose_windows`` and the
batched ``compose_windows_pairs``, ``SliceSharedWindower.query_windows(_batch)``
(slot layout, with and without a device budget),
``PaneTable.query_windows`` and ``SessionWindower.query_sessions(_batch)``
(paged sessions read without a reload).

The same seeded NumPy streams go through both packages; at several cuts
the same keys (live ones, and keys never seen) are queried in both.
Tolerance: none. Answers are compared with ``==`` on their structure and
every float on its raw bits, NaN payloads included, and every value's
Python type must match (the answers cross pickle and JSON as plain
scalars). A query batch must leave each engine's state, residency, spill
tiers, page maps and sticky buckets exactly as they were.
"""

import math
import struct

import numpy as np
import pytest
import torch

from flink_tpu.core.records import KEY_ID_FIELD, RecordBatch as JBatch
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing import assigners as jasg
from flink_tpu.windowing.sessions import SessionWindower as JSessions
from flink_tpu.windowing.windower import PaneWindower as JPane
from flink_tpu.windowing.windower import SliceSharedWindower as JWindower
from flink_tpu.windowing.windower import compose_windows as j_compose
from flink_tpu_torch.core.records import RecordBatch as TBatch
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing import assigners as tasg
from flink_tpu_torch.windowing.sessions import SessionWindower as TSessions
from flink_tpu_torch.windowing.windower import PaneWindower as TPane
from flink_tpu_torch.windowing.windower import SliceSharedWindower as TWindower
from flink_tpu_torch.windowing.windower import compose_windows as t_compose

P = 8

#: NaN payloads (signalling, quiet, negative), +-1, +-0 and +-inf
SPECIAL_F32 = np.array([0x7fa00001, 0x7fc00002, 0xffc00003, 0xffa00004,
                        0x3f800000, 0xbf800000, 0, 0x80000000,
                        0x7f800000, 0xff800000], np.uint32).view(np.float32)


def same_answers(got, want, path="answer"):
    """``got == want`` as a structure, every float compared on its raw
    bits (NaN-aware), every scalar of the same Python type."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want) or sorted(got) == sorted(want), (
            path, sorted(got), sorted(want))
        for k in want:
            same_answers(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            same_answers(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert struct.pack("<d", got) == struct.pack("<d", want), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


def _has_nan(answer) -> bool:
    if isinstance(answer, dict):
        return any(_has_nan(v) for v in answer.values())
    if isinstance(answer, (list, tuple)):
        return any(_has_nan(v) for v in answer)
    return isinstance(answer, float) and math.isnan(answer)


def _batches(keys, vals, ts):
    cols = {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
            "v": np.asarray(vals, dtype=np.float32)}
    return (JBatch.from_pydict(dict(cols), timestamps=ts),
            TBatch.from_pydict(dict(cols), timestamps=ts))


def _stream(seed, steps=8, n=1500, keys=300, span=2500, specials=True):
    """[(keys, values, timestamps, watermark)]: time advancing 1 s a step,
    float32 values with 2 % specials (NaN payloads, +-inf, signed zeros)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        k = rng.integers(0, keys, n).astype(np.int64)
        v = rng.standard_normal(n).astype(np.float32)
        if specials:
            sp = rng.random(n) < 0.02
            v[sp] = rng.choice(SPECIAL_F32, int(sp.sum()))
        ts = rng.integers(s * 1000, s * 1000 + span, n).astype(np.int64)
        out.append((k, v, ts, s * 1000 - 1))
    return out


def _query_keys(seed, keys=300, n=96):
    """Live keys, keys never seen and a repeated key."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, keys + 40, n).astype(np.int64)
    q[-1] = q[0]
    return q


AGGS = {
    "count": (jagg.CountAggregate, tagg.CountAggregate),
    "sum": (lambda: jagg.SumAggregate("v"), lambda: tagg.SumAggregate("v")),
    "avg": (lambda: jagg.AvgAggregate("v"), lambda: tagg.AvgAggregate("v")),
    "max": (lambda: jagg.MaxAggregate("v"), lambda: tagg.MaxAggregate("v")),
    "multi": (lambda: jagg.MultiAggregate([jagg.CountAggregate(),
                                           jagg.SumAggregate("v")]),
              lambda: tagg.MultiAggregate([tagg.CountAggregate(),
                                           tagg.SumAggregate("v")])),
}


def _assigners(kind):
    if kind == "tumbling":
        return (jasg.TumblingEventTimeWindows.of(1000),
                tasg.TumblingEventTimeWindows.of(1000))
    return (jasg.SlidingEventTimeWindows.of(5000, 1000),
            tasg.SlidingEventTimeWindows.of(5000, 1000))


# ------------------------------------------------------------ read-only

def _tensor_bits(t):
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.clone()


def _spill_sig(sp):
    return (len(sp), sorted(int(n) for n in sp.namespaces),
            sorted(int(n) for n in sp.dirty_namespaces()))


def _pmap_sig(pm):
    if pm is None:
        return None
    return (pm.counters(), sorted(pm.live_ns().tolist()),
            np.asarray(pm.sp_ns).copy().tolist())


def state_signature(engine):
    """Everything a query must not change: the device planes (bits), the
    indexes' occupancy, the spill tiers and page maps, the touch clocks and
    every sticky bucket."""
    sig = {}
    tables = []
    if hasattr(engine, "table"):
        tables.append(engine.table)
    for i, t in enumerate(tables):
        sig[f"t{i}.accs"] = [_tensor_bits(a) for a in t.accs]
        sig[f"t{i}.used"] = t.index.num_used
        for b in ("_gather_bucket", "_reset_bucket", "_fire_bucket",
                  "_scatter_bucket", "_touch_clock"):
            if hasattr(t, b):
                sig[f"t{i}.{b}"] = getattr(t, b)
        if hasattr(t, "_pmap"):
            sig[f"t{i}.spill"] = _spill_sig(t.spill)
            sig[f"t{i}.counters"] = t.spill_counters()
            sig[f"t{i}.ns_touch"] = dict(t._ns_touch)
            sig[f"t{i}.pmap"] = _pmap_sig(t._pmap)
            if getattr(t, "_paged", False):
                sig[f"t{i}.slot_touch"] = t._slot_touch.copy()
        if hasattr(t, "slice_row"):
            sig[f"t{i}.spill"] = sorted(t.spill)
            sig[f"t{i}.slice_row"] = dict(t.slice_row)
            sig[f"t{i}.window_row"] = dict(t.window_row)
            sig[f"t{i}.capacity"] = t.capacity
    if hasattr(engine, "indexes"):
        sig["accs"] = [_tensor_bits(a) for a in engine.accs]
        sig["used"] = [idx.num_used for idx in engine.indexes]
        sig["ns"] = [sorted(int(n) for n in idx.namespaces)
                     for idx in engine.indexes]
        sig["spills"] = [_spill_sig(sp) for sp in engine.spills]
        sig["counters"] = engine.spill_counters()
        for b in ("_gather_bucket", "_reset_bucket", "_fire_bucket",
                  "_scatter_bucket"):
            if hasattr(engine, b):
                sig[b] = getattr(engine, b)
        if hasattr(engine, "_ns_touch"):
            sig["ns_touch"] = [dict(t) for t in engine._ns_touch]
        if getattr(engine, "_pmaps", None):
            sig["pmaps"] = [_pmap_sig(pm) for pm in engine._pmaps]
    return sig


def assert_same_signature(before, after):
    assert sorted(before) == sorted(after)
    for k in before:
        a, b = before[k], after[k]
        if isinstance(a, list) and a and isinstance(a[0], torch.Tensor):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), k
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


def _read_only(engine, query):
    """Run ``query`` and assert the engine is as it was."""
    before = state_signature(engine)
    out = query()
    assert_same_signature(before, state_signature(engine))
    return out


# --------------------------------------------------------- compose_windows

@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
@pytest.mark.parametrize("agg", sorted(AGGS))
def test_compose_windows_equals_reference(agg, kind):
    """Random per-slice raw leaves (float specials included) composed into
    windows by both packages' ``compose_windows``."""
    ja, ta = _assigners(kind)
    jg, tg = AGGS[agg][0](), AGGS[agg][1]()
    rng = np.random.default_rng(len(agg) * 7 + len(kind))
    for trial in range(20):
        ends = sorted(rng.choice(np.arange(1000, 20_000, 1000),
                                 rng.integers(1, 8), replace=False))
        sv = {}
        for se in ends:
            leaves = []
            for l in jg.leaves:
                if np.dtype(l.dtype).kind == "f":
                    x = rng.choice(np.concatenate(
                        [SPECIAL_F32, rng.standard_normal(20).astype(
                            np.float32)]), 1).astype(l.dtype)
                else:
                    x = rng.integers(0, 50, 1).astype(l.dtype)
                leaves.append(x)
            sv[int(se)] = tuple(leaves)
        same_answers(t_compose(ta, tg, sv), j_compose(ja, jg, sv))


@pytest.mark.parametrize("agg", ["sum", "max", "avg", "multi"])
def test_compose_windows_pairs_equals_reference_key_by_key(agg):
    """The batched composition (every (row, window) folded at once) against
    the reference's key-by-key ``compose_windows`` over 600 rows whose
    slices are a third NaN payloads and infinities: NumPy's vector loops
    pick the other NaN of a NaN pair, so the port folds with the
    one-element call's rule."""
    from flink_tpu_torch.windowing.windower import compose_windows_pairs

    ja, ta = _assigners("sliding")
    jg, tg = AGGS[agg][0](), AGGS[agg][1]()
    rng = np.random.default_rng(len(agg))
    rows, ns, leaves = [], [], [[] for _ in tg.leaves]
    per_row = []
    for r in range(600):
        ends = sorted(rng.choice(np.arange(1000, 12_000, 1000),
                                 rng.integers(1, 6), replace=False))
        sv = {}
        for se in ends:
            vals = []
            for i, l in enumerate(jg.leaves):
                if np.dtype(l.dtype).kind == "f":
                    pool = np.concatenate([SPECIAL_F32, SPECIAL_F32,
                                           rng.standard_normal(10)
                                           .astype(np.float32)])
                    x = rng.choice(pool, 1).astype(l.dtype)
                else:
                    x = rng.integers(0, 50, 1).astype(l.dtype)
                vals.append(x)
                leaves[i].append(x)
            rows.append(r)
            ns.append(int(se))
            sv[int(se)] = tuple(vals)
        per_row.append(sv)
    got = compose_windows_pairs(ta, tg, np.asarray(rows), np.asarray(ns),
                                [np.concatenate(c) for c in leaves], 600)
    same_answers(got, [j_compose(ja, jg, sv) for sv in per_row])
    assert any(_has_nan(a) for a in got)


# ------------------------------------------- slot layout (SliceSharedWindower)

def _slot_pair(agg, kind, spill=None):
    ja, ta = _assigners(kind)
    jw = JWindower(ja, AGGS[agg][0](), capacity=1024,
                   spill=dict(spill or {}))
    tw = TWindower(ta, AGGS[agg][1](), capacity=1024,
                   spill={**(spill or {}), "device": "cpu"})
    return jw, tw


def _spilled(engine) -> int:
    if hasattr(engine, "table"):
        t = engine.table
        return len(t.spill) + (t.spill_counters()["rows_evicted"]
                               if getattr(t, "_paged", False) else 0)
    return sum(len(sp) for sp in engine.spills)


def _drive_and_query(jw, tw, stream, qkeys, query, fire=True):
    """Feed both engines; after each batch (before its watermark) and
    after each fire, ``query(engine, keys)`` in both must agree. Returns
    (answered keys, the most the port held spilled at a query)."""
    answered = spilled = 0
    for keys, vals, ts, wm in stream:
        jb, tb = _batches(keys, vals, ts)
        jw.process_batch(jb)
        tw.process_batch(tb)
        spilled = max(spilled, _spilled(tw))
        same_answers(_read_only(tw, lambda: query(tw, qkeys)),
                     query(jw, qkeys))
        if fire:
            jw.on_watermark(wm)
            for b in tw.on_watermark(wm):
                pass
            got = _read_only(tw, lambda: query(tw, qkeys))
            want = query(jw, qkeys)
            same_answers(got, want)
            answered += sum(1 for a in want if a)
    return answered, spilled


@pytest.mark.parametrize("budget", [0, 2048])
@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
@pytest.mark.parametrize("agg", ["count", "sum", "avg", "multi"])
def test_slot_layout_batch_query_equals_reference(agg, kind, budget):
    spill = {"max_device_slots": budget} if budget else None
    jw, tw = _slot_pair(agg, kind, spill)
    stream = _stream(len(agg) + len(kind) + budget % 7, keys=1500, n=3000)
    answered, spilled = _drive_and_query(
        jw, tw, stream, _query_keys(3, keys=1500),
        lambda w, k: w.query_windows_batch(k))
    assert answered > 0
    assert bool(spilled) == bool(budget)


def test_slot_layout_single_key_queries_equal_reference():
    """``query_windows`` per key, and the table's ``query`` (every live
    namespace, then one namespace; spilled namespaces answered too)."""
    jw, tw = _slot_pair("sum", "sliding", {"max_device_slots": 2048})
    stream = _stream(4, keys=1500, n=3000)
    for keys, vals, ts, wm in stream[:6]:
        jb, tb = _batches(keys, vals, ts)
        jw.process_batch(jb)
        tw.process_batch(tb)
    assert len(tw.table.spill) > 0
    nss = tw.table.namespaces
    assert sorted(nss) == sorted(jw.table.namespaces)
    for k in _query_keys(5, keys=1500, n=24).tolist():
        same_answers(_read_only(tw, lambda: tw.query_windows(k)),
                     jw.query_windows(k))
        same_answers(_read_only(tw, lambda: tw.table.query(k)),
                     jw.table.query(k))
        for ns in (nss[0], nss[-1], 10 ** 7):
            same_answers(tw.table.query(k, ns), jw.table.query(k, ns))


def test_query_batch_pairs_equal_reference():
    """The raw primitive: per-pair hit mask and leaves, identity where the
    pair is missing; spilled pairs from the host tier."""
    jw, tw = _slot_pair("multi", "sliding", {"max_device_slots": 2048})
    for keys, vals, ts, wm in _stream(6, keys=1500, n=3000)[:5]:
        jb, tb = _batches(keys, vals, ts)
        jw.process_batch(jb)
        tw.process_batch(tb)
    assert len(tw.table.spill) > 0
    rng = np.random.default_rng(9)
    live = np.asarray(tw.table.namespaces, dtype=np.int64)
    pk = rng.integers(0, 1600, 4000).astype(np.int64)
    pn = np.concatenate([rng.choice(live, 3990), [77, 78, 79, 80, 81, 82,
                                                  83, 84, 85, 86]])
    tf, tl = _read_only(tw, lambda: tw.table.query_batch_pairs(pk, pn))
    jf, jl = jw.table.query_batch_pairs(pk, pn)
    np.testing.assert_array_equal(tf, jf)
    assert tf.any() and not tf.all()
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_slot_layout_query_of_empty_table():
    jw, tw = _slot_pair("sum", "tumbling")
    same_answers(tw.query_windows_batch([1, 2]), jw.query_windows_batch(
        [1, 2]))
    same_answers(tw.query_windows_batch([]), jw.query_windows_batch([]))
    same_answers(tw.table.query(3), jw.table.query(3))


# ------------------------------------------------------------ pane layout

@pytest.mark.parametrize("preagg", [True, False])
@pytest.mark.parametrize("agg", ["count", "sum", "max", "multi"])
def test_pane_layout_queries_equal_reference(agg, preagg):
    ja, ta = _assigners("sliding")
    jw = JPane(ja, AGGS[agg][0](), capacity=1024, preagg=preagg)
    tw = TPane(ta, AGGS[agg][1](), capacity=1024, preagg=preagg,
               device="cpu")
    answered, _ = _drive_and_query(
        jw, tw, _stream(len(agg), keys=400, n=1200, steps=6),
        _query_keys(8, 400, n=32), lambda w, k: w.query_windows_batch(k))
    assert answered > 0
    for k in _query_keys(12, 400, n=10).tolist():
        same_answers(tw.query_windows(k), jw.query_windows(k))


# --------------------------------------------------------- P=1 sessions

def _session_stream(seed, steps=10, n=1500, keys=4000, gap=400):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        k = rng.integers(0, keys, n).astype(np.int64)
        v = rng.standard_normal(n).astype(np.float32)
        sp = rng.random(n) < 0.02
        v[sp] = rng.choice(SPECIAL_F32, int(sp.sum()))
        ts = rng.integers(s * 300, s * 300 + 600, n).astype(np.int64)
        out.append((k, v, ts, s * 300 - gap))
    return out


@pytest.mark.parametrize("budget", [0, 2048])
@pytest.mark.parametrize("agg", ["sum", "count"])
def test_session_queries_equal_reference(agg, budget):
    """Row 5's shape cut down: the paged tier evicts under a budget, and a
    query reads paged-out sessions from their pages without a reload."""
    spill = {"max_device_slots": budget} if budget else None
    jw = JSessions(400, AGGS[agg][0](), capacity=1 << 12,
                   spill=dict(spill or {}))
    tw = TSessions(400, AGGS[agg][1](), capacity=1 << 12,
                   spill={**(spill or {}), "device": "cpu"})
    answered, spilled = _drive_and_query(
        jw, tw, _session_stream(len(agg) + budget), _query_keys(2, 4000, 256),
        lambda w, k: w.query_sessions_batch(k))
    assert answered > 0
    assert bool(spilled) == bool(budget)
    for k in _query_keys(4, 4000, n=12).tolist():
        same_answers(tw.query_sessions(k), jw.query_sessions(k))


def test_answers_carry_nan_payloads():
    """A float32 Sum with NaN payloads in the data answers NaN with the
    reference's bits (the comparison above is bit for bit; this pins that
    it was exercised)."""
    jw, tw = _slot_pair("sum", "sliding")
    keys = np.arange(20, dtype=np.int64)
    vals = np.ones(20, dtype=np.float32)
    vals[3] = SPECIAL_F32[0]
    vals[4] = SPECIAL_F32[2]
    ts = np.full(20, 500, dtype=np.int64)
    jb, tb = _batches(keys, vals, ts)
    jw.process_batch(jb)
    tw.process_batch(tb)
    got, want = tw.query_windows_batch(keys), jw.query_windows_batch(keys)
    same_answers(got, want)
    assert _has_nan(got[3]) and _has_nan(got[4])
