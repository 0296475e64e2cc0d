"""The port's paged spill layout (``flink_tpu_torch/state/paged_spill.py``
and ``SlotTable(spill_layout="pages")``) against the reference's
(``flink_tpu/state/paged_spill.py``): the counterparts of
``tests/test_paged_spill.py``'s tests that take no snapshot (the snapshot
and restore tests are in ``tests/test_torch_restore.py``).

Each test drives the same operations, made from numpy seeds, through both
tables on the CPU and compares what they hold: every live (key, sid) row,
resident or paged, with its value's bits, the page map, and the spill
counters. Tolerance: none.
"""

import numpy as np
import pytest

from flink_tpu.state.slot_table import SlotTable as JSlotTable
from flink_tpu.windowing.aggregates import SumAggregate as JSum
from flink_tpu_torch.state import paged_spill
from flink_tpu_torch.state.slot_table import SlotTable, SlotTableFullError
from flink_tpu_torch.windowing.aggregates import SumAggregate


def mk(capacity=2048):
    return SlotTable(SumAggregate("v"), capacity=capacity,
                     max_device_slots=capacity, spill_layout="pages",
                     track_namespaces=False, device="cpu")


def jmk(capacity=2048):
    return JSlotTable(JSum("v"), capacity=capacity,
                      max_device_slots=capacity, spill_layout="pages",
                      track_namespaces=False)


def put(t, keys, sids, vals, chunk=1024):
    """Feed in sub-budget chunks (one batch's working set must fit)."""
    keys = np.asarray(keys, dtype=np.int64)
    sids = np.asarray(sids, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    slots = None
    for a in range(0, len(keys), chunk):
        slots = t.lookup_or_insert(keys[a:a + chunk], sids[a:a + chunk])
        t.scatter(slots, (vals[a:a + chunk],))
    return slots


def both(fn):
    """Run ``fn(table)`` on a port table and a reference table."""
    t, j = mk(), jmk()
    return fn(t), fn(j), t, j


def rows(t):
    """{(key, sid): value bits} of every live row, resident or paged."""
    out = {}
    used = t.index.used_slots()
    acc = np.asarray(t.accs[0]).view(np.uint32)
    for s in used.tolist():
        out[(int(t.index.slot_key[s]), int(t.index.slot_ns[s]))] = \
            int(acc[s])
    pmap = t._pmap
    for page in list(pmap.page_rows):
        entry = t.spill.peek(page)
        live = pmap.live_row_mask(page, entry["ns"])
        vals = np.asarray(entry["leaf_0"], np.float32).view(np.uint32)
        for k, ns, v in zip(np.asarray(entry["key_id"])[live].tolist(),
                            np.asarray(entry["ns"])[live].tolist(),
                            vals[live].tolist()):
            assert (int(k), int(ns)) not in out, "row live in two tiers"
            out[(int(k), int(ns))] = int(v)
    return out


def assert_same_state(t, j):
    assert t.spill_counters() == j.spill_counters()
    assert rows(t) == rows(j)
    tp, jp = t._pmap, j._pmap
    tp.sort()
    jp.sort()
    for name in ("sp_ns", "sp_page", "sp_row", "sp_dead"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    assert tp.page_rows == jp.page_rows and tp.page_live == jp.page_live


def test_eviction_and_transparent_reload():
    n = 8192
    keys = np.arange(1, n + 1, dtype=np.int64)

    def run(t):
        for a in range(0, n, 1024):
            put(t, keys[a:a + 1024], keys[a:a + 1024], np.full(1024, 2.0))
        assert len(t.spill) > 0
        # touching early (paged) rows reloads them with their values
        slots = t.lookup_or_insert(keys[:64], keys[:64])
        t.scatter(slots, (np.ones(64, dtype=np.float32),))

    _, _, t, j = both(run)
    assert rows(t)[(1, 1)] == np.float32(3.0).view(np.uint32)
    assert_same_state(t, j)


def test_free_rows_drops_sessions_everywhere():
    n = 6000
    keys = np.arange(1, n + 1, dtype=np.int64)
    sids = keys + 10

    def run(t):
        put(t, keys, sids, np.full(n, 1.0))
        slots = t.lookup_or_insert(keys[-100:], sids[-100:])
        t.free_rows(slots, sids[-100:])
        spilled = t._pmap.spilled_mask(sids[:100])
        assert spilled.any()
        t._drop_spilled_sessions(sids[:100][spilled])
        return sids[:100][spilled]

    dead, _, t, j = both(run)
    got = {ns for _, ns in rows(t)}
    assert not (set(dead.tolist()) & got)
    assert not (set(sids[-100:].tolist()) & got)
    assert_same_state(t, j)


def test_reload_leaves_remainder_unrewritten():
    """Lazy tombstones: reloading one row takes exactly it out of its
    page; the siblings are not rewritten and stay readable."""
    n = 6000
    keys = np.arange(1, n + 1, dtype=np.int64)

    def run(t):
        put(t, keys, keys, np.full(n, 4.0))
        pages_before = len(t.spill)
        t.lookup_or_insert(keys[:1], keys[:1])
        return pages_before

    pages_before, _, t, j = both(run)
    c = t.spill_counters()
    assert c["rows_reloaded"] == 1
    assert c["rows_split_on_reload"] == 0
    assert c["rows_compacted"] == 0
    assert len(t.spill) == pages_before
    assert rows(t)[(2, 2)] == np.float32(4.0).view(np.uint32)
    assert_same_state(t, j)


def test_compaction_only_after_dead_fraction_threshold():
    n = 6000
    keys = np.arange(1, n + 1, dtype=np.int64)

    def run(t):
        put(t, keys, keys, np.full(n, 1.0))
        pmap = t._pmap
        page = max(pmap.page_rows, key=pmap.page_rows.get)
        page_sids = np.sort(pmap.sp_ns[pmap.sp_page == page])
        size = len(page_sids)
        under = page_sids[: size // 2]
        for a in range(0, len(under), 32):
            t.lookup_or_insert(under[a:a + 32], under[a:a + 32])
        assert t.spill_counters()["rows_compacted"] == 0
        assert int(pmap.page_rows[page]) == size
        over = page_sids[size // 2: size // 2 + 32]
        t.lookup_or_insert(over, over)
        assert page not in pmap.page_rows
        return size - len(under) - len(over)

    live, _, t, j = both(run)
    assert t.spill_counters()["rows_compacted"] == live
    assert_same_state(t, j)


def test_budget_exhaustion_raises():
    keys = np.arange(1, 1200, dtype=np.int64)
    for t in (mk(capacity=1024), jmk(capacity=1024)):
        with pytest.raises(Exception) as e:
            put(t, keys, keys, np.ones(len(keys)))
        assert type(e.value).__name__ == SlotTableFullError.__name__


def test_hinted_lookup_equals_probe():
    """``lookup_or_insert(hints=)``: verified folds skip the probe, stale
    and absent ones fall back to it — the slots and the table equal the
    reference's hinted lookup on the same hints."""
    rng = np.random.default_rng(4)
    keys = np.arange(1, 3001, dtype=np.int64)

    def run(t):
        slots = put(t, keys, keys, np.ones(3000), chunk=1000)
        hints = np.full(1000, -1, dtype=np.int32)
        hints[:len(slots)] = slots
        hints[rng.random(1000) < 0.3] = 5   # stale folds
        return t.lookup_or_insert(keys[-1000:], keys[-1000:], hints=hints)

    rng = np.random.default_rng(4)
    got = run(t := mk())
    rng = np.random.default_rng(4)
    want = run(j := jmk())
    np.testing.assert_array_equal(got, want)
    assert_same_state(t, j)


def test_deferred_sweeps_and_cold_reads_match_reference():
    """``defer_sweeps``: reloads queue their pages and
    ``run_deferred_sweeps`` reaps and compacts them later; and
    ``read_spilled_rows`` reads paged rows without moving them."""
    from flink_tpu.state import paged_spill as jpaged

    n = 6000
    keys = np.arange(1, n + 1, dtype=np.int64)
    tables = (mk(), jmk())
    for t, mod in zip(tables, (paged_spill, jpaged)):
        put(t, keys, keys, np.full(n, 1.0))
        t._pmap.defer_sweeps = True
        for a in range(0, 1500, 250):
            t.lookup_or_insert(keys[a:a + 250], keys[a:a + 250])
        assert t._pmap.deferred_pages
        t.swept = mod.run_deferred_sweeps(t.spill, t._pmap)
        got = {}
        mod.read_spilled_rows(
            t.spill, t._pmap, True,
            [(int(k), int(k), int(k)) for k in keys[1500:2500]],
            lambda tag, entry, r: got.__setitem__(
                tag, float(entry["leaf_0"][r])))
        t.cold = got
    t, j = tables
    assert t.swept == j.swept > 0
    assert t.cold == j.cold and len(t.cold) > 0
    assert_same_state(t, j)


def _sessions_run(spill, ref=False):
    """tests/test_paged_spill.py's session run: 12 batches of 4,096
    records over 200k keys, a float64 Sum, fired as the watermark moves."""
    from flink_tpu.core.records import RecordBatch as JRecordBatch
    from flink_tpu.windowing.sessions import SessionWindower as JSW
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )
    from flink_tpu_torch.windowing.sessions import SessionWindower

    if ref:
        w = JSW(2000, JSum("value", np.float64), capacity=1 << 12,
                spill=spill)
        make = JRecordBatch
    else:
        w = SessionWindower(2000, SumAggregate("value", np.float64),
                            capacity=1 << 12,
                            spill={**(spill or {}), "device": "cpu"})
        make = RecordBatch
    rng = np.random.default_rng(5)
    out = []
    wm = 0
    for _ in range(12):
        B = 4096
        ts = np.sort(rng.integers(wm + 1, wm + 40_000, size=B))
        keys = rng.integers(0, 200_000, size=B)
        w.process_batch(make({KEY_ID_FIELD: keys.astype(np.int64),
                              "value": np.ones(B),
                              TIMESTAMP_FIELD: ts.astype(np.int64)}))
        wm += 40_000
        out.extend(w.on_watermark(wm))
    out.extend(w.on_watermark(1 << 60))
    rows = {}
    for o in out:
        for k, s, v in zip(o[KEY_ID_FIELD].tolist(),
                           o["window_start"].tolist(),
                           o["sum_value"].tolist()):
            rows[(int(k), int(s))] = rows.get((int(k), int(s)), 0) + v
    return rows, w.spill_counters()


def test_session_windower_paged_equals_unbounded():
    """Sessions through the paged tier == sessions with no budget, at a
    live set far beyond the device slots; the counters equal the
    reference's."""
    bounded, counters = _sessions_run({"max_device_slots": 1 << 12})
    unbounded, _ = _sessions_run(None)
    assert bounded == unbounded
    import jax

    with jax.enable_x64(True):
        ref, ref_counters = _sessions_run({"max_device_slots": 1 << 12},
                                          ref=True)
    assert bounded == ref
    assert counters == ref_counters and counters["rows_evicted"] > 0


def test_session_windower_namespaces_layout_equals_unbounded():
    """An explicit spill_layout='namespaces' keeps the registry and its
    eviction path."""
    bounded, _ = _sessions_run({"max_device_slots": 1 << 12,
                                "spill_layout": "namespaces"})
    assert bounded == _sessions_run(None)[0]
