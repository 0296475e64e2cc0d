"""The single-device state plane of the port against the JAX reference:

- every flat program of ``flink_tpu_torch/stateplane/families.py``
  against its builder in ``flink_tpu/stateplane/families.py`` (scatter
  const and valued, fire, projected fire, merge, gather, put, reset,
  fence), with the reserved slot 0 staying identity;
- ``TopKFireProjector.project`` against the reference's ``lax.top_k`` form
  on scores with more than k ties, NaNs of both signs, ±0.0 and invalid
  rows, integer and float, descending and ascending;
- ``SlotTable`` under forced eviction (a device budget far below the
  state), in the cases of ``tests/test_spill.py`` and
  ``tests/test_slot_table.py``: resident and spilled namespaces, fires
  (device, hybrid, async) and ``spill_counters()`` equal the reference's.

Inputs come from numpy seeds and are fed to both packages as NumPy.
Tolerance: none — values are compared on their raw bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flink_tpu.state.slot_table import SlotTable as JTable
from flink_tpu.stateplane import families as jfam
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing.fire_projectors import TopKFireProjector as JTopK
from flink_tpu_torch.state.slot_table import (
    SlotTable as TTable,
    SlotTableFullError,
)
from flink_tpu_torch.stateplane import families as tfam
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector as TTopK

CAP = 1024

AGGS = {
    "count": (jagg.CountAggregate, tagg.CountAggregate),
    "sum": (lambda: jagg.SumAggregate("v"), lambda: tagg.SumAggregate("v")),
    "avg": (lambda: jagg.AvgAggregate("v"), lambda: tagg.AvgAggregate("v")),
    "max": (lambda: jagg.MaxAggregate("v"), lambda: tagg.MaxAggregate("v")),
    "min": (lambda: jagg.MinAggregate("v"), lambda: tagg.MinAggregate("v")),
}


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.kind == "f":
        return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])
    return a


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _values(rng, kind, n):
    """float32 values of wide range with NaNs, ±inf and ±0.0: NaN payloads
    for sums, whose NaN bits the port keeps; the default NaN for max/min,
    whose NaN the port returns as the default one (the reference passes a
    NaN lane's payload through)."""
    v = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
         ).astype(np.float32)
    pick = rng.random(n)
    bits = v.view(np.int32)
    if kind in ("max", "min"):
        v[pick < 0.01] = np.nan
    else:
        bits[pick < 0.01] = 0x7FA00001 + rng.integers(0, 99, int(
            (pick < 0.01).sum()))
    v[(pick >= 0.01) & (pick < 0.03)] = np.inf
    v[(pick >= 0.03) & (pick < 0.05)] = -np.inf if kind != "max" else 0.0
    v[(pick >= 0.05) & (pick < 0.15)] = -0.0
    v[(pick >= 0.15) & (pick < 0.25)] = 0.0
    return v


def _accs(rng, agg, kind):
    """Accumulators already holding values (slot 0 at identity)."""
    out = []
    for leaf in agg.leaves:
        if leaf.dtype.kind == "i":
            a = rng.integers(0, 50, CAP).astype(leaf.dtype)
        else:
            a = _values(rng, kind, CAP).astype(leaf.dtype)
        a[0] = leaf.identity
        out.append(a)
    return out


def _slots(rng, n, pad):
    """int32 slots with hot slots, and ``pad`` padding lanes (slot 0) at
    the tail."""
    s = np.where(rng.random(n) < 0.3, rng.integers(1, 6, n),
                 rng.integers(1, CAP, n)).astype(np.int32)
    s[n - pad:] = 0
    return s


def _two_nan_rows(x):
    """Rows of ``x [w, k]`` whose left fold from 0 adds a NaN to a NaN."""
    acc = np.zeros(x.shape[0], x.dtype)
    two = np.zeros(x.shape[0], bool)
    with np.errstate(invalid="ignore"):
        for j in range(x.shape[1]):
            two |= np.isnan(acc) & np.isnan(x[:, j])
            acc = acc + x[:, j]
    return two


def _t(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(np.array(a)) for a in arrays)


@pytest.mark.parametrize("kind", sorted(AGGS))
def test_scatter_combine_matches_reference(kind):
    rng = np.random.default_rng({"count": 1, "sum": 2, "avg": 3, "max": 4,
                                 "min": 5}[kind])
    jmake, tmake = AGGS[kind]
    jag, tag = jmake(), tmake()
    accs = _accs(rng, jag, kind)
    n, pad = 4096, 300
    slots = _slots(rng, n, pad)
    vals = []
    for leaf in jag.input_leaves:
        v = _values(rng, kind, n).astype(leaf.dtype)
        v[n - pad:] = leaf.identity
        vals.append(v)
    want = jfam.flat_scatter_combine(jag.leaves)(_j(accs), jnp.asarray(slots),
                                                 _j(vals))
    got = tfam.flat_scatter_combine(tag.leaves)(_t(accs),
                                                torch.from_numpy(slots),
                                                _t(vals))
    for g, w, leaf in zip(got, want, tag.leaves):
        _eq(g.numpy(), w)
        _eq(g.numpy()[:1], np.asarray([leaf.identity], leaf.dtype))


@pytest.mark.parametrize("kind", sorted(AGGS))
def test_scatter_valued_matches_reference(kind):
    rng = np.random.default_rng(10 + len(kind))
    jmake, tmake = AGGS[kind]
    jag, tag = jmake(), tmake()
    accs = _accs(rng, jag, kind)
    n, pad = 2048, 100
    slots = _slots(rng, n, pad)
    vals = []
    for leaf in jag.leaves:
        v = (rng.integers(0, 9, n) if leaf.dtype.kind == "i"
             else _values(rng, kind, n)).astype(leaf.dtype)
        v[n - pad:] = leaf.identity
        vals.append(v)
    want = jfam.flat_scatter_valued(jag.leaves)(_j(accs), jnp.asarray(slots),
                                                _j(vals))
    got = tfam.flat_scatter_valued(tag.leaves)(_t(accs),
                                               torch.from_numpy(slots),
                                               _t(vals))
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


@pytest.mark.parametrize("k", [1, 5, 16, 33])
@pytest.mark.parametrize("kind", sorted(AGGS))
def test_segment_fire_and_merge_match_reference(kind, k):
    """Fire (merge + finish), merge alone, and the projected fire with a
    top-k over the result column, on rows of k slices (missing slices at
    slot 0, padded rows past w)."""
    rng = np.random.default_rng(20 + k)
    jmake, tmake = AGGS[kind]
    jag, tag = jmake(), tmake()
    accs = _accs(rng, jag, kind)
    wp, w = 512, 437
    sm = rng.integers(0, CAP, (wp, k)).astype(np.int32)
    sm[rng.random((wp, k)) < 0.2] = 0
    sm[w:] = 0
    # rows where one add of the sum meets two NaNs are emptied: which of
    # the two the reference keeps is its compiler's choice (ROADMAP Queue
    # C item 6)
    sm[_two_nan_rows(accs[0][sm])] = 0
    want = jfam.flat_segment_fire(jag)(_j(accs), jnp.asarray(sm))
    got = tfam.flat_segment_fire(tag)(_t(accs), torch.from_numpy(sm))
    assert sorted(got) == sorted(want)
    for name in want:
        _eq(got[name].numpy(), want[name])
    for g, wm in zip(tfam.flat_segment_merge(tag.leaves)(
            _t(accs), torch.from_numpy(sm)),
            jfam.flat_segment_merge(jag.leaves)(_j(accs), jnp.asarray(sm))):
        _eq(g.numpy(), wm)
    col = tag.output_names[0]
    for desc in (True, False):
        jp, tp = JTopK(col, k=16, descending=desc), TTopK(col, k=16,
                                                          descending=desc)
        widx, wcols, wvalid = jfam.flat_segment_fire_projected(jag, jp)(
            _j(accs), jnp.asarray(sm), w)
        gidx, gcols, gvalid = tfam.flat_segment_fire_projected(tag, tp)(
            _t(accs), torch.from_numpy(sm), w)
        _eq(gidx.numpy().astype(np.int32), np.asarray(widx, np.int32))
        _eq(gvalid.numpy(), wvalid)
        for name in wcols:
            _eq(gcols[name].numpy(), wcols[name])


@pytest.mark.parametrize("kind", sorted(AGGS))
def test_gather_put_reset_fence_match_reference(kind):
    rng = np.random.default_rng(40 + len(kind))
    jmake, tmake = AGGS[kind]
    jag, tag = jmake(), tmake()
    accs = _accs(rng, jag, kind)
    slots = np.concatenate([rng.choice(np.arange(1, CAP), 200, replace=False),
                            np.zeros(56)]).astype(np.int32)
    for g, w in zip(tfam.flat_gather(tag.leaves)(_t(accs),
                                                 torch.from_numpy(slots)),
                    jfam.flat_gather(jag.leaves)(_j(accs),
                                                 jnp.asarray(slots))):
        _eq(g.numpy(), w)
    vals = [(rng.integers(0, 9, 256) if leaf.dtype.kind == "i"
             else _values(rng, kind, 256)).astype(leaf.dtype)
            for leaf in jag.leaves]
    want = jfam.flat_put(jag.leaves)(_j(accs), jnp.asarray(slots), _j(vals))
    got = tfam.flat_put(tag.leaves)(_t(accs), torch.from_numpy(slots),
                                    _t(vals))
    for g, w, leaf in zip(got, want, tag.leaves):
        _eq(g.numpy(), w)
        _eq(g.numpy()[:1], np.asarray([leaf.identity], leaf.dtype))
    want = jfam.flat_reset(jag.leaves)(_j(accs), jnp.asarray(slots))
    got = tfam.flat_reset(tag.leaves)(_t(accs), torch.from_numpy(slots))
    for g, w in zip(got, want):
        _eq(g.numpy(), w)
    leaf = tag.leaves[0]
    fence = tfam.flat_fence(leaf.dtype.str)(_t(accs)[0])
    fence.block_until_ready()
    assert fence.is_ready()
    _eq(fence.value.numpy(), jfam.flat_fence(leaf.dtype.str)(_j(accs)[0]))


# ------------------------------------------------------------ top-k project


def _score_cases():
    rng = np.random.default_rng(77)
    n = 300
    ties = np.where(rng.random(n) < 0.5, 7, rng.integers(0, 7, n))
    f = rng.choice(np.array([3.0, -0.0, 0.0, 2.5, np.inf, -np.inf],
                            np.float32), n)
    bits = f.view(np.uint32)
    pick = rng.random(n)
    bits[pick < 0.05] = 0x7FC00000 + rng.integers(0, 3, int(
        (pick < 0.05).sum())).astype(np.uint32)
    bits[(pick >= 0.05) & (pick < 0.1)] = 0xFFC00001
    return {
        "int32_ties": ties.astype(np.int32),
        "int32_extremes": np.where(rng.random(n) < 0.3,
                                   np.iinfo(np.int32).min,
                                   np.where(rng.random(n) < 0.5,
                                            np.iinfo(np.int32).max, 5)
                                   ).astype(np.int32),
        "int64_ties": ties.astype(np.int64),
        "float32_specials": f,
        "float64_ties": ties.astype(np.float64) / 3,
    }


@pytest.mark.parametrize("k", [4, 16, 400])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("case", sorted(_score_cases()))
def test_top_k_project_matches_lax_top_k(case, descending, k):
    """More than k ties, NaNs of both signs, ±0.0, iinfo extremes and
    invalid rows: the same indices, in the same order, as the reference's
    ``lax.top_k`` form (ROADMAP Queue C item 1)."""
    score = _score_cases()[case]
    rng = np.random.default_rng(len(case) + k)
    valid = rng.random(len(score)) < 0.8
    other = np.arange(len(score), dtype=np.float32)
    with jax.enable_x64(score.dtype.itemsize == 8):
        widx, wcols, wvalid = JTopK("s", k=k, descending=descending).project(
            {"s": jnp.asarray(score), "o": jnp.asarray(other)},
            jnp.asarray(valid))
        widx, wvalid = np.asarray(widx), np.asarray(wvalid)
        wcols = {n: np.asarray(c) for n, c in wcols.items()}
    gidx, gcols, gvalid = TTopK("s", k=k, descending=descending).project(
        {"s": torch.from_numpy(score), "o": torch.from_numpy(other)},
        torch.from_numpy(valid))
    np.testing.assert_array_equal(gidx.numpy(), widx)
    np.testing.assert_array_equal(gvalid.numpy(), wvalid)
    for name in wcols:
        _eq(gcols[name].numpy(), wcols[name])


# ------------------------------------------------------ slot table + spill


def _tables(kind="sum", **kw):
    jmake, tmake = AGGS[kind]
    return JTable(jmake(), **kw), TTable(tmake(), device="cpu", **kw)


def _fill(tables, ns, keys, vals):
    for t in tables:
        slots = t.lookup_or_insert(np.asarray(keys, dtype=np.int64),
                                   np.full(len(keys), ns, dtype=np.int64))
        t.scatter(slots, (np.asarray(vals, dtype=np.float32),))


def _host_state(t):
    """{(key, ns): leaf values} over the device table and the spill tier,
    and the spilled namespaces."""
    out = {}
    accs = [np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()
            for a in t.accs]
    for s in t.index.used_slots().tolist():
        out[(int(t.index.slot_key[s]), int(t.index.slot_ns[s]))] = tuple(
            _bits(a[s:s + 1]).tolist()[0] for a in accs)
    for ns in t.spill.namespaces:
        e = t.spill.peek(ns)
        for j, key in enumerate(e["key_id"].tolist()):
            out[(int(key), int(ns))] = tuple(
                _bits(e[f"leaf_{i}"][j:j + 1]).tolist()[0]
                for i in range(len(t.agg.leaves)))
    return out, sorted(int(n) for n in t.spill.namespaces)


def _same_tables(jt, tt):
    assert _host_state(tt) == _host_state(jt)
    assert sorted(tt.namespaces) == sorted(jt.namespaces)
    assert tt.spill_counters() == jt.spill_counters()
    assert tt.capacity == jt.capacity


def test_eviction_and_transparent_reload():
    """5 namespaces x 400 keys into a 1024-slot device budget: namespaces
    spill, a write to a spilled one reloads it, and both tiers hold the
    reference's rows (values of wide range, so a wrong fold order
    shows)."""
    rng = np.random.default_rng(5)
    tables = _tables(capacity=1024, max_device_slots=1024)
    keys = np.arange(1, 401, dtype=np.int64)
    for ns in range(10, 60, 10):
        _fill(tables, ns, keys, _values(rng, "sum", 400))
        _same_tables(*tables)
    assert len(tables[1].spill) > 0
    _fill(tables, 10, keys[:5], _values(rng, "sum", 5))
    _same_tables(*tables)
    assert 10 not in tables[1].spill


def test_budget_exhausted_with_all_protected_fails_loudly():
    t = _tables(capacity=1024, max_device_slots=1024)[1]
    with pytest.raises(SlotTableFullError, match="protected"):
        t.upsert(np.arange(1, 1500, dtype=np.int64),
                 np.full(1499, 7, dtype=np.int64),
                 (np.ones(1499, np.float32),))


def test_upsert_chunks_a_batch_beyond_the_budget():
    """One batch whose (key, ns) pairs exceed half the budget folds in
    namespace groups, evicting between them, as the reference does."""
    rng = np.random.default_rng(9)
    tables = _tables(capacity=1024, max_device_slots=1024)
    n = 6000
    keys = rng.integers(1, 700, n).astype(np.int64)
    nss = rng.choice(np.array([100, 200, 300, 400]), n).astype(np.int64)
    vals = _values(rng, "sum", n)
    for t in tables:
        t.upsert(keys, nss, (vals,))
    _same_tables(*tables)
    assert len(tables[1].spill) > 0


def test_fires_under_forced_eviction_match_reference():
    """Device fires of resident slices, hybrid fires over spilled ones,
    async fires, then frees of fired slices (spilled entries dropped)."""
    rng = np.random.default_rng(11)
    tables = _tables(capacity=1024, max_device_slots=1024)
    keys = np.arange(1, 401, dtype=np.int64)
    for ns in (2, 4, 6, 8, 10):
        _fill(tables, ns, rng.permutation(keys)[:350],
              _values(rng, "sum", 350))
    jt, tt = tables
    spilled = sorted(int(n) for n in tt.spill.namespaces)
    resident = sorted(int(n) for n in tt.index.namespaces)
    assert spilled and resident
    # device fire over resident slices: rows in first-seen key order
    wk, wm = jt.build_slice_matrix(resident)
    gk, gm = tt.build_slice_matrix(resident)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gm, wm)
    want, got = jt.fire(wm), tt.fire(gm)
    for name in want:
        _eq(got[name], np.asarray(want[name]))
    pending = tt.fire_async(gm, gk)
    keys_h, cols_h = pending.harvest()
    np.testing.assert_array_equal(keys_h, wk)
    _eq(cols_h["sum_v"], np.asarray(want["sum_v"]))
    # hybrid fire over every slice
    wk, wres = jt.fire_hybrid([2, 4, 6, 8, 10])
    gk, gres = tt.fire_hybrid([2, 4, 6, 8, 10])
    np.testing.assert_array_equal(gk, wk)
    _eq(gres["sum_v"], np.asarray(wres["sum_v"]))
    for t in tables:
        t.free_namespaces([spilled[0], resident[0]])
    _same_tables(*tables)
    assert spilled[0] not in tt.spill


def test_filesystem_tier_roundtrip(tmp_path):
    rng = np.random.default_rng(13)
    jt = JTable(jagg.SumAggregate("v"), capacity=1024,
                max_device_slots=1024, spill_dir=str(tmp_path / "j"),
                spill_host_max_bytes=1)
    tt = TTable(tagg.SumAggregate("v"), capacity=1024,
                max_device_slots=1024, spill_dir=str(tmp_path / "t"),
                spill_host_max_bytes=1, device="cpu")
    keys = np.arange(1, 401, dtype=np.int64)
    for ns in (10, 20, 30, 40, 50):
        _fill((jt, tt), ns, keys, _values(rng, "sum", 400))
    assert tt.spill._fs and (tmp_path / "t").exists()
    _same_tables(jt, tt)
    _fill((jt, tt), 10, keys[:3], np.ones(3))   # reload from the fs tier
    _same_tables(jt, tt)


def test_growth_and_const_leaf_keep_slot0_identity():
    """An unbounded table grows by doubling (the device accumulators with
    it); Count's const leaf never reaches the identity slot."""
    tables = _tables("count", capacity=1024)
    rng = np.random.default_rng(17)
    for ns in range(5):
        keys = rng.integers(1, 2000, 3000).astype(np.int64)
        for t in tables:
            slots = t.lookup_or_insert(keys, np.full(3000, ns, np.int64))
            t.scatter(np.concatenate([slots, np.zeros(50, np.int32)]), ())
    jt, tt = tables
    assert tt.capacity == jt.capacity > 1024
    _same_tables(jt, tt)
    assert int(tt.accs[0][0]) == 0


def _sliding(t):
    if isinstance(t, TTable):
        from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    else:
        from flink_tpu.windowing.assigners import SlidingEventTimeWindows
    return SlidingEventTimeWindows.of(2000, 1000)


@pytest.mark.parametrize("call,item", [
    (lambda t: t.query_batch_pairs([1, 1, 3], [1000, 5000, 1000]),
     "item 12"),
    (lambda t: t.query_windows(1, _sliding(t)), "item 12"),
    (lambda t: t.query(1), "item 12"),
])
def test_unported_parts_raise_naming_their_item(call, item):
    # the point queries (item 12e) are ported: each answers as the
    # reference's table on the same rows (tests/test_torch_queries.py
    # holds them at size)
    t = TTable(tagg.SumAggregate("v"), device="cpu")
    j = JTable(jagg.SumAggregate("v"), capacity=1024)
    for tab in (t, j):
        slots = tab.lookup_or_insert(np.array([1, 1, 2], np.int64),
                                     np.array([1000, 2000, 1000], np.int64))
        tab.scatter(slots, (np.array([0.5, 2.0, 4.0], np.float32),))
    got, want = call(t), call(j)
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    else:
        assert got == want and got
    # the paged layout (item 7a) is ported: it builds; an unknown raises
    assert TTable(tagg.SumAggregate("v"), device="cpu", max_device_slots=1024,
                  spill_layout="pages")._paged
    with pytest.raises(ValueError, match="spill_layout"):
        TTable(tagg.SumAggregate("v"), device="cpu", spill_layout="rows")
    # the spill directory resolves through the filesystem SPI (item 8b),
    # as the reference's: an unregistered scheme raises when the tier
    # first writes a file there
    t = TTable(tagg.SumAggregate("v"), device="cpu", max_device_slots=1024,
               spill_dir="s3://bucket/spill", spill_host_max_bytes=1)
    with pytest.raises(ValueError, match="no filesystem registered"):
        t.spill.put(1, {"key_id": np.arange(3)}, dirty=False)


def test_float_leaves_fold_through_the_ordered_fold(monkeypatch):
    """Float leaves go through ``ordered_fold_planes`` (its kernel on the
    card), integer leaves do not."""
    from flink_tpu_torch.stateplane import fold

    calls = []
    plain = fold.ordered_fold_planes_plain
    monkeypatch.setattr(fold, "ordered_fold_planes_plain",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or plain(*a, **kw))
    for kind, want in (("avg", 2), ("count", 0)):
        calls.clear()
        t = TTable(AGGS[kind][1](), device="cpu")
        slots = t.lookup_or_insert(np.arange(1, 9, dtype=np.int64),
                                   np.zeros(8, np.int64))
        t.scatter(slots, (np.ones(8, np.float32),) if kind == "avg" else ())
        assert len(calls) == want
        assert all(s == (1, t.capacity) for s in calls)


def test_free_slots_matches_reference():
    """Frees by (key, ns) entry: the index, the registry and the
    accumulators (back to identity) as the reference leaves them."""
    rng = np.random.default_rng(19)
    tables = _tables(capacity=1024)
    keys = np.arange(1, 301, dtype=np.int64)
    for ns in (1, 2, 3):
        _fill(tables, ns, keys, _values(rng, "sum", 300))
    jt, tt = tables
    victims = rng.choice(jt.index.used_slots(), 200, replace=False)
    for t in tables:
        t.free_slots(victims.astype(np.int32))
    _same_tables(jt, tt)
    for ns in (1, 2, 3):
        np.testing.assert_array_equal(np.sort(tt.slots_for_namespace(ns)),
                                      np.sort(jt.slots_for_namespace(ns)))


@pytest.mark.parametrize("kind", sorted(AGGS))
def test_map_input_valued_matches_reference(kind):
    """Every leaf as an explicit value array, const leaves materialized."""
    from flink_tpu.core.records import RecordBatch as JBatch
    from flink_tpu_torch.core.records import RecordBatch as TBatch

    jmake, tmake = AGGS[kind]
    v = _values(np.random.default_rng(23), kind, 64)
    got = tmake().map_input_valued(TBatch.from_pydict({"v": v}))
    want = jmake().map_input_valued(JBatch.from_pydict({"v": v}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, np.asarray(w))
