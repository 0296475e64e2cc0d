"""The pane layout of the port (``state/pane_table.py``,
``stateplane/pane.py``, ``windowing/windower.py:PaneWindower``) against
the JAX reference's, on the CPU.

- each of the six delta-harvest programs against the reference's
  ``pane_programs`` on the same seeded planes: Count, float32 Sum with NaN
  payloads, +-inf and -0.0, float32 Max/Min with NaN payloads and signed
  zeros, a ``MultiAggregate`` (several leaves through one presence plane),
  the valued scatter, and the fire with and without a top-k projector;
- ``PaneWindower`` with pre-aggregation on and off over the streams of
  ``tests/test_pane_layout.py`` and ``tests/test_latency_tier.py``
  (tumbling, sliding and cumulative windows, out-of-order timestamps,
  late records under allowed lateness, async fires), through the fused
  native ingest and through the NumPy path: the fired rows in emission
  order, float bits equal;
- compaction under key churn, snapshots carried across the two packages,
  the delta snapshot, and the layout's selection by the operator.

Inputs come from numpy seeds. Tolerance: none — rows are compared on
their raw bits, NaN payloads included.
"""

import importlib
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("flink_tpu", "flink_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _raw(v):
    a = np.ascontiguousarray(np.asarray(v))
    return a.dtype.str, a.shape, a.tobytes()


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.kind == "f":
        return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])
    return a


def _assert_bits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, flink_tpu_torch.state.pane_table, "
            "flink_tpu_torch.stateplane.pane\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flink_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ----------------------------------------------------------- the programs

#: aggregates of the program tests, built the same way in both packages
AGG_KINDS = {
    "count": lambda a: a.CountAggregate(),
    "sum_f32": lambda a: a.SumAggregate("v"),
    "sum_f64": lambda a: a.SumAggregate("v", dtype=np.float64),
    "max_f32": lambda a: a.MaxAggregate("v"),
    "min_f32": lambda a: a.MinAggregate("v"),
    "multi": lambda a: a.MultiAggregate(
        [a.SumAggregate("v", output="s"), a.CountAggregate(output="n"),
         a.MinAggregate("v", output="lo")]),
}

#: float specials: signalling, quiet and negative NaN payloads, +-1,
#: +-0, +-inf (float32 bit patterns)
SPECIAL_F32 = np.array([0x7FA00001, 0x7FC00002, 0xFFC00003, 0xFFA00004,
                        0x3F800000, 0xBF800000, 0x0, 0x80000000,
                        0x7F800000, 0xFF800000], np.uint32)
SPECIAL_F64 = np.array([0x7FF4000000000001, 0x7FF8000000000002,
                        0xFFF8000000000003, 0xFFF4000000000004,
                        0x3FF0000000000000, 0xBFF0000000000000, 0x0,
                        0x8000000000000000, 0x7FF0000000000000,
                        0xFFF0000000000000], np.uint64)

R, C = 8, 64


def _aggs(kind):
    return tuple(AGG_KINDS[kind](_mod(pkg, "windowing.aggregates"))
                 for pkg in PKGS)


def _values(rng, leaf, n):
    """Seeded values for one leaf: wide-range floats with NaN payloads,
    infinities and signed zeros mixed in, or small integers."""
    dt = np.dtype(leaf.dtype)
    if dt.kind != "f":
        return rng.integers(0, 5, n).astype(dt)
    v = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))).astype(dt)
    pick = rng.random(n)
    specials = SPECIAL_F64.view(np.float64) if dt == np.float64 \
        else SPECIAL_F32.view(np.float32)
    sel = pick < 0.15
    v[sel] = rng.choice(specials, int(sel.sum()))
    return v


def _planes(rng, agg, rows=R, cols=C):
    """Leaf planes [rows, cols] (row 0 and column 0 the identity) and a
    presence plane, as a table holds them after some ingest."""
    planes = []
    for leaf in agg.leaves:
        p = _values(rng, leaf, rows * cols).reshape(rows, cols)
        p[0, :] = leaf.identity
        p[:, 0] = leaf.identity
        planes.append(p)
    present = (rng.random((rows, cols)) < 0.7).astype(np.int8)
    present[0, :] = 0
    present[:, 0] = 0
    return planes, present


def _flat(rng, n, rows=R, cols=C):
    """Flat scatter indices: hot cells, every row, padding lanes at 0."""
    hot = rng.integers(1, 6, n)
    flat = np.where(rng.random(n) < 0.3, rng.integers(1, rows, n) * cols
                    + hot, rng.integers(1, rows, n) * cols
                    + rng.integers(1, cols, n)).astype(np.int32)
    flat[rng.random(n) < 0.1] = 0
    return flat


def _ref_accs(planes, present):
    import jax.numpy as jnp

    return tuple(jnp.asarray(p) for p in planes) + (jnp.asarray(present),)


def _port_accs(planes, present):
    return tuple(torch.from_numpy(p.copy()) for p in planes) + (
        torch.from_numpy(present.copy()),)


def _x64(kind):
    import jax

    return jax.enable_x64(kind == "sum_f64")


def _both_programs(kind, top_k=0):
    jagg, tagg = _aggs(kind)
    proj = [None, None]
    if top_k:
        order = tagg.output_names[0]
        proj = [_mod(pkg, "windowing.fire_projectors").TopKFireProjector(
            order, k=top_k) for pkg in PKGS]
    jprog = _mod("flink_tpu", "stateplane.pane").pane_programs(jagg, proj[0])
    tprog = _mod("flink_tpu_torch", "stateplane.pane").pane_programs(
        tagg, proj[1])
    return jagg, tagg, jprog, tprog


def _assert_accs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bits(g.numpy(), np.asarray(w), f"leaf {i}")


@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("kind", sorted(AGG_KINDS))
def test_scatter2d_matches_reference(kind, valued):
    """scatter2d and scatter2d_valued: the leaves fold at the flat index
    (floats in stream order, NaN payloads by the reference's rules), the
    presence plane marks every lane off column 0, padding lanes at flat 0
    carry the identity and leave row 0 as it is."""
    import jax.numpy as jnp

    rng = np.random.default_rng(zlib.crc32(f"{kind}{valued}".encode()))
    jagg, tagg, jprog, tprog = _both_programs(kind)
    planes, present = _planes(rng, jagg)
    n = 3000
    flat = _flat(rng, n)
    leaves = jagg.leaves if valued else [
        l for l in jagg.leaves if l.const is None]
    values = []
    for leaf in leaves:
        v = _values(rng, leaf, n)
        v[flat == 0] = leaf.identity
        values.append(v)
    prog = 1 if valued else 0
    with _x64(kind):
        want = jprog[prog](_ref_accs(planes, present), jnp.asarray(flat),
                           tuple(jnp.asarray(v) for v in values))
        want = [np.asarray(w) for w in want]
    got = tprog[prog](_port_accs(planes, present), torch.from_numpy(flat),
                      tuple(torch.from_numpy(v) for v in values))
    _assert_accs(got, want)


@pytest.mark.parametrize("top_k", [0, 4, 80])
@pytest.mark.parametrize("kind", sorted(AGG_KINDS))
def test_fire_rows_matches_reference(kind, top_k):
    """fire_rows over k ring rows (row 0 among them: a missing slice):
    the merge, finish and validity, and with a top-k projector its rows.
    The port reads only the columns below used_n, the reference all of
    them: the columns past used_n are never valid, so the rows a fire
    harvests are the same; k = 80 has fewer valid keys than k."""
    import jax.numpy as jnp

    rng = np.random.default_rng(zlib.crc32(f"{kind}{top_k}".encode()))
    jagg, tagg, jprog, tprog = _both_programs(kind, top_k)
    planes, present = _planes(rng, jagg)
    used = 41
    for p in planes:
        p[:, used:] = p[0, 0]
    present[:, used:] = 0
    rows = np.asarray([3, 0, 5, 1, 6], dtype=np.int32)
    with _x64(kind):
        want = jprog[2](_ref_accs(planes, present), jnp.asarray(rows), used)
        want = [np.asarray(w) if not isinstance(w, dict)
                else {n: np.asarray(c) for n, c in w.items()} for w in want]
    got = tprog[2](_port_accs(planes, present), torch.from_numpy(rows), used)
    if not top_k:
        (wcols, wvalid), (gcols, gvalid) = want, got
        assert not wvalid[used:].any()
        _assert_bits(gvalid.numpy(), wvalid[:used])
        sel = wvalid[:used]
        assert sorted(gcols) == sorted(wcols)
        for name in wcols:
            _assert_bits(gcols[name].numpy()[sel], wcols[name][:used][sel],
                         name)
        return
    (widx, wcols, wvalid), (gidx, gcols, gvalid) = want, got
    gidx, gvalid = gidx.numpy(), gvalid.numpy()
    # indices, resolved to keys on the host: int64 in the port
    np.testing.assert_array_equal(gidx[gvalid], widx[wvalid])
    for name in wcols:
        _assert_bits(gcols[name].numpy()[gvalid], wcols[name][wvalid], name)
    if top_k > used:
        assert wvalid.sum() < top_k


@pytest.mark.parametrize("kind", sorted(AGG_KINDS))
def test_reset_put_and_fold_rows_match_reference(kind):
    """reset_row (identity, presence 0), put_row (a restore's rows into
    one ring row, column 0 never present) and fold_rows (a window's
    partial rebuilt from its pane rows)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    jagg, tagg, jprog, tprog = _both_programs(kind)
    planes, present = _planes(rng, jagg)
    cols = rng.permutation(np.arange(0, C))[:20].astype(np.int32)
    vals = [_values(rng, leaf, len(cols)) for leaf in jagg.leaves]
    rows = np.asarray([2, 0, 4, 7, 1], dtype=np.int32)
    with _x64(kind):
        j = _ref_accs(planes, present)
        j = jprog[3](j, 5)
        j = jprog[4](j, 6, jnp.asarray(cols),
                     tuple(jnp.asarray(v) for v in vals))
        j = jprog[5](j, 3, jnp.asarray(rows))
        want = [np.asarray(w) for w in j]
    t = _port_accs(planes, present)
    t = tprog[3](t, 5)
    t = tprog[4](t, 6, torch.from_numpy(cols),
                 tuple(torch.from_numpy(v) for v in vals))
    t = tprog[5](t, 3, torch.from_numpy(rows), C)
    _assert_accs(t, want)


# ---------------------------------------------------------- the windower

def _events(pkg, n=6000, keys=250, seed=13, rate=1000, jitter=0,
            integer=False):
    """tests/test_pane_layout.py's stream (wide-range float32 values here,
    so that float sums depend on their order; ``integer``: the small
    integers of tests/test_latency_tier.py); ``jitter`` ms of seeded
    out-of-order timestamps."""
    rec = _mod(pkg, "core.records")
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, keys, n).astype(np.int64)
    ts = (np.arange(n, dtype=np.int64) * 1000) // rate
    if jitter:
        ts = np.maximum(ts - rng.integers(0, jitter, n), 0)
    vs = rng.integers(0, 16, n).astype(np.float32) if integer else \
        (rng.standard_normal(n) * np.exp(rng.uniform(-4, 4, n))) \
        .astype(np.float32)
    return rec.RecordBatch.from_pydict(
        {rec.KEY_ID_FIELD: ks, "v": vs}, timestamps=ts)


def _multi(pkg):
    return AGG_KINDS["multi"](_mod(pkg, "windowing.aggregates"))


ASSIGNERS = {
    "tumbling": lambda a: a.TumblingEventTimeWindows.of(1000),
    "sliding": lambda a: a.SlidingEventTimeWindows.of(2000, 500),
    "cumulative": lambda a: a.CumulativeEventTimeWindows(4000, 1000),
}


def _pane(pkg, assigner="sliding", agg=None, preagg=True, numpy_path=False,
          **kw):
    w = _mod(pkg, "windowing.windower")
    asg = ASSIGNERS[assigner](_mod(pkg, "windowing.assigners"))
    if pkg == "flink_tpu_torch":
        kw["device"] = "cpu"
    win = w.PaneWindower(asg, agg or _multi(pkg), capacity=kw.pop(
        "capacity", 4096), preagg=preagg, **kw)
    if numpy_path:
        # the NumPy ingest (assign, plan, lookup, fuse) in place of the
        # native sweep, in both packages
        win.table.ingest_indices = lambda *a: None
    return win


def _drive(w, batch, step=1000, wm_lag=700, async_ok=False, flush=True):
    """Feed chunks with advancing watermarks; the fired batches in
    emission order (async fires harvested where they were emitted)."""
    fired = []

    def collect(out):
        for b in out:
            if hasattr(b, "harvest"):
                b = b.harvest()
            if b is not None:
                fired.append(b)

    kw = {"async_ok": True} if async_ok else {}
    for i in range(0, len(batch), step):
        chunk = batch.slice(i, min(i + step, len(batch)))
        w.process_batch(chunk)
        collect(w.on_watermark(int(chunk.timestamps.max()) - wm_lag, **kw))
    if flush:
        collect(w.on_watermark(1 << 60, **kw))
    return fired


def _same_fires(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g.names()) == sorted(w.names())
        for name in w.names():
            assert _raw(g[name]) == _raw(w[name]), name


@pytest.mark.parametrize("ingest", ["fused", "numpy"])
@pytest.mark.parametrize("preagg", [True, False])
@pytest.mark.parametrize("assigner", sorted(ASSIGNERS))
def test_pane_windower_matches_reference(assigner, preagg, ingest):
    """Sum, Count and Min through one presence plane, out-of-order
    timestamps, late records dropped: the port fires the reference's
    batches in its order, float bits equal. The fused ingest hands out the
    distinct slice ends in first-seen order, the NumPy path sorted; that
    order decides how the window-partial lanes are concatenated, and so
    the bits of a partial fed from two slices in one batch."""
    fires = {}
    for pkg in PKGS:
        w = _pane(pkg, assigner, preagg=preagg,
                  numpy_path=(ingest == "numpy"))
        fires[pkg] = _drive(w, _events(pkg, jitter=3000))
        fires[pkg + ".late"] = w.late_records_dropped
    _same_fires(fires["flink_tpu_torch"], fires["flink_tpu"])
    assert fires["flink_tpu_torch.late"] == fires["flink_tpu.late"] > 0


@pytest.mark.parametrize("preagg", [True, False])
def test_pane_windower_async_fires_match_reference(preagg):
    """Async fires (PendingFire, harvested after dispatch) with allowed
    lateness: the late records re-fire retained windows."""
    fires = {}
    for pkg in PKGS:
        w = _pane(pkg, preagg=preagg, allowed_lateness=1500)
        fires[pkg] = _drive(w, _events(pkg, seed=11, jitter=2500),
                            async_ok=True)
    _same_fires(fires["flink_tpu_torch"], fires["flink_tpu"])


@pytest.mark.parametrize("preagg", [True, False])
def test_late_refire_refolds_from_panes(preagg):
    """tests/test_latency_tier.py's late re-fire: a late record
    re-registers a fired window, whose partial is refolded from the
    retained panes; both packages emit the same rows."""
    rows = {}
    for pkg in PKGS:
        rec = _mod(pkg, "core.records")
        asg = _mod(pkg, "windowing.assigners").SlidingEventTimeWindows.of(
            1000, 500)
        kw = {"device": "cpu"} if pkg == "flink_tpu_torch" else {}
        w = _mod(pkg, "windowing.windower").PaneWindower(
            asg, _multi(pkg), capacity=1024, allowed_lateness=2000,
            preagg=preagg, **kw)
        out = []
        for ks, vs, ts, wm in (([1, 2], [3.25, 5.5], [100, 600], 1100),
                               ([1], [7.125], [300], 1200),
                               ([2], [2.0], [1400], 1 << 60)):
            w.process_batch(rec.RecordBatch.from_pydict(
                {rec.KEY_ID_FIELD: np.asarray(ks, dtype=np.int64),
                 "v": np.asarray(vs, dtype=np.float32)}, timestamps=ts))
            out.extend(w.on_watermark(wm))
        rows[pkg] = out
    _same_fires(rows["flink_tpu_torch"], rows["flink_tpu"])
    ends = [int(e) for b in rows["flink_tpu_torch"]
            for e in b["window_end"]]
    assert ends.count(1000) >= 2


@pytest.mark.parametrize("preagg", [True, False])
def test_fused_top_k_fire_matches_reference(preagg):
    """A Count with a top-k projector fused into the fire: the same rows,
    ties to the lowest column, in the reference's order."""
    fires = {}
    for pkg in PKGS:
        aggs = _mod(pkg, "windowing.aggregates")
        proj = _mod(pkg, "windowing.fire_projectors").TopKFireProjector(
            "count", k=8)
        w = _pane(pkg, agg=aggs.CountAggregate(), preagg=preagg,
                  fire_projector=proj)
        fires[pkg] = _drive(w, _events(pkg, integer=True))
    _same_fires(fires["flink_tpu_torch"], fires["flink_tpu"])


def test_sum_zero_still_emitted():
    """Presence, not the value, decides emission: a window sum of
    exactly 0.0 fires."""
    rec = _mod("flink_tpu_torch", "core.records")
    aggs = _mod("flink_tpu_torch", "windowing.aggregates")
    w = _pane("flink_tpu_torch", "tumbling",
              agg=aggs.SumAggregate("v", output="s"), capacity=1024)
    w.process_batch(rec.RecordBatch.from_pydict(
        {rec.KEY_ID_FIELD: np.asarray([5, 5], dtype=np.int64),
         "v": np.asarray([2.5, -2.5], dtype=np.float32)},
        timestamps=[100, 200]))
    rows = [r for b in w.on_watermark(1 << 60) for r in b.to_rows()]
    assert len(rows) == 1 and rows[0]["s"] == 0.0


def test_compaction_matches_reference():
    """Key churn past _COMPACT_MIN_KEYS: departed keys' columns are
    reclaimed (the table rebuilt from its own snapshot), and the fires
    before and after equal the reference's."""
    fires, used = {}, {}
    for pkg in PKGS:
        rec = _mod(pkg, "core.records")
        w = _pane(pkg, "tumbling", capacity=8192)
        w.table._COMPACT_MIN_KEYS = 512
        out = []
        rng = np.random.default_rng(3)
        for wave in range(8):
            ks = np.arange(wave * 300, wave * 300 + 300, dtype=np.int64)
            w.process_batch(rec.RecordBatch.from_pydict(
                {rec.KEY_ID_FIELD: ks,
                 "v": rng.standard_normal(300).astype(np.float32)},
                timestamps=np.full(300, wave * 1000 + 500)))
            out.extend(w.on_watermark(wave * 1000 + 999))
        used[pkg] = w.table.used_cols
        w.process_batch(rec.RecordBatch.from_pydict(
            {rec.KEY_ID_FIELD: np.asarray([7_000, 7_001], dtype=np.int64),
             "v": np.asarray([1.5, 2.5], dtype=np.float32)},
            timestamps=np.full(2, 9_500)))
        out.extend(w.on_watermark(1 << 60))
        fires[pkg] = out
    assert used["flink_tpu_torch"] == used["flink_tpu"] < 1200
    _same_fires(fires["flink_tpu_torch"], fires["flink_tpu"])


@pytest.mark.parametrize("preagg", [True, False])
@pytest.mark.parametrize("src,dst", [("flink_tpu", "flink_tpu_torch"),
                                     ("flink_tpu_torch", "flink_tpu")])
def test_snapshot_crosses_packages(src, dst, preagg):
    """A snapshot taken by one package and restored into the other
    continues to the rows the reference gives after restoring its own
    snapshot: the table's logical rows (key_id, namespace, key_group,
    leaf_i) and the bookkeeper's metadata are one format."""
    def half(pkg, part):
        b = _events(pkg, n=3000, keys=120, jitter=400)
        return b.slice(0, 1500) if part == 0 else b.slice(1500, 3000)

    one = _pane(src, preagg=preagg)
    _drive(one, half(src, 0), flush=False)
    snap = one.snapshot()
    two = _pane(dst, preagg=preagg)
    two.restore(snap)
    assert set(two.table.window_row) == set(one.table.window_row)
    got = _drive(two, half(dst, 1))
    ref = _pane("flink_tpu", preagg=preagg)
    _drive(ref, half("flink_tpu", 0), flush=False)
    again = _pane("flink_tpu", preagg=preagg)
    again.restore(ref.snapshot())
    _same_fires(got, _drive(again, half("flink_tpu", 1)))


def test_snapshot_and_delta_equal_reference():
    """The full snapshot, a delta of the dirty slices and the freed
    slices' tombstones hold the reference's arrays."""
    snaps = {}
    for pkg in PKGS:
        rec = _mod(pkg, "core.records")
        w = _pane(pkg, "tumbling")
        w.process_batch(_events(pkg, n=1500, keys=90))
        full = w.snapshot()
        w.process_batch(rec.RecordBatch.from_pydict(
            {rec.KEY_ID_FIELD: np.arange(5, dtype=np.int64),
             "v": np.ones(5, np.float32)}, timestamps=np.full(5, 1700)))
        w.on_watermark(900)
        snaps[pkg] = (full, w.snapshot(mode="delta"))
    for got, want in zip(snaps["flink_tpu_torch"], snaps["flink_tpu"]):
        assert sorted(got) == sorted(want)
        for name in want:
            if name == "table":
                assert sorted(got[name]) == sorted(want[name])
                for col in want[name]:
                    _assert_bits(got[name][col], want[name][col], col)
            else:
                assert got[name] == want[name], name


def test_bookkeeper_snapshot_restores_across_packages():
    """SliceBookkeeper.snapshot/restore: the reference's dict, and a
    restore that schedules the same fires and cleanups."""
    books = {}
    for pkg in PKGS:
        asg = ASSIGNERS["sliding"](_mod(pkg, "windowing.assigners"))
        b = _mod(pkg, "windowing.bookkeeping").SliceBookkeeper(asg, 700)
        ends = asg.assign_slice_ends(np.arange(0, 5000, 37))
        b.register_slices(ends)
        books[pkg] = b
        b.next_window(1800)
    snap = books["flink_tpu"].snapshot()
    assert books["flink_tpu_torch"].snapshot() == snap
    asg = ASSIGNERS["sliding"](_mod("flink_tpu_torch", "windowing.assigners"))
    port = _mod("flink_tpu_torch", "windowing.bookkeeping").SliceBookkeeper(
        asg, 700)
    port.restore(snap)
    ref = books["flink_tpu"]
    for wm in (2500, 4000, 1 << 40):
        got, want = [], []
        while (w := port.next_window(wm)) is not None:
            got.append(w)
            port.mark_fired(w)
        while (w := ref.next_window(wm)) is not None:
            want.append(w)
            ref.mark_fired(w)
        assert got == want
        assert port.expired_slices(wm) == ref.expired_slices(wm)


@pytest.mark.parametrize("assigner", ["cumulative_4000_1000",
                                      "cumulative_3000_500_offset_200"])
def test_cumulative_assigner_matches_reference(assigner):
    """CumulativeEventTimeWindows: slices, windows of a slice, slices of a
    window, window starts and last windows, as the reference's."""
    _, size, step, *rest = assigner.split("_")
    off = int(rest[1]) if rest else 0
    asgs = [_mod(pkg, "windowing.assigners").CumulativeEventTimeWindows(
        int(size), int(step), off) for pkg in PKGS]
    ts = np.random.default_rng(5).integers(0, 20_000, 500)
    ref, port = asgs
    _assert_bits(port.assign_slice_ends(ts), ref.assign_slice_ends(ts))
    ends = np.unique(ref.assign_slice_ends(ts))
    _assert_bits(port.last_window_ends(ends), ref.last_window_ends(ends))
    assert port.slices_per_window == ref.slices_per_window
    for se in ends.tolist():
        assert [int(w) for w in port.window_ends_for_slice(se)] == \
            [int(w) for w in ref.window_ends_for_slice(se)]
        for w in ref.window_ends_for_slice(se):
            assert [int(s) for s in port.slice_ends_for_window(int(w))] == \
                [int(s) for s in ref.slice_ends_for_window(int(w))]
            assert port.window_start(int(w)) == ref.window_start(int(w))


def test_multi_aggregate_matches_reference():
    """MultiAggregate: the reference's leaves (names, dtypes, reduces,
    constants), inputs and finished columns."""
    jagg, tagg = _aggs("multi")
    assert [(l.name, np.dtype(l.dtype), l.reduce, l.const)
            for l in tagg.leaves] == \
        [(l.name, np.dtype(l.dtype), l.reduce, l.const) for l in jagg.leaves]
    assert tagg.output_names == jagg.output_names
    batch = _events("flink_tpu_torch", n=50)
    for g, w in zip(tagg.map_input(batch), jagg.map_input(batch)):
        _assert_bits(g, w)
    merged = [np.arange(1, 4, dtype=np.dtype(l.dtype)) for l in jagg.leaves]
    want = jagg.finish(tuple(merged))
    got = tagg.finish(tuple(torch.from_numpy(m) for m in merged))
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_bits(got[name].numpy(), np.asarray(want[name]), name)


# ------------------------------------------------------------ the operator

def _operator(layout, preagg=True, **ctx):
    from flink_tpu_torch.runtime.operators import (
        OperatorContext,
        WindowAggOperator,
    )
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    op = WindowAggOperator(SlidingEventTimeWindows.of(2000, 500),
                           _multi("flink_tpu_torch"), "k")
    op.open(OperatorContext(parallelism=1, device="cpu",
                            window_layout=layout, pane_preagg=preagg, **ctx))
    return op


def test_layout_selection():
    """'panes' opens the pane windower with latency.pane-preagg's value,
    'auto' resolves to the slot layout (as in the reference), and a spill
    tier or a placement backend is refused with panes."""
    assert type(_operator("auto").windower).__name__ == "SliceSharedWindower"
    op = _operator("panes")
    assert type(op.windower).__name__ == "PaneWindower"
    assert op.windower._preagg is True
    assert _operator("panes", preagg=False).windower._preagg is False
    with pytest.raises(ValueError, match="no spill tier"):
        _operator("panes", spill={"max_device_slots": 2048})
    with pytest.raises(ValueError, match="placement"):
        _operator("panes", state_backend="host-heap")


def test_query_windows_names_its_roadmap_item():
    w = _pane("flink_tpu_torch")
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        w.table.query_windows(1, w.assigner)


def test_panes_without_a_device_raise_without_a_card():
    """The pane table's default device is execution.device's, the card:
    without one it raises, never continuing on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from flink_tpu_torch.windowing.aggregates import CountAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.windower import PaneWindower

    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        PaneWindower(SlidingEventTimeWindows.of(2000, 500),
                     CountAggregate(), capacity=1024)
