"""Snapshots and restore of every engine the port runs, against the
reference, on the CPU.

- Snapshot dicts after the same batches: ``SlotTable`` (no budget, the
  namespace spill tier, the paged tier), ``PaneTable`` (through
  ``PaneWindower``), ``SessionWindower`` (Python and native metadata
  planes), ``MeshWindowEngine`` and ``MeshSessionEngine`` (paged) — the
  full snapshot, a delta after more batches, and a savepoint, each equal to
  the reference's array by array, bit for bit, rows in the same order
  (the engines allocate the same slots and spill the same pages).
- Cross-restore through the checkpoint directory: one package's engine
  snapshots mid-stream and writes a checkpoint with its own storage; the
  other package reads it and its engine restores and continues. P=1 ->
  P=1, P=8 -> P=1 and P=1 -> P=8, windows and sessions, in both
  directions. The continued output equals the reference's uninterrupted
  run, bit for bit, compared in canonical (key, start, end) order: a
  restore allocates slots in snapshot order, which changes the order of
  rows inside a fired batch, not their values.
- The paged restore (``restore_into_pages``, the mesh
  ``_paged_restore_rows``), ``SessionIntervalSet.restore`` with a key-group
  filter and ``filter_snapshot``, and that a snapshot holds only numpy
  arrays and builtins.

Inputs come from numpy seeds. Tolerance: none.
"""

import numpy as np
import pytest
import torch

from flink_tpu.checkpoint import storage as jstorage
from flink_tpu.core.records import KEY_ID_FIELD, RecordBatch as JBatch
from flink_tpu.parallel.sharded_sessions import MeshSessionEngine as JMeshS
from flink_tpu.parallel.sharded_windower import MeshWindowEngine as JMeshW
from flink_tpu.state import paged_spill as jpaged
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing import assigners as jasg
from flink_tpu.windowing.session_meta import (
    SessionIntervalSet as JIntervals,
)
from flink_tpu.windowing.sessions import SessionWindower as JSessions
from flink_tpu.windowing.windower import (
    PaneWindower as JPanes,
    SliceSharedWindower as JSlots,
)
from flink_tpu_torch.checkpoint import storage as tstorage
from flink_tpu_torch.core.records import RecordBatch as TBatch
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import (
    MeshSessionEngine as TMeshS,
)
from flink_tpu_torch.parallel.sharded_windower import (
    MeshWindowEngine as TMeshW,
)
from flink_tpu_torch.state import paged_spill as tpaged
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing import assigners as tasg
from flink_tpu_torch.windowing.session_meta import (
    SessionIntervalSet as TIntervals,
)
from flink_tpu_torch.windowing.sessions import SessionWindower as TSessions
from flink_tpu_torch.windowing.windower import (
    PaneWindower as TPanes,
    SliceSharedWindower as TSlots,
)

P = 8
GAP = 100
_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def assert_state_equal(got, want, path="snap"):
    """Two snapshot dicts equal: the same keys, every array with the same
    dtype and bits, every other value equal."""
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        where = f"{path}.{k}"
        if isinstance(w, dict):
            assert_state_equal(g, w, where)
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), where
            assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=where)
        else:
            assert g == w, where


# ---------------------------------------------------------------- engines

def _window_stream(seed, steps=10, n=500, keys=2500, disorder=800):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        k = rng.integers(0, keys, n).astype(np.int64)
        v = (rng.standard_normal(n)
             * np.exp(rng.uniform(-6, 6, n))).astype(np.float32)
        ts = rng.integers(step * 1000 - disorder, step * 1000 + 1000,
                          n).astype(np.int64)
        out.append((k, v, np.maximum(ts, 0), step * 1000 - 1))
    return out


def _session_stream(seed, steps=10, n=1500, keys=6000):
    """The chaos scenarios' shape: a live session set far beyond a
    1024-row budget, so paged eviction and reload are on the path."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        k = rng.integers(0, keys, n).astype(np.int64)
        v = rng.random(n).astype(np.float32)
        ts = rng.integers(s * 80, s * 80 + 60, n).astype(np.int64)
        out.append((k, v, ts, (s - 1) * 80))
    return out


def _sliding():
    return (jasg.SlidingEventTimeWindows.of(3000, 1000),
            tasg.SlidingEventTimeWindows.of(3000, 1000))


def _force_python_plane(eng, pkg):
    eng.meta = (JIntervals if pkg == "ref" else TIntervals)(GAP)
    return eng


def make_engine(kind, pkg, jmesh=None):
    """One engine of ``kind`` in package ``pkg`` ("ref" or "port"), on the
    CPU."""
    ref = pkg == "ref"
    agg = (jagg if ref else tagg).SumAggregate("v")
    dev = {} if ref else {"device": "cpu"}
    ja, ta = _sliding()
    asg = ja if ref else ta
    mesh = jmesh if ref else make_mesh(P, "cpu")
    if kind == "slots":
        return (JSlots if ref else TSlots)(asg, agg, capacity=1024,
                                          spill=dict(dev))
    if kind == "slots_spill":
        return (JSlots if ref else TSlots)(
            asg, agg, capacity=1024,
            spill={"max_device_slots": 1024, **dev})
    if kind == "panes":
        kw = {} if ref else {"device": "cpu"}
        return (JPanes if ref else TPanes)(asg, agg, capacity=4096, **kw)
    if kind == "mesh_window":
        return (JMeshW if ref else TMeshW)(asg, agg, mesh,
                                          capacity_per_shard=1024)
    if kind in ("sessions_python", "sessions_paged"):
        spill = dict(dev)
        if kind == "sessions_paged":
            spill["max_device_slots"] = 2048
        eng = (JSessions if ref else TSessions)(GAP, agg, capacity=1 << 12,
                                                spill=spill)
        return (_force_python_plane(eng, pkg) if kind == "sessions_python"
                else eng)
    if kind == "mesh_sessions":
        return (JMeshS if ref else TMeshS)(
            GAP, agg, mesh, capacity_per_shard=1 << 14,
            max_device_slots=1024, max_dispatch_ahead=2)
    raise KeyError(kind)


def _is_session(kind):
    return "session" in kind


def _batch(pkg, keys, vals, ts):
    cls = JBatch if pkg == "ref" else TBatch
    return cls.from_pydict({KEY_ID_FIELD: keys, "v": vals}, timestamps=ts)


def _harvest(fired):
    out = []
    for b in fired:
        if hasattr(b, "harvest"):
            b = b.harvest()
        if b is not None and len(b):
            out.append(b)
    return out


def feed(eng, pkg, steps):
    fired = []
    for keys, vals, ts, wm in steps:
        eng.process_batch(_batch(pkg, keys, vals, ts))
        fired.extend(_harvest(eng.on_watermark(int(wm))))
    return fired


def finish(eng):
    return _harvest(eng.on_watermark(1 << 60))


def _stream_for(kind, seed=5):
    if kind == "mesh_sessions":
        # past the mesh's 8 x 1024 rows
        return _session_stream(seed, n=5000, keys=60000)
    return (_session_stream(seed) if _is_session(kind)
            else _window_stream(seed))


SNAPSHOT_KINDS = ["slots", "slots_spill", "panes", "mesh_window",
                  "sessions_python", "sessions_paged", "mesh_sessions"]


@pytest.mark.parametrize("kind", SNAPSHOT_KINDS)
def test_snapshots_equal_reference(kind, eight_device_mesh):
    """Full, delta and savepoint snapshots after the same batches, array
    by array and bit for bit (rows in the same order)."""
    steps = _stream_for(kind)
    j = make_engine(kind, "ref", eight_device_mesh)
    t = make_engine(kind, "port")
    feed(j, "ref", steps[:5])
    feed(t, "port", steps[:5])
    assert_state_equal(t.snapshot(), j.snapshot(), "full")
    feed(j, "ref", steps[5:7])
    feed(t, "port", steps[5:7])
    jd, td = j.snapshot(mode="delta"), t.snapshot(mode="delta")
    assert len(jd["table"]["key_id"]) > 0
    assert_state_equal(td, jd, "delta")
    feed(j, "ref", steps[7:9])
    feed(t, "port", steps[7:9])
    assert_state_equal(t.snapshot(mode="savepoint"),
                       j.snapshot(mode="savepoint"), "savepoint")
    # the savepoint kept the dirty tracking: the next delta is the same
    assert_state_equal(t.snapshot(mode="delta"), j.snapshot(mode="delta"),
                       "delta after savepoint")
    if kind in ("sessions_paged", "mesh_sessions"):
        # the budget was exceeded: paged rows were in the snapshots
        assert t.spill_counters()["rows_evicted"] > 0


def _walk(obj, path="snap"):
    yield path, obj
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(k, f"{path}[key]")
            yield from _walk(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")


@pytest.mark.parametrize("kind", SNAPSHOT_KINDS)
def test_snapshot_holds_only_numpy_and_builtins(kind):
    """The pickled metadata may hold only builtins and numpy values: no
    torch.Tensor and no class of either package reaches a snapshot."""
    t = make_engine(kind, "port")
    feed(t, "port", _stream_for(kind)[:4])
    for mode in ("full", "delta"):
        for path, v in _walk(t.snapshot(mode=mode)):
            assert not isinstance(v, torch.Tensor), path
            mod = type(v).__module__ or ""
            assert not mod.startswith(("flink_tpu", "torch")), (path, mod)
            assert (isinstance(v, (np.ndarray, np.generic, dict, list, tuple,
                                   int, float, bool, str, type(None)))), (
                path, type(v))


# ----------------------------------------------------------- cross-restore

def _canonical(batches):
    """{(key, start, end): sum bits} over fired batches."""
    out = {}
    for b in batches:
        keys = np.asarray(b[KEY_ID_FIELD])
        st = np.asarray(b["window_start"])
        en = np.asarray(b["window_end"])
        vals = _bits(np.asarray(b["sum_v"]))
        for k, s, e, v in zip(keys.tolist(), st.tolist(), en.tolist(),
                              vals.tolist()):
            assert (k, s, e) not in out
            out[(k, s, e)] = v
    return out


_KIND = {("window", 1): "slots", ("window", 8): "mesh_window",
         ("session", 1): "sessions_paged", ("session", 8): "mesh_sessions"}


@pytest.mark.parametrize("shape", ["window", "session"])
@pytest.mark.parametrize("src,dst", [
    (("ref", 1), ("port", 1)), (("port", 1), ("ref", 1)),
    (("ref", 8), ("port", 1)), (("port", 8), ("ref", 1)),
    (("ref", 1), ("port", 8)), (("port", 1), ("ref", 8)),
])
def test_cross_restore_continues_bit_for_bit(shape, src, dst, tmp_path,
                                             eight_device_mesh):
    """A checkpoint written mid-stream by one package restores in the
    other (any P to any P) and the continued output equals the reference's
    uninterrupted run."""
    steps = _stream_for(_KIND[(shape, 1)], seed=11)
    cut = 5
    (spkg, sp), (dpkg, dp) = src, dst
    src_eng = make_engine(_KIND[(shape, sp)], spkg, eight_device_mesh)
    feed(src_eng, spkg, steps[:cut])
    write = (jstorage if spkg == "ref" else tstorage).CheckpointStorage
    read = (jstorage if dpkg == "ref" else tstorage).CheckpointStorage
    write(str(tmp_path)).write_checkpoint(
        1, "x", {"0:engine": src_eng.snapshot()}, extra={"source_pos": cut})
    state = read(str(tmp_path)).read_checkpoint(1)["0:engine"]
    dst_eng = make_engine(_KIND[(shape, dp)], dpkg, eight_device_mesh)
    dst_eng.restore(state)
    got = feed(dst_eng, dpkg, steps[cut:]) + finish(dst_eng)
    ref = make_engine(_KIND[(shape, dp)], "ref", eight_device_mesh)
    feed(ref, "ref", steps[:cut])
    want = feed(ref, "ref", steps[cut:]) + finish(ref)
    assert want
    assert _canonical(got) == _canonical(want)


@pytest.mark.parametrize("kind", ["slots", "sessions_paged",
                                  "mesh_window", "mesh_sessions"])
def test_restore_then_snapshot_round_trips(kind, eight_device_mesh):
    """A restored engine's full snapshot holds the rows it was given (in
    canonical order; the paged restores keep every row in pages) and
    equals the reference's restore of the same snapshot."""
    steps = _stream_for(kind, seed=3)
    src = make_engine(kind, "ref", eight_device_mesh)
    feed(src, "ref", steps[:6])
    snap = src.snapshot()
    j = make_engine(kind, "ref", eight_device_mesh)
    t = make_engine(kind, "port")
    j.restore(snap)
    t.restore(snap)
    assert_state_equal(t.snapshot(), j.snapshot(), "restored")
    order = np.lexsort((snap["table"]["namespace"], snap["table"]["key_id"]))
    got = t.snapshot()["table"]
    gorder = np.lexsort((got["namespace"], got["key_id"]))
    for col in ("key_id", "namespace", "leaf_0"):
        np.testing.assert_array_equal(_bits(got[col][gorder]),
                                      _bits(snap["table"][col][order]))


def test_paged_restore_goes_through_pages(eight_device_mesh):
    """More live sessions than the per-shard budget: the mesh restore
    packs them into pages (``_paged_restore_rows`` -> ``restore_into_pages``)
    with the reference's page layout, and nothing lands on the planes."""
    steps = _session_stream(2, steps=10, n=3000, keys=60000)
    src = make_engine("mesh_sessions", "ref", eight_device_mesh)
    feed(src, "ref", steps)
    snap = src.snapshot()
    assert len(snap["table"]["key_id"]) > P * 1024
    j = make_engine("mesh_sessions", "ref", eight_device_mesh)
    t = make_engine("mesh_sessions", "port")
    j.restore(snap)
    t.restore(snap)
    for p in range(P):
        assert t.indexes[p].num_used == 0
        jm, tm = j._pmaps[p], t._pmaps[p]
        for f in ("sp_ns", "sp_page", "sp_row"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
        assert sorted(t.spills[p].namespaces) == sorted(
            j.spills[p].namespaces)
    got = finish(t)
    assert _canonical(got) == _canonical(finish(j))


@pytest.mark.parametrize("dirty", [False, True])
def test_restore_into_pages_matches_reference(dirty):
    from flink_tpu.state.slot_table import SpillTier as JSpill
    from flink_tpu_torch.state.slot_table import SpillTier as TSpill

    rng = np.random.default_rng(4)
    n = 5000
    keys = rng.integers(0, 900, n).astype(np.int64)
    nss = rng.permutation(n).astype(np.int64) // 2  # pairs share an ns
    leaves = [rng.random(n).astype(np.float32)]
    d = rng.random(n) < 0.5 if dirty else None
    out = []
    for mod, spill in ((jpaged, JSpill()), (tpaged, TSpill())):
        pm = mod.PagedSpillMap()
        mod.restore_into_pages(spill, pm, keys, nss, leaves, 700, dirty=d)
        out.append((spill, pm))
    (js, jm), (ts, tm) = out
    assert ts.namespaces == js.namespaces
    for page in js.namespaces:
        assert_state_equal(ts.peek(page), js.peek(page), f"page {page}")
    for f in ("sp_ns", "sp_page", "sp_row"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    assert tm.sorted and jm.sorted


@pytest.mark.parametrize("groups", [None, range(0, 64), [3, 77, 127]])
def test_interval_set_restore_with_key_group_filter(groups):
    """``SessionIntervalSet.restore`` keeps only the filtered key groups'
    sessions (singles and multi-interval keys), and ``filter_snapshot``
    splits a snapshot the reference's way."""
    rng = np.random.default_rng(9)
    j, t = JIntervals(GAP), TIntervals(GAP)
    for s in range(6):
        keys = rng.integers(0, 400, 600).astype(np.int64)
        ts = rng.integers(s * 300, s * 300 + 900, 600).astype(np.int64)
        j.absorb_batch(keys, ts)
        t.absorb_batch(keys, ts)
    snap = j.snapshot()
    assert t.snapshot() == snap
    jr, tr = JIntervals(GAP), TIntervals(GAP)
    jr.restore(snap, key_group_filter=groups, max_parallelism=128)
    tr.restore(snap, key_group_filter=groups, max_parallelism=128)
    assert tr.snapshot() == jr.snapshot()
    if groups is not None:
        assert (TIntervals.filter_snapshot(snap, groups, 128)
                == JIntervals.filter_snapshot(snap, groups, 128))
        assert len(tr.snapshot()["sessions"]) < len(snap["sessions"])
    for wm in (900, 1e9):
        jf, tf = jr.pop_fired(int(wm)), tr.pop_fired(int(wm))
        for a, b in zip(tf, jf):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_plane_restore_resyncs_multi_intervals():
    """The native plane restores the same interval set as the Python plane
    (its multi-interval membership re-synced), so both fire the same."""
    from flink_tpu_torch.windowing.session_meta import make_session_meta
    from flink_tpu_torch.windowing.session_native import (
        NativeSessionIntervalSet,
    )

    rng = np.random.default_rng(6)
    src = TIntervals(GAP)
    for s in range(5):
        keys = rng.integers(0, 300, 500).astype(np.int64)
        ts = rng.integers(0, 2000, 500).astype(np.int64)
        src.absorb_batch(keys, ts)
    snap = src.snapshot()
    assert any(len(v) > 1 for v in snap["sessions"].values())
    native = make_session_meta(GAP)
    assert isinstance(native, NativeSessionIntervalSet)
    py = TIntervals(GAP)
    native.restore(snap)
    py.restore(snap)
    assert native.snapshot() == py.snapshot() == snap
    keys = rng.integers(0, 300, 400).astype(np.int64)
    ts = rng.integers(1500, 2600, 400).astype(np.int64)
    for plane in (native, py):
        plane.absorb_batch(keys, ts)
    assert native.snapshot() == py.snapshot()
    for a, b in zip(native.pop_fired(1 << 40), py.pop_fired(1 << 40)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
