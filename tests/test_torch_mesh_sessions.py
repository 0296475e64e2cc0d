"""The port's mesh session engine (``flink_tpu_torch/parallel/
sharded_sessions.py``) against the reference's (``flink_tpu/parallel/
sharded_sessions.py``) on the CPU: the reference on the 8 virtual devices
of ``tests/conftest.py``, the port on an 8-shard logical mesh.

- ``build_session_merge_step``, ``build_delta_fire_step`` and the gather
  and put steps of ``build_mesh_steps``: the same planes and slot blocks
  through both packages' programs — random ``[8, M]`` merge blocks with
  repeated destinations, NaN payloads, +-inf and signed zeros for float32
  Sum/Max/Min, float64 Sum and Count.
- The native plane's mesh sweeps (``shard_group``, ``rec_shard_max``,
  ``route_records``) against the reference's native sweeps and against
  the engine's NumPy forms (the Python plane's path).
- ``MeshSessionEngine``: the in-scope cases of ``tests/test_mesh_sessions.py``
  (oracle and single device, cross-batch merge, many shards at high
  cardinality, the P=8 job through ``env.execute``), late records with a
  NaN in the port's slot 0 before every call, the Python metadata plane,
  a mid-run ``NativePlaneError`` that hands over to the Python plane, and
  each unported feature raising and naming a ROADMAP item that exists.
- ``benchmarks/mesh_sessions.py``'s loop at 1M records against the NumPy
  oracle of ``chip_smoke.py`` phase 13(a).

Every engine comparison drives both packages with the same batches and
watermarks and holds the fired batches equal IN ORDER, every column bit
for bit, with the deadline split off — except
``test_p8_job_with_fire_deadline_matches_reference_as_multiset``: the
deadline split sizes its chunks from a measured rate, so two runs split
differently, and that test compares ``(key, start, end, value bits)`` as
multisets. Against the brute-force oracle float sums are compared with
relative tolerance 1e-4, as the reference's tests do (the oracle adds in
another order).
"""

import collections
import pathlib
import re

import numpy as np
import pytest
import torch

from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.parallel.sharded_sessions import (
    MeshSessionEngine as JEngine,
    build_session_merge_step as jbuild_merge,
)
from flink_tpu.parallel.sharded_windower import (
    build_delta_fire_step as jbuild_delta_fire,
    build_mesh_steps as jbuild_mesh_steps,
)
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing.session_meta import (
    SessionIntervalSet as JSessionIntervalSet,
)
from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import (
    MeshSessionEngine,
    build_session_merge_step,
    route_records_plain,
)
from flink_tpu_torch.parallel.sharded_windower import (
    build_delta_fire_step,
    build_mesh_steps,
)
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing.session_meta import (
    NativePlaneError,
    SessionIntervalSet,
)

P = 8
_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def assert_batches_equal(got, want):
    """Fired batches equal in order, every column bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g.names()) == sorted(w.names())
        for name in w.names():
            a, b = np.asarray(g[name]), np.asarray(w[name])
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


#: NaN payloads (signalling, quiet, negative), +-1, +-0 and +-inf
_SPECIAL = {
    np.float32: np.array([0x7fa00001, 0x7fc00002, 0xffc00003, 0xffa00004,
                          0x3f800000, 0xbf800000, 0, 0x80000000,
                          0x7f800000, 0xff800000], np.uint32),
    np.float64: np.array([0x7ff4000000000001, 0x7ff8000000000002,
                          0xfff8000000000003, 0xfff4000000000004,
                          0x3ff0000000000000, 0xbff0000000000000, 0,
                          0x8000000000000000, 0x7ff0000000000000,
                          0xfff0000000000000], np.uint64),
}

AGGS = {
    "count": (jagg.CountAggregate, tagg.CountAggregate, {}),
    "sum_f32": (jagg.SumAggregate, tagg.SumAggregate, {}),
    "sum_f64": (jagg.SumAggregate, tagg.SumAggregate,
                {"dtype": np.float64}),
    "max_f32": (jagg.MaxAggregate, tagg.MaxAggregate, {}),
    "min_f32": (jagg.MinAggregate, tagg.MinAggregate, {}),
    "avg_f32": (jagg.AvgAggregate, tagg.AvgAggregate, {}),
}


def _aggs(kind):
    jmake, tmake, kw = AGGS[kind]
    args = () if kind == "count" else ("v",)
    return jmake(*args, **kw), tmake(*args, **kw)


def _planes(leaves, rng, cap):
    """One ``[P, cap]`` plane per leaf: wide-range values with NaN
    payloads and infinities for sums, only specials for max/min, slot 0
    the identity."""
    planes = []
    for leaf in leaves:
        dt = np.dtype(leaf.dtype)
        if dt.kind != "f":
            p = rng.integers(0, 1000, (P, cap)).astype(dt)
        elif leaf.reduce == "sum":
            p = (rng.standard_normal((P, cap))
                 * np.exp(rng.uniform(-8, 8, (P, cap)))).astype(dt)
            sp = rng.random((P, cap)) < 0.05
            p[sp] = rng.choice(_SPECIAL[dt.type], int(sp.sum())).view(dt)
        else:
            p = rng.choice(_SPECIAL[dt.type], (P, cap)).view(dt)
        p[:, 0] = leaf.identity
        planes.append(p)
    return planes


def _jax_run(mesh, fn, planes, *blocks, x64=False):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from flink_tpu.parallel.mesh import KEY_AXIS

    sh = NamedSharding(mesh, PartitionSpec(KEY_AXIS))
    with jax.enable_x64(x64):
        out = fn(tuple(jax.device_put(p, sh) for p in planes),
                 *(jax.device_put(b, sh) for b in blocks))
        return jax.device_get(out)


def _merge_blocks(rng, cap, M):
    """A chain-free merge group per shard: a varying number of pairs
    (some shards none), many sharing a destination, padded with 0/0."""
    dst = np.zeros((P, M), np.int32)
    src = np.zeros((P, M), np.int32)
    for p in range(P):
        n = int(rng.integers(0, M + 1)) if p else M
        slots = rng.permutation(np.arange(1, cap))
        pool = slots[: max(n // 7, 1)]
        dst[p, :n] = rng.choice(pool, n)
        src[p, :n] = slots[cap // 2: cap // 2 + n]
    return dst, src


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind",
                         ["count", "sum_f32", "sum_f64", "max_f32",
                          "min_f32"])
def test_session_merge_step_matches_reference(kind, seed,
                                              eight_device_mesh):
    rng = np.random.default_rng(seed)
    ja, ta = _aggs(kind)
    cap, M = 2048, 512
    planes = _planes(ja.leaves, rng, cap)
    dst, src = _merge_blocks(rng, cap, M)
    x64 = any(np.dtype(p.dtype).itemsize == 8 for p in planes)
    want = _jax_run(eight_device_mesh, jbuild_merge(eight_device_mesh, ja),
                    planes, dst, src, x64=x64)
    got = build_session_merge_step(make_mesh(P, "cpu"), ta)(
        tuple(torch.from_numpy(p.copy()) for p in planes),
        torch.from_numpy(dst), torch.from_numpy(src))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind", ["count", "sum_f32", "max_f32", "avg_f32"])
def test_delta_fire_step_matches_reference(kind, k, eight_device_mesh):
    """Fired columns and the planes after the reset, bit for bit, with
    padded lanes at slot 0 (their outputs are the caller's to cut)."""
    rng = np.random.default_rng(3)
    ja, ta = _aggs(kind)
    cap, W = 1024, 64
    planes = _planes(ja.leaves, rng, cap)
    sm = rng.integers(1, cap, (P, W, k)).astype(np.int32)
    rs = np.zeros((P, W), np.int32)
    for p in range(P):
        m = int(rng.integers(0, W))
        sm[p, m:] = 0
        rs[p, :m] = rng.permutation(np.arange(1, cap))[:m]
    want_accs, want_out = _jax_run(
        eight_device_mesh, jbuild_delta_fire(eight_device_mesh, ja),
        planes, sm, rs)
    got_accs, got_out = build_delta_fire_step(make_mesh(P, "cpu"), ta)(
        tuple(torch.from_numpy(p.copy()) for p in planes),
        torch.from_numpy(sm), torch.from_numpy(rs))
    assert sorted(got_out) == sorted(want_out)
    for name in want_out:
        np.testing.assert_array_equal(_bits(got_out[name].numpy()),
                                      _bits(want_out[name]), err_msg=name)
    for g, w in zip(got_accs, want_accs):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("kind", ["count", "sum_f32", "avg_f32"])
def test_gather_and_put_steps_match_reference(kind, eight_device_mesh):
    rng = np.random.default_rng(4)
    ja, ta = _aggs(kind)
    cap, G = 1024, 256
    planes = _planes(ja.leaves, rng, cap)
    slots = np.zeros((P, G), np.int32)
    for p in range(P):
        m = int(rng.integers(0, G))
        slots[p, :m] = rng.permutation(np.arange(1, cap))[:m]
    jsteps = jbuild_mesh_steps(eight_device_mesh, ja)
    tsteps = build_mesh_steps(make_mesh(P, "cpu"), ta)
    tplanes = tuple(torch.from_numpy(p.copy()) for p in planes)
    want = _jax_run(eight_device_mesh, jsteps[3], planes, slots)
    got = tsteps[3](tplanes, torch.from_numpy(slots))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    vals = [np.where(slots == 0, np.asarray(l.identity, dtype=l.dtype),
                     _planes([l], rng, G)[0]).astype(l.dtype)
            for l in ja.leaves]
    import jax

    put = jsteps[4]
    want = _jax_run(eight_device_mesh,
                    lambda accs, s, *v: put(accs, s, tuple(v)),
                    planes, slots, *vals)
    got = tsteps[4](tplanes, torch.from_numpy(slots),
                    tuple(torch.from_numpy(v) for v in vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(jax.device_get(w)))


# ------------------------------------------------------- the native sweeps

def _native_planes():
    from flink_tpu.windowing.session_native import (
        NativeSessionIntervalSet as JNative,
    )
    from flink_tpu_torch.native import load_sessions

    if load_sessions() is None:
        pytest.fail("the port's loader did not build native/sessions.cpp")
    from flink_tpu_torch.windowing.session_native import (
        NativeSessionIntervalSet,
    )

    return JNative(50), NativeSessionIntervalSet(50)


@pytest.mark.parametrize("kgr", [None, (16, 79)])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_sweeps_match_reference_and_numpy(seed, kgr):
    """shard_group, rec_shard_max and route_records of the port's native
    plane equal the reference's native sweeps, and the engine's NumPy
    forms (the Python plane's path), over absorbs with fresh, extended,
    merged and stale sessions."""
    from flink_tpu_torch.parallel.shuffle import shard_records

    jm, tm = _native_planes()
    rng = np.random.default_rng(seed)
    maxp = 128
    wm = 0
    for step in range(6):
        n = 3000
        keys = rng.integers(0, 400, n).astype(np.int64)
        if kgr is not None:
            from flink_tpu_torch.state.keygroups import assign_key_groups

            keys = keys[np.isin(assign_key_groups(keys, maxp),
                                np.arange(kgr[0], kgr[1] + 1))]
            n = len(keys)
        ts = (wm + rng.integers(-100, 300, n)).astype(np.int64)
        jr = jm.absorb_batch_ex(keys, ts)
        tr = tm.absorb_batch_ex(keys, ts)
        got = tm.shard_group(tr, P, maxp, kgr)
        want = jm.shard_group(jr, P, maxp, kgr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # the NumPy form of the grouping
        shard = shard_records(tr.sess_key, P, maxp, kgr)
        live = np.nonzero(tr.sess_sid >= 0)[0]
        sorted_idx = live[np.argsort(shard[live], kind="stable")]
        np.testing.assert_array_equal(got[0], shard)
        np.testing.assert_array_equal(
            got[1], np.bincount(shard[live], minlength=P))
        np.testing.assert_array_equal(got[2], sorted_idx)
        np.testing.assert_array_equal(got[3], tr.sess_key[sorted_idx])
        np.testing.assert_array_equal(got[4], tr.sess_sid[sorted_idx])
        np.testing.assert_array_equal(got[5], tr.fresh[sorted_idx])
        np.testing.assert_array_equal(got[6], tr.slot_hint[sorted_idx])
        np.testing.assert_array_equal(got[7], tr.meta_row[sorted_idx])
        assert tm.rec_shard_max(keys, P, maxp, kgr) == \
            jm.rec_shard_max(keys, P, maxp, kgr) == \
            int(np.bincount(shard_records(keys, P, maxp, kgr),
                            minlength=P).max())
        m = len(tr.sess_key)
        slot_sorted = rng.integers(1, 1 << 20, len(got[2])).astype(np.int32)
        args = (n, tr.order, tr.rec_to_sess, m, got[2], slot_sorted,
                got[0])
        t_route = tm.route_records(*args)
        j_route = jm.route_records(*args)
        p_route = route_records_plain(*args)
        for a, b, c in zip(t_route, j_route, p_route):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        wm += 150
        tm.pop_fired_ex(wm)
        jm.pop_fired_ex(wm)


def test_native_sweeps_refuse_keys_outside_the_range():
    _, tm = _native_planes()
    keys = np.arange(5000, dtype=np.int64)
    with pytest.raises(ValueError, match="routing bug"):
        tm.rec_shard_max(keys, P, 128, (0, 15))


# ------------------------------------------------------------- the engine

def _jbatch(keys, values, ts):
    return JRecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(values, dtype=np.float32)}, timestamps=ts)


def _tbatch(keys, values, ts):
    return RecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(values, dtype=np.float32)}, timestamps=ts)


class Pair:
    """The port's and the reference's MeshSessionEngine driven by the same
    calls; every fire compared in order, bit for bit, and (where asked)
    the spill counters after every call."""

    def __init__(self, mesh, gap, agg="sum", python_plane=False, **kw):
        make = {"sum": (lambda: jagg.SumAggregate("v"),
                        lambda: tagg.SumAggregate("v")),
                "count": (jagg.CountAggregate, tagg.CountAggregate),
                "max": (lambda: jagg.MaxAggregate("v"),
                        lambda: tagg.MaxAggregate("v"))}[agg]
        self.j = JEngine(gap, make[0](), mesh, **kw)
        self.t = MeshSessionEngine(gap, make[1](), make_mesh(P, "cpu"),
                                   **kw)
        if python_plane:
            self.j.meta = JSessionIntervalSet(gap, kw.get(
                "allowed_lateness", 0))
            self.t.meta = SessionIntervalSet(gap, kw.get(
                "allowed_lateness", 0))
        self.fired = []

    #: write a NaN into the port's reserved slot 0 before every call
    poison_slot0 = False

    def _poison(self):
        if self.poison_slot0:
            for a in self.t.accs:
                if a.dtype.is_floating_point:
                    a[:, 0] = float("nan")

    def process(self, keys, values, ts):
        self.j.process_batch(_jbatch(keys, values, ts))
        self._poison()
        self.t.process_batch(_tbatch(keys, values, ts))
        assert self.t.spill_counters() == self.j.spill_counters()

    def fire(self, wm):
        want = self.j.on_watermark(wm)
        self._poison()
        got = self.t.on_watermark(wm)
        assert_batches_equal(got, want)
        assert self.t.late_records_dropped == self.j.late_records_dropped
        assert self.t.spill_counters() == self.j.spill_counters()
        self.fired.extend(got)
        return got


def fired_to_dict(batches, field="sum_v"):
    out = {}
    for b in batches:
        for r in b.to_rows():
            out[(r[KEY_ID_FIELD], r["window_start"], r["window_end"])] = \
                r[field]
    return out


def oracle_sessions(events, gap):
    """events (key, value, ts) -> {(key, start, end): sum} after a flush."""
    by_key = collections.defaultdict(list)
    for k, v, t in events:
        by_key[k].append((t, v))
    out = {}
    for k, evs in by_key.items():
        evs.sort()
        cur = []
        for t, v in evs:
            if cur and t - cur[-1][0] > gap:
                out[(k, cur[0][0], cur[-1][0] + gap)] = sum(
                    x[1] for x in cur)
                cur = []
            cur.append((t, v))
        if cur:
            out[(k, cur[0][0], cur[-1][0] + gap)] = sum(x[1] for x in cur)
    return out


def random_events(n=6000, keys=300, seed=11, spread=40_000, skew=2000):
    """``tests/test_mesh_sessions.py``'s stream: roughly in time order,
    each timestamp jittered back by up to ``skew``."""
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, keys, n)
    base = np.sort(rng.integers(0, spread, n))
    ts = np.maximum(base - rng.integers(0, skew, n), 0)
    vs = rng.random(n).astype(np.float32) * 5
    return list(zip(ks.tolist(), vs.tolist(), ts.tolist()))


def drive(pair, events, batch_size=500, wm_every=4):
    """Feed events in arrival order with watermarks lagging 5 s, then a
    final flush (as ``tests/test_mesh_sessions.py`` feeds its engines)."""
    max_ts = 0
    for i in range(0, len(events), batch_size):
        chunk = events[i:i + batch_size]
        ts = [e[2] for e in chunk]
        pair.process([e[0] for e in chunk], [e[1] for e in chunk], ts)
        max_ts = max([max_ts] + ts)
        if (i // batch_size) % wm_every == wm_every - 1:
            pair.fire(max_ts - 5000)
    pair.fire(1 << 60)
    return pair.fired


@pytest.mark.parametrize("python_plane", [False, True])
def test_matches_reference_and_oracle(python_plane, eight_device_mesh):
    gap = 100
    events = random_events()
    pair = Pair(eight_device_mesh, gap, capacity_per_shard=4096,
                python_plane=python_plane)
    fired = fired_to_dict(drive(pair, events))
    oracle = oracle_sessions(events, gap)
    assert set(fired) == set(oracle)
    for k, want in oracle.items():
        assert fired[k] == pytest.approx(want, rel=1e-4), k


def test_cross_batch_merge_on_mesh(eight_device_mesh):
    pair = Pair(eight_device_mesh, 100, capacity_per_shard=1024)
    # two separated sessions for one key, then a bridge record merges them
    pair.process([7, 7], [1.0, 2.0], [0, 180])
    pair.process([7], [4.0], [90])
    assert fired_to_dict(pair.fire(1 << 60)) == {(7, 0, 280): 7.0}
    assert pair.t.merge_groups == 1


def test_high_cardinality_many_shards(eight_device_mesh):
    n = 20_000
    pair = Pair(eight_device_mesh, 50, agg="count", capacity_per_shard=8192)
    pair.process(np.arange(n), np.ones(n, np.float32), np.zeros(n, np.int64))
    fired = pair.fire(1 << 60)
    assert int(sum(b["count"].sum() for b in fired)) == n


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("budget", [0, 1024])
def test_late_records_and_merges_match_reference(budget, poison,
                                                 eight_device_mesh):
    """Late records within the allowance start new sessions; beyond it
    they are dropped and their values fold into the reserved slot 0 (on
    the CPU; the card's fold drops them). With ``poison`` the port's slot
    0 holds a NaN before every batch and fire and the rows are still the
    reference's: nothing on the path reads slot 0 (a merge's and a fire's
    padded lanes and a reload's put reset it)."""
    rng = np.random.default_rng(11)
    pair = Pair(eight_device_mesh, 40, allowed_lateness=150,
                capacity_per_shard=1 << 12, max_device_slots=budget)
    pair.poison_slot0 = poison
    wm = 0
    for step in range(30):
        n = 6000
        keys = rng.integers(0, 50_000, n)
        vals = rng.standard_normal(n).astype(np.float32)
        ts = wm + rng.integers(-700, 300, n)
        pair.process(keys, vals, ts)
        wm += 120
        pair.fire(wm - 300)
    pair.fire(1 << 60)
    assert pair.t.late_records_dropped > 0
    assert pair.t.merge_groups > 0
    if budget:
        assert pair.t.spill_counters()["rows_evicted"] > 0


def test_native_plane_error_hands_over_to_python_plane(eight_device_mesh):
    """A NativePlaneError in the third absorb: both engines degrade to the
    Python plane (the live sessions carried over by snapshot) and re-run
    the batch; every fire stays equal, in order and bit for bit, to the
    reference's doing the same, and to a run that never degraded."""
    from flink_tpu_torch.native import native_fallbacks

    rng = np.random.default_rng(5)
    steps = []
    for s in range(8):
        n = 6000
        steps.append((rng.integers(0, 30_000, n),
                      rng.random(n).astype(np.float32),
                      s * 60 + rng.integers(-150, 100, n)))
    kw = dict(capacity_per_shard=1 << 12, max_device_slots=1024)
    pair = Pair(eight_device_mesh, 50, **kw)
    clean = Pair(eight_device_mesh, 50, **kw)

    def fail_once(meta):
        orig = meta.absorb_batch_ex
        calls = [0]

        def absorb(*a, **k):
            calls[0] += 1
            if calls[0] == 3:
                raise NativePlaneError("injected sweep failure")
            return orig(*a, **k)
        return absorb

    from flink_tpu.windowing.session_meta import (
        NativePlaneError as JNativePlaneError,
    )

    pair.t.meta.absorb_batch_ex = fail_once(pair.t.meta)
    jorig = pair.j.meta.absorb_batch_ex
    jcalls = [0]

    def jabsorb(*a, **k):
        jcalls[0] += 1
        if jcalls[0] == 3:
            raise JNativePlaneError("injected sweep failure")
        return jorig(*a, **k)

    pair.j.meta.absorb_batch_ex = jabsorb
    before = native_fallbacks()
    with pytest.warns(RuntimeWarning, match="Python metadata plane"):
        for s, (k, v, t) in enumerate(steps):
            pair.process(k, v, t)
            clean.process(k, v, t)
            pair.fire(s * 60 - 400)
            clean.fire(s * 60 - 400)
    pair.fire(1 << 60)
    clean.fire(1 << 60)
    assert type(pair.t.meta) is SessionIntervalSet
    assert native_fallbacks() == before + 1
    assert pair.t.spill_counters()["rows_evicted"] > 0
    got = collections.Counter(
        (r[KEY_ID_FIELD], r["window_start"], r["window_end"],
         np.float32(r["sum_v"]).view(np.uint32).item())
        for b in pair.fired for r in b.to_rows())
    want = collections.Counter(
        (r[KEY_ID_FIELD], r["window_start"], r["window_end"],
         np.float32(r["sum_v"]).view(np.uint32).item())
        for b in clean.fired for r in b.to_rows())
    assert got == want


def test_device_errors_are_not_caught_as_plane_errors():
    eng = MeshSessionEngine(50, tagg.SumAggregate("v"), make_mesh(P, "cpu"))

    def boom(*a, **k):
        raise RuntimeError("device lost")

    eng.meta.absorb_batch_ex = boom
    with pytest.raises(RuntimeError, match="device lost"):
        eng.process_batch(_tbatch([1], [1.0], [0]))
    assert type(eng.meta) is not SessionIntervalSet


# ------------------------------------------------------------- public API

def _row5_job(pkg, records, keys, budget, batch, extra=None):
    """BASELINE row 5's job (tools/bench_suite.py:198-245) at
    ``parallelism.default: 8`` through ``pkg``'s public API, cut to
    ``records``/``keys``, with a per-shard budget."""
    if pkg == "ref":
        from flink_tpu import Configuration, StreamExecutionEnvironment
        from flink_tpu.connectors.sinks import CollectSink
        from flink_tpu.connectors.sources import DataGenSource as Src
        from flink_tpu.runtime.watermarks import WatermarkStrategy
        from flink_tpu.windowing.assigners import EventTimeSessionWindows
    else:
        from flink_tpu_torch import Configuration, StreamExecutionEnvironment
        from flink_tpu_torch.connectors.sinks import CollectSink
        from flink_tpu_torch.connectors.sources import DataGenSource as Src
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
        from flink_tpu_torch.windowing.assigners import (
            EventTimeSessionWindows,
        )
    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8,
        "execution.micro-batch.size": batch,
        "state.slot-table.capacity": budget,
        "state.slot-table.max-device-slots": budget,
        **(extra or {})}))
    sink = CollectSink()
    (env.from_source(Src(records, keys, 400_000, seed=3),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key").window(EventTimeSessionWindows.with_gap(2_000))
        .sum("value").sink_to(sink))
    env.execute("sessions")
    return sink


def test_p8_row5_job_matches_reference():
    """Row 5's job at P=8 with a 1<<10-row budget per shard (~8k live
    sessions against 8,192 rows in all: the paged tier evicts): the sink
    rows equal the reference's P=8 run, in order, bit for bit."""
    got = _row5_job("port", 150_000, 60_000, 1 << 10, 1 << 11,
                    {"execution.device": "cpu"})
    want = _row5_job("ref", 150_000, 60_000, 1 << 10, 1 << 11)
    assert len(got.batches) == len(want.batches)
    g, w = got.result(), want.result()
    assert len(w) > 50_000
    assert sorted(g.names()) == sorted(w.names())
    for name in w.names():
        np.testing.assert_array_equal(_bits(g[name]), _bits(w[name]),
                                      err_msg=name)


def test_p8_job_with_fire_deadline_matches_reference_as_multiset():
    """With ``latency.fire-deadline-ms`` the executor splits each batch
    at a measured rate (so two runs split differently) and advances the
    watermark between splits; the (key, start, end, value bits) multiset
    still equals the reference's under the same option."""
    extra = {"latency.fire-deadline-ms": 1}
    got = _row5_job("port", 60_000, 20_000, 1 << 10, 1 << 13,
                    {"execution.device": "cpu", **extra})
    want = _row5_job("ref", 60_000, 20_000, 1 << 10, 1 << 13, extra)

    def rows(sink):
        r = sink.result()
        return collections.Counter(zip(
            np.asarray(r["key"]).tolist(),
            np.asarray(r["window_start"]).tolist(),
            np.asarray(r["window_end"]).tolist(),
            _bits(np.asarray(r["sum_value"])).tolist()))

    g, w = rows(got), rows(want)
    assert sum(w.values()) > 10_000
    assert g == w


def test_session_job_public_api_matches_oracle():
    """``tests/test_mesh_sessions.py``'s public-API case: a ListSource of
    out-of-order events at parallelism 8 against the oracle."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import Source
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    gap = 100
    events = random_events(n=5000, keys=200, spread=20_000)

    class ListSource(Source):
        def open(self, subtask_index=0, parallelism=1):
            self.pos = 0

        def poll_batch(self, max_records):
            if self.pos >= len(events):
                return None
            chunk = events[self.pos:self.pos + max_records]
            self.pos += len(chunk)
            return RecordBatch.from_pydict(
                {"user": np.asarray([e[0] for e in chunk], np.int64),
                 "v": np.asarray([e[1] for e in chunk], np.float32)},
                timestamps=np.asarray([e[2] for e in chunk], np.int64))

    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": 512, "parallelism.default": 8,
        "state.slot-table.capacity": 4096, "execution.device": "cpu"}))
    sink = CollectSink()
    (env.from_source(ListSource(),
                     WatermarkStrategy.for_bounded_out_of_orderness(5000))
        .key_by("user").window(EventTimeSessionWindows.with_gap(gap))
        .sum("v").sink_to(sink))
    env.execute("mesh-sessions")
    got = {(r["user"], r["window_start"], r["window_end"]): r["sum_v"]
           for r in sink.rows()}
    oracle = oracle_sessions(events, gap)
    assert got.keys() == oracle.keys()
    for k, want in oracle.items():
        assert got[k] == pytest.approx(want, rel=1e-4), k


def test_p8_session_job_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        _row5_job("port", 10_000, 100, 1 << 10, 1 << 11)


# ------------------------------------------------------- not in this slice

_ROADMAP = (pathlib.Path(__file__).resolve().parent.parent
            / "ROADMAP.md").read_text()


def _item(exc) -> str:
    m = re.search(r"Queue A item (\w+)", str(exc.value))
    assert m, str(exc.value)
    assert f"**Item {m.group(1)} " in _ROADMAP, m.group(1)
    return m.group(1)


@pytest.mark.parametrize("kwargs,item", [
    ({"spill_layout": "namespaces", "shuffle_mode": "host"}, "12h"),
    ({"shuffle_mode": "host"}, "12h"),
    ({"host_topology": (2, 4)}, "12h"),
])
def test_unported_options_raise_naming_their_item(kwargs, item,
                                                  eight_device_mesh):
    """Item 12h is ported: host bucketing (``shuffle_mode="host"``) and the
    two-level exchange (a 2x4 ``host_topology``) fire as the reference's
    engine with the same option, every fire bit for bit, and as the
    port's flat device exchange."""
    import flink_tpu.parallel.mesh as jmesh
    import flink_tpu_torch.parallel.mesh as tmesh

    assert item == "12h"
    kw = dict(kwargs, capacity_per_shard=4096)
    topo = kw.pop("host_topology", None)
    pair = Pair(eight_device_mesh, 100, **kw)
    if topo is not None:
        pair.j = JEngine(100, jagg.SumAggregate("v"), eight_device_mesh,
                         host_topology=jmesh.HostTopology(*topo), **kw)
        pair.t = MeshSessionEngine(100, tagg.SumAggregate("v"),
                                   make_mesh(P, "cpu"),
                                   host_topology=tmesh.HostTopology(*topo),
                                   **kw)
    events = random_events(n=3000)
    fired = fired_to_dict(drive(pair, events))
    flat = Pair(eight_device_mesh, 100, capacity_per_shard=4096)
    assert fired == fired_to_dict(drive(flat, events))
    if topo is not None:
        traffic = pair.t.exchange2_traffic()
        assert traffic == pair.j.exchange2_traffic()
        assert traffic["rows_cross_host"] > 0


def test_managed_memory_reserves_like_the_reference():
    """``memory=(manager, owner)`` (ROADMAP item 12b, once raising): the
    engine reserves its ``[P, capacity]`` planes from the pool, the same
    bytes as the reference's engine, and a release returns them."""
    import jax

    from flink_tpu.core.memory import MemoryManager as JMemory
    from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
    from flink_tpu_torch.core.memory import MemoryManager

    jm, tm = JMemory(), MemoryManager()
    JEngine(50, jagg.SumAggregate("v"), jmake_mesh(P),
            capacity_per_shard=4096, memory=(jm, "s"))
    eng = MeshSessionEngine(50, tagg.SumAggregate("v"), make_mesh(P, "cpu"),
                            capacity_per_shard=4096, memory=(tm, "s"))
    assert tm.usage() == jm.usage()
    assert tm.reserved_bytes > 0
    eng.release_memory()
    assert tm.reserved_bytes == 0
    assert len(jax.devices()) >= P


@pytest.mark.parametrize("call,item", [
    (lambda e: e.register_hot_key(1), "12g"),
    (lambda e: e.query_sessions(1), "12e"),
    (lambda e: e.query_batch([1]), "12e"),
    (lambda e: e.arm_replica(), "12f"),
    (lambda e: e.reassign_key_groups(None), "12g"),
])
def test_unported_calls_raise_naming_their_item(call, item):
    eng = MeshSessionEngine(50, tagg.SumAggregate("v"), make_mesh(P, "cpu"),
                            max_device_slots=1024)
    if item == "12e":
        # item 12e is ported: the point queries answer as the
        # reference's (tests/test_torch_queries_mesh.py holds them at
        # size)
        from flink_tpu.parallel.mesh import make_mesh as jmake_mesh

        want = JEngine(50, jagg.SumAggregate("v"), jmake_mesh(P),
                       max_device_slots=1024)
        for e, mk in ((eng, _tbatch), (want, _jbatch)):
            e.process_batch(mk([1, 1, 2], [0.5, 0.25, 2.0], [10, 20, 30]))
        assert call(eng) == call(want)
        assert eng.query_batch([1, 2, 3]) == [{70: {"sum_v": 0.75}},
                                               {80: {"sum_v": 2.0}}, {}]
        return
    if item == "12f":
        # item 12f is ported: the replica's index and answers at the next
        # boundary equal the reference's (tests/test_torch_replica.py at
        # size)
        from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
        from flink_tpu.tenancy.replica import (
            SessionReplicaAdapter as JAdapter,
        )
        from flink_tpu_torch.tenancy.replica import SessionReplicaAdapter

        want = JEngine(50, jagg.SumAggregate("v"), jmake_mesh(P),
                       max_device_slots=1024)
        tp, jp = call(eng), call(want)
        for e, mk in ((eng, _tbatch), (want, _jbatch)):
            e.process_batch(mk([1, 1, 2], [0.5, 0.25, 2.0], [10, 20, 30]))
            e.on_watermark(0)
        ta, ja = SessionReplicaAdapter(tp, eng.agg), JAdapter(jp, want.agg)
        assert ta.lookup_batch([1, 2, 3]) == ja.lookup_batch([1, 2, 3]) == (
            [{70: {"sum_v": 0.75}}, {80: {"sum_v": 2.0}}, {}], 1)
        return
    if item == "12g":
        # item 12g is ported: both calls refuse these arguments exactly as
        # the reference's do (a float Sum split needs allow_inexact; a
        # rebalance needs a KeyGroupAssignment), and a permitted split
        # salts, folds and answers like the reference's
        # (tests/test_torch_skew.py at size)
        from flink_tpu.parallel.mesh import make_mesh as jmake_mesh

        want = JEngine(50, jagg.SumAggregate("v"), jmake_mesh(P),
                       max_device_slots=1024)
        errs = []
        for e in (eng, want):
            with pytest.raises((TypeError, ValueError)) as err:
                call(e)
            errs.append((type(err.value), str(err.value)))
        assert errs[0] == errs[1]
        for e, mk in ((eng, _tbatch), (want, _jbatch)):
            assert e.register_hot_key(1, allow_inexact=True) == 8
            for t0 in (10, 20, 200):
                e.process_batch(mk([1, 1, 2], [0.5, 0.25, 2.0],
                                   [t0, t0 + 5, t0]))
        assert eng.hot_key_stats() == want.hot_key_stats()
        assert eng.hot_key_stats()["salted_records"] == 6
        assert eng.query_batch([1, 2]) == want.query_batch([1, 2])
        assert_batches_equal(eng.on_watermark(1 << 40),
                             want.on_watermark(1 << 40))
        return
    with pytest.raises(NotImplementedError) as e:
        call(eng)
    assert _item(e) == item


def test_mesh_sessions_benchmark_loop_matches_oracle():
    """``benchmarks/mesh_sessions.py`` on the CPU, cut to 1M records
    (past the point where ~524k live sessions fill the 8 x 1<<16 rows, so
    the paged tier evicts, and fires read paged-out sessions): every fired
    (key, start, end, sum) equals the NumPy oracle of ``chip_smoke.py``
    phase 13(a), which places each ingest split's watermark from the
    loop's record of where splits began (the splits follow a measured
    rate). Exact: sums of ones."""
    import chip_smoke
    from flink_tpu_torch.benchmarks import mesh_sessions as ms

    records = 1_000_000
    r = ms.run(records, "cpu", collect=True)
    assert r["spill"]["rows_evicted"] > 0 and r["spill"]["rows_reloaded"] > 0
    assert r["late_records_dropped"] == 0
    batches = r["batches"]
    got = [np.concatenate([np.asarray(b[c]) for b in batches])
           for c in (KEY_ID_FIELD, "window_start", "window_end", "sum_v")]
    o = np.lexsort((got[1], got[0]))
    want = chip_smoke.mesh_oracle(records, r["split_starts"])
    assert r["sessions_fired"] == len(want[0]) > 900_000
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(_bits(g[o]), _bits(w))
