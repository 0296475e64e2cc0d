"""The retraction path of the port against the reference, on the CPU.

Every case feeds the same seeded NumPy inputs through ``flink_tpu`` and
``flink_tpu_torch`` and compares the changelogs batch by batch, in emission
order, every column bit for bit (INSERT, UPDATE_BEFORE/AFTER and DELETE
segments, in the reference's UB, DELETE, INSERT, UA order). The cases of
``tests/test_retraction.py`` are mirrored one for one (each also keeps the
reference test's own assertion), and the signed fold is held to the
reference's ``.at[].add`` on special values (+-0, +-inf, NaN payloads of
both signs) with retracting lanes.

Float64 and int64: the reference runs entirely inside
``jax.enable_x64(True)`` where a case folds float64 leaves (its operator,
slot table and programs are built inside the context, per test, so no
program compiled without x64 is reused). The port keeps float64/int64
whatever JAX does.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flink_tpu.core import records as jrec
from flink_tpu.runtime.group_agg import GroupAggOperator as JGroupAgg
from flink_tpu.state.slot_table import SlotTable as JSlotTable
from flink_tpu.windowing import aggregates as jagg

import torch

from flink_tpu_torch.convert import from_jax_group_agg
from flink_tpu_torch.core import records as trec
from flink_tpu_torch.runtime.group_agg import GroupAggOperator as TGroupAgg
from flink_tpu_torch.state.slot_table import SlotTable as TSlotTable
from flink_tpu_torch.stateplane.families import flat_scatter_signed
from flink_tpu_torch.windowing import aggregates as tagg

from tests.test_torch_mesh_sessions import _SPECIAL, _bits

INS, UB, UA, DEL = (trec.ROWKIND_INSERT, trec.ROWKIND_UPDATE_BEFORE,
                    trec.ROWKIND_UPDATE_AFTER, trec.ROWKIND_DELETE)
KIND = trec.ROWKIND_FIELD


def test_rowkind_constants_and_signs_match_the_reference():
    for name in ("ROWKIND_FIELD", "ROWKIND_INSERT", "ROWKIND_UPDATE_BEFORE",
                 "ROWKIND_UPDATE_AFTER", "ROWKIND_DELETE"):
        assert getattr(trec, name) == getattr(jrec, name)
    kinds = np.array([0, 1, 2, 3, 3, 0], np.int8)
    np.testing.assert_array_equal(trec.rowkind_signs(kinds),
                                  jrec.rowkind_signs(kinds))
    assert trec.rowkind_signs(kinds).dtype == np.int8
    b = trec.RecordBatch({"a": np.arange(3), KIND: np.zeros(3, np.int8)})
    assert b.row_kinds is b.columns[KIND]
    assert trec.RecordBatch({"a": np.arange(3)}).row_kinds is None


# ------------------------------------------------------------ the operator


class _JCtx:
    parallelism = 1
    max_parallelism = 128


class _TCtx(_JCtx):
    device = "cpu"


def _batch(mod, keys, vals=None, kinds=None, ts=0, vdtype=np.float32):
    cols = {
        "__key_id__": np.asarray(keys, dtype=np.int64),
        "k": np.asarray(keys, dtype=np.int64),
        "__ts__": np.full(len(keys), ts, dtype=np.int64),
    }
    if vals is not None:
        cols["v"] = np.asarray(vals, dtype=vdtype)
    if kinds is not None:
        cols[KIND] = np.asarray(kinds, dtype=np.int8)
    return mod.RecordBatch(cols)


def _drive(op, mod, steps):
    """Each step is ("b", kwargs of _batch) or ("w", watermark); returns
    the emitted batches of every step."""
    out = []
    for kind, arg in steps:
        if kind == "b":
            out.append(op.process_batch(_batch(mod, **arg)))
        else:
            out.append(op.process_watermark(arg))
    return out


def assert_changelog_equal(got, want, x64=False):
    """Per step: the same batches, columns, dtypes and bits. Under
    ``x64`` the reference's fire sums an int32 COUNT leaf into int64 (JAX
    promotes integer sums to its default int); the port keeps the leaf's
    int32, so there the values must be equal and the port's dtype int32."""
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert list(g.columns) == list(w.columns)
            for name in w.columns:
                a, b = np.asarray(g[name]), np.asarray(w[name])
                if x64 and a.dtype == np.int32 and b.dtype == np.int64:
                    b = b.astype(np.int32)
                    assert np.array_equal(b.astype(np.int64), w[name])
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=name)


def _pair(make, x64=False, **kw):
    """(reference operator, port operator), each opened; ``make(aggs)``
    builds the aggregate from a package's aggregates module."""
    with jax.enable_x64(x64):
        j = JGroupAgg(make(jagg), "k", **kw)
        j.open(_JCtx())
    t = TGroupAgg(make(tagg), "k", **kw)
    t.open(_TCtx())
    return j, t


def _run_both(make, steps, x64=False, **kw):
    j, t = _pair(make, x64=x64, **kw)
    with jax.enable_x64(x64):
        jout = _drive(j, jrec, steps)
    tout = _drive(t, trec, steps)
    assert_changelog_equal(tout, jout, x64=x64)
    return tout


def _kinds_counts(batches, col="count"):
    return [(r[KIND], r[col]) for b in batches for r in b.to_rows()]


_COUNT = lambda m: m.CountAggregate()  # noqa: E731

#: tests/test_retraction.py's operator cases: (aggregate, operator
#: options, steps, the reference test's expected (kind, count) per step)
OPERATOR_CASES = {
    "insert_then_update_pair": (
        _COUNT, {}, [("b", {"keys": [7]}), ("b", {"keys": [7]})],
        [[(INS, 1)], [(UB, 1), (UA, 2)]]),
    "delete_on_count_to_zero": (
        _COUNT, {}, [("b", {"keys": [5]}),
                     ("b", {"keys": [5], "kinds": [DEL]}),
                     ("b", {"keys": [5]})],
        [[(INS, 1)], [(DEL, 1)], [(INS, 1)]]),
    "upsert_mode_suppresses_update_before": (
        _COUNT, {"generate_update_before": False},
        [("b", {"keys": [1]}), ("b", {"keys": [1]})],
        [[(INS, 1)], [(UA, 2)]]),
    "minibatch_emits_net_change_per_watermark": (
        _COUNT, {"emit_on_watermark_only": True},
        [("b", {"keys": [3]}), ("b", {"keys": [3, 3]}), ("w", 100),
         ("b", {"keys": [3]}), ("w", 200)],
        [[], [], [(INS, 3)], [], [(UB, 3), (UA, 4)]]),
}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_operator_case_equals_reference(case):
    make, kw, steps, want = OPERATOR_CASES[case]
    out = _run_both(make, steps, **kw)
    assert [_kinds_counts(s) for s in out] == want


def test_retraction_input_folds_signed():
    def make(m):
        return m.MultiAggregate([m.SumAggregate("v", output="s"),
                                 m.CountAggregate(output="n")])

    out = _run_both(make, [
        ("b", {"keys": [1, 1], "vals": [10.0, 20.0]}),
        ("b", {"keys": [1, 1], "vals": [10.0, 15.0], "kinds": [UB, UA]})])
    ua = [r for r in out[1][0].to_rows() if r[KIND] == UA]
    assert len(ua) == 1 and ua[0]["s"] == 35.0 and ua[0]["n"] == 2


def test_non_retractable_agg_rejects_updates():
    j, t = _pair(lambda m: m.MaxAggregate("v"))
    for op, mod in ((j, jrec), (t, trec)):
        with pytest.raises(ValueError, match="retractable"):
            op.process_batch(_batch(mod, [1], vals=[5.0], kinds=[UB]))
    with pytest.raises(TypeError, match="not retractable"):
        tagg.MaxAggregate("v")._scatter_signed_jit
    assert tagg.SumAggregate("v").retractable
    assert not tagg.MultiAggregate([tagg.CountAggregate(),
                                    tagg.MinAggregate("v")]).retractable


@pytest.mark.parametrize("source", ["reference", "port"])
def test_changelog_state_survives_restore(source):
    """The reference test's restore, and the port restoring the
    reference's snapshot (through ``convert.from_jax_group_agg``)."""
    j, t = _pair(_COUNT)
    j.process_batch(_batch(jrec, [9]))
    t.process_batch(_batch(trec, [9]))
    snap = (from_jax_group_agg(j.snapshot_state()) if source == "reference"
            else t.snapshot_state())
    t2 = TGroupAgg(tagg.CountAggregate(), "k")
    t2.open(_TCtx())
    t2.restore_state(snap)
    out = t2.process_batch(_batch(trec, [9]))
    assert _kinds_counts(out) == [(UB, 1), (UA, 2)]


# ----------------------------------------------- seeded streams, both kinds


def _random_steps(seed, n_batches=6, n=24, keys=16, retract=True,
                  vdtype=np.float32):
    """A changelog input: each batch accumulates random rows; every other
    batch first retracts ALL live rows of two keys an earlier batch
    accumulated (so counts stay >= 0 and those keys DELETE), as
    UPDATE_BEFORE or DELETE rows."""
    rng = np.random.default_rng(seed)
    live = []
    steps = []
    for b in range(n_batches):
        k = rng.integers(0, keys, n)
        v = (rng.standard_normal(n) * 100).astype(vdtype)
        kinds = np.zeros(n, np.int8)
        if retract and live and b % 2:
            gone = rng.choice(sorted({kk for kk, _ in live}),
                              min(2, len(live)), replace=False)
            rows = [r for r in live if r[0] in gone][:n]
            tail = k[len(rows):]
            tail[np.isin(tail, gone)] = keys  # a key no retraction names
            for i, (kk, vv) in enumerate(rows):
                live.remove((kk, vv))
                k[i], v[i] = kk, vv
                kinds[i] = UB if i % 2 else DEL
        for i in range(n):
            if kinds[i] == INS:
                live.append((int(k[i]), v[i]))
        steps.append(("b", {"keys": k, "vals": v, "kinds": kinds,
                            "ts": 100 * b, "vdtype": vdtype}))
        if b % 3 == 2:
            steps.append(("w", 100 * b))
    return steps


def _sum_count_avg(dtype):
    return lambda m: m.MultiAggregate([
        m.SumAggregate("v", dtype=dtype, output="s"),
        m.CountAggregate(output="n"),
        m.AvgAggregate("v", output="a")])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", ["per-batch", "upsert", "minibatch"])
def test_seeded_changelog_equals_reference(dtype, mode):
    kw = {"upsert": {"generate_update_before": False},
          "minibatch": {"emit_on_watermark_only": True}}.get(mode, {})
    steps = _random_steps(11, vdtype=dtype)
    out = _run_both(_sum_count_avg(dtype), steps,
                    x64=dtype == np.float64, **kw)
    kinds = np.concatenate([b[KIND] for s in out for b in s])
    assert (kinds == DEL).any() and (kinds == INS).any()
    assert (kinds == UA).any() and ((kinds == UB).any() or mode == "upsert")
    s = [b["s"] for st in out for b in st]
    assert all(a.dtype == dtype for a in s)


def test_emission_segments_run_ub_delete_insert_ua():
    out = _run_both(_COUNT, [
        ("b", {"keys": [1, 2]}),
        ("b", {"keys": [3, 1, 2], "kinds": [INS, INS, DEL]})])
    assert list(out[1][0][KIND]) == [UB, DEL, INS, UA]
    assert list(out[1][0]["k"]) == [1, 2, 3, 1]


def test_string_keys_keep_their_first_seen_value():
    """Keys hashed from strings emit the value first seen for the id."""
    from flink_tpu.state.keygroups import hash_keys_to_i64 as jhash

    from flink_tpu_torch.state.keygroups import hash_keys_to_i64 as thash

    names = np.array(["b", "a", "b", "c"], dtype=object)
    assert np.array_equal(jhash(names), thash(names))
    j, t = _pair(_COUNT)
    outs = []
    for op, mod in ((j, jrec), (t, trec)):
        b = mod.RecordBatch({"__key_id__": thash(names), "k": names,
                             "__ts__": np.arange(4, dtype=np.int64)})
        outs.append(op.process_batch(b))
    assert_changelog_equal([outs[1]], [outs[0]])
    assert sorted(outs[1][0]["k"].tolist()) == ["a", "b", "c"]


def test_ttl_drops_idle_keys_and_reinserts():
    clocks = [[0], [0]]

    def mk(i):
        return lambda: clocks[i][0]

    with jax.enable_x64(False):
        j = JGroupAgg(jagg.CountAggregate(), "k", ttl_ms=100, clock=mk(0))
        j.open(_JCtx())
    t = TGroupAgg(tagg.CountAggregate(), "k", ttl_ms=100, clock=mk(1))
    t.open(_TCtx())
    outs = ([], [])
    for now, keys in ((0, [1, 2]), (50, [1]), (160, [1]), (180, [2]),
                      (400, [1, 3])):
        for i, (op, mod) in enumerate(((j, jrec), (t, trec))):
            clocks[i][0] = now
            outs[i].append(op.process_batch(_batch(mod, keys)))
    assert_changelog_equal(outs[1], outs[0])
    # key 2 (idle since 0) expired in the sweep at 160 and re-INSERTs
    assert _kinds_counts(outs[1][3]) == [(INS, 1)]
    assert t.table.num_used == j.table.num_used


@pytest.mark.parametrize("kind", ["full", "delta", "savepoint"])
def test_snapshots_equal_reference_and_restore_across(kind):
    make = _sum_count_avg(np.float32)
    steps = _random_steps(5, n_batches=4)
    j, t = _pair(make)
    _drive(j, jrec, steps[:3])
    _drive(t, trec, steps[:3])
    if kind == "delta":
        j.snapshot_state()
        t.snapshot_state()
        _drive(j, jrec, steps[3:4])
        _drive(t, trec, steps[3:4])
    fn = {"full": "snapshot_state", "delta": "snapshot_state_delta",
          "savepoint": "snapshot_state_savepoint"}[kind]
    js, ts = getattr(j, fn)(), getattr(t, fn)()
    for part in ("table", "changelog"):
        for name, a in js[part].items():
            if isinstance(a, dict):
                for n, x in a.items():
                    np.testing.assert_array_equal(
                        _bits(ts[part][name][n]), _bits(np.asarray(x)))
            else:
                np.testing.assert_array_equal(_bits(ts[part][name]),
                                              _bits(np.asarray(a)))
    assert ts["max_ts"] == js["max_ts"]


def test_restore_with_key_group_filter_equals_reference():
    from flink_tpu_torch.state.keygroups import assign_key_groups

    make = _sum_count_avg(np.float32)
    steps = _random_steps(9, n_batches=3, keys=40)
    j, _ = _pair(make)
    _drive(j, jrec, steps)
    snap = j.snapshot_state()
    groups = set(range(0, 128, 2))
    with jax.enable_x64(False):
        j2 = JGroupAgg(make(jagg), "k")
        j2.open(_JCtx())
        j2.restore_state(snap, key_group_filter=groups)
    t2 = TGroupAgg(make(tagg), "k")
    t2.open(_TCtx())
    t2.restore_state(from_jax_group_agg(snap), key_group_filter=groups)
    more = _random_steps(10, n_batches=2, keys=40, retract=False)
    jout = _drive(j2, jrec, more)
    tout = _drive(t2, trec, more)
    assert_changelog_equal(tout, jout)
    kept = set(assign_key_groups(t2.snapshot_state()["changelog"]["key_id"],
                                 128).tolist())
    assert kept <= groups | set(assign_key_groups(
        np.concatenate([s[1]["keys"] for s in more]).astype(np.int64),
        128).tolist())


@pytest.mark.parametrize("cut", [1, 3, 5])
def test_convert_restore_continues_the_reference_changelog(cut):
    """The reference folds ``cut`` batches and snapshots; the port restores
    that snapshot and folds the rest: its changelog equals the reference's
    uninterrupted run from there on."""
    make = _sum_count_avg(np.float64)
    steps = [s for s in _random_steps(21, n_batches=7, vdtype=np.float64)
             if s[0] == "b"]
    with jax.enable_x64(True):
        j = JGroupAgg(make(jagg), "k")
        j.open(_JCtx())
        jout = _drive(j, jrec, steps)
        j2 = JGroupAgg(make(jagg), "k")
        j2.open(_JCtx())
        _drive(j2, jrec, steps[:cut])
        snap = from_jax_group_agg(j2.snapshot_state())
    t = TGroupAgg(make(tagg), "k")
    t.open(_TCtx())
    t.restore_state(snap)
    tout = _drive(t, trec, steps[cut:])
    assert_changelog_equal(tout, jout[cut:], x64=True)


def test_convert_rejects_other_snapshots():
    with pytest.raises(KeyError, match="GroupAggOperator"):
        from_jax_group_agg({"timers": {}})


# ------------------------------------------------------- the signed fold


def _special_stream(dtype, n, seed):
    """Lanes of specials and normals with +-1 signs, some slots hit by
    both an accumulate and its retraction."""
    rng = np.random.default_rng(seed)
    u = np.uint32 if dtype == np.float32 else np.uint64
    special = _SPECIAL[dtype].view(dtype)
    vals = np.where(rng.random(n) < 0.3,
                    special[rng.integers(0, len(special), n)],
                    (rng.standard_normal(n) * 7).astype(dtype)).astype(dtype)
    vals[::7] = dtype(0.0)
    signs = np.where(rng.random(n) < 0.4, -1, 1).astype(np.int8)
    signed = vals * signs.astype(dtype)
    assert signed.view(u).dtype == u
    return signed


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_scatter_signed_specials_equal_reference(dtype, seed):
    """``flat_scatter_signed`` over NaN payloads of both signs, +-inf,
    +-0 and retracting lanes: the reference's ``.at[].add`` bit for bit
    (and the int leaf of a COUNT exact)."""
    from flink_tpu.stateplane.families import (
        flat_scatter_signed as jscatter_signed,
    )

    n, cap = 700, 64
    rng = np.random.default_rng(100 + seed)
    slots = rng.integers(1, cap, n).astype(np.int32)
    slots[-9:] = 0  # pad lanes of 0 into the reserved slot
    vals = _special_stream(dtype, n, seed)
    vals[-9:] = 0
    counts = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int32)
    counts[-9:] = 0
    leaves = (jagg.AccLeaf("s", dtype, "sum"),
              jagg.AccLeaf("n", np.int32, "sum"))
    tleaves = (tagg.AccLeaf("s", dtype, "sum"),
               tagg.AccLeaf("n", np.int32, "sum"))
    acc0 = np.zeros(cap, dtype)
    acc0[5] = dtype(-0.0)
    with jax.enable_x64(dtype == np.float64):
        ref = jscatter_signed(leaves)(
            (jnp.asarray(acc0), jnp.zeros(cap, jnp.int32)),
            jnp.asarray(slots), (jnp.asarray(vals), jnp.asarray(counts)))
        ref = [np.asarray(a) for a in ref]
    got = flat_scatter_signed(tleaves)(
        (torch.from_numpy(acc0.copy()), torch.zeros(cap, dtype=torch.int32)),
        torch.from_numpy(slots), (torch.from_numpy(vals),
                                  torch.from_numpy(counts)))
    for g, r in zip(got, ref):
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
    assert np.isnan(ref[0]).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slot_table_scatter_signed_equals_reference(dtype):
    """``SlotTable.scatter_signed`` (sticky bucket, pads of 0 at slot 0,
    H2D, the signed fold) against the reference's table, snapshot rows
    bit for bit."""
    make = lambda m: m.MultiAggregate([  # noqa: E731
        m.SumAggregate("v", dtype=dtype), m.CountAggregate()])
    rng = np.random.default_rng(3)
    with jax.enable_x64(dtype == np.float64):
        jt = JSlotTable(make(jagg), capacity=1024)
    tt = TSlotTable(make(tagg), capacity=1024, device="cpu")
    for n in (50, 200, 37, 180):
        keys = rng.integers(0, 300, n).astype(np.int64)
        ns = np.zeros(n, np.int64)
        signs = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int8)
        vals = (_special_stream(dtype, n, n) if n == 37
                else (rng.standard_normal(n) * 3).astype(dtype))
        vals = vals * signs.astype(dtype)
        cnt = signs.astype(np.int32)
        with jax.enable_x64(dtype == np.float64):
            jt.scatter_signed(jt.lookup_or_insert(keys, ns), (vals, cnt))
        tt.scatter_signed(tt.lookup_or_insert(keys, ns), (vals, cnt))
    assert tt._scatter_bucket == jt._scatter_bucket
    with jax.enable_x64(dtype == np.float64):
        js = jt.snapshot()
    ts = tt.snapshot()
    for name in js:
        np.testing.assert_array_equal(_bits(ts[name]),
                                      _bits(np.asarray(js[name])),
                                      err_msg=name)


def test_map_input_signed_flips_zero_and_keeps_nan_sign():
    """``map_input_signed`` multiplies by the sign: +0 retracts as -0, and
    the product of a NaN with -1 is the host's (x86: the operand)."""
    v = np.array([0.0, 1.5, np.inf], np.float32)
    v = np.concatenate([v, _SPECIAL[np.float32][:4].view(np.float32)])
    signs = np.array([-1, -1, -1, -1, -1, 1, 1], np.int8)
    cols = {"v": v, "__ts__": np.zeros(len(v), np.int64)}
    agg_t = tagg.MultiAggregate([tagg.SumAggregate("v"),
                                 tagg.CountAggregate()])
    agg_j = jagg.MultiAggregate([jagg.SumAggregate("v"),
                                 jagg.CountAggregate()])
    got = agg_t.map_input_signed(trec.RecordBatch(cols), signs)
    want = agg_j.map_input_signed(jrec.RecordBatch(cols), signs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert np.signbit(got[0][0])
    assert list(got[1]) == [-1, -1, -1, -1, -1, 1, 1]


# ------------------------------------------------ KeyedStream aggregates


def _keyed_job(pkg, method, rows):
    if pkg == "reference":
        from flink_tpu import Configuration, StreamExecutionEnvironment
        cfg = {"execution.micro-batch.size": 5}
    else:
        from flink_tpu_torch import Configuration, StreamExecutionEnvironment
        cfg = {"execution.micro-batch.size": 5, "execution.device": "cpu"}
    env = StreamExecutionEnvironment(Configuration(cfg))
    keyed = env.from_collection(rows, timestamp_field="ts").key_by("k")
    if method == "reduce":
        agg = (jagg if pkg == "reference" else tagg).MultiAggregate([
            (jagg if pkg == "reference" else tagg).SumAggregate("value"),
            (jagg if pkg == "reference" else tagg).CountAggregate()])
        stream = keyed.reduce(agg)
    else:
        stream = getattr(keyed, method)("value")
    return stream.execute_and_collect()


@pytest.mark.parametrize("method", ["sum", "max", "min", "reduce"])
def test_keyed_stream_running_aggregates_equal_reference(method):
    rng = np.random.default_rng(4)
    rows = [{"k": int(k), "value": float(v), "ts": 10 * i}
            for i, (k, v) in enumerate(zip(rng.integers(0, 6, 37),
                                           rng.standard_normal(37)))]
    want = _keyed_job("reference", method, rows)
    got = _keyed_job("port", method, rows)
    assert_changelog_equal([[got]], [[want]])
    assert (got[KIND] == UA).any()
