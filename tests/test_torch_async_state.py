"""Async keyed state of the port against the reference's on the CPU: every
case of ``tests/test_async_state.py`` (ordering, coalescing, futures, map
state, the device value state, the operator's drains), each run on both
packages with the port's ``DeviceValueState`` on ``device="cpu"``; the
results and the controller's ``stats`` are equal (tolerance: none). Added:
the stream-ordered put at 200,000 lanes into 1,000 slots against the
reference's ``.at[].set`` and NumPy's ``a[s] = x`` bit for bit, and the
clamped gather at negative and too-large slots against ``jnp.take(...,
mode="clip")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.core.records import KEY_ID_FIELD as JK
from flink_tpu.core.records import TIMESTAMP_FIELD as JT
from flink_tpu.core.records import RecordBatch as JBatch
from flink_tpu.runtime import process as jproc
from flink_tpu.state import async_state as jas
from flink_tpu.state import keyed_state as jks
from flink_tpu.state import ttl as jttl
from flink_tpu_torch.core.records import RecordBatch as TBatch
from flink_tpu_torch.runtime import process as tproc
from flink_tpu_torch.runtime.operators import OperatorContext
from flink_tpu_torch.state import async_state as tas
from flink_tpu_torch.state import keyed_state as tks
from flink_tpu_torch.state import ttl as tttl

PKGS = {
    "ref": dict(asy=jas, ks=jks, ttl=jttl, proc=jproc, Batch=JBatch,
                store=lambda cap: jks.KeyedStateStore(cap), ctx=None),
    "port": dict(asy=tas, ks=tks, ttl=tttl, proc=tproc, Batch=TBatch,
                 store=lambda cap: tks.KeyedStateStore(cap, device="cpu"),
                 ctx=OperatorContext(device="cpu")),
}


def _both(scenario):
    got = {name: scenario(p) for name, p in PKGS.items()}
    assert _plain(got["port"]) == _plain(got["ref"])
    return got["port"]


def _plain(x):
    """Futures' results as lists (NumPy or device arrays of either
    package) for comparison."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "tolist"):
        return np.asarray(x).tolist()
    return x


def _aec_and_state(p, desc=None):
    aec = p["asy"].AsyncExecutionController()
    store = p["store"](64)
    desc = desc or p["ks"].ValueStateDescriptor("v", np.int64, 0)
    return aec, p["asy"].make_async_view(aec, store.get_state(desc)), store


# -- ordering ---------------------------------------------------------------


def test_same_key_ops_serialize_in_submission_order():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        st.put([1], 5)
        f1 = st.get([1])
        st.put([1], 7)
        f2 = st.get([1])
        return f1.value(), f2.value(), aec.stats

    v1, v2, stats = _both(s)
    assert v1 == [5] and v2 == [7] and stats["waves"] == 4


def test_read_before_write_sees_old_value():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        st.put([3], 10)
        aec.drain()
        f_old = st.get([3])
        st.put([3], 20)
        f_new = st.get([3])
        return f_old.value(), f_new.value()

    assert _plain(_both(s)) == [[10], [20]]


def test_cross_key_gets_coalesce_into_one_kernel():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        futs = [st.get([k, k + 100]) for k in range(10)]
        aec.drain()
        return aec.stats, [f.value() for f in futs]

    stats, vals = _both(s)
    assert stats == {"ops": 10, "waves": 1, "kernel_calls": 1}
    assert _plain(vals) == [[0, 0]] * 10


def test_cross_key_puts_coalesce_then_gets_read_them():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        for k in range(8):
            st.put([k], k * 11)
        futs = [st.get([k]) for k in range(8)]
        aec.drain()
        return aec.stats, [int(f.value()[0]) for f in futs]

    stats, vals = _both(s)
    assert stats["waves"] == 2 and stats["kernel_calls"] == 2
    assert vals == [k * 11 for k in range(8)]


def test_same_kind_writes_to_same_key_merge_last_wins():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        st.put([5], 1)
        st.put([5], 2)
        return st.get([5]).value(), aec.stats["waves"]

    v, waves = _both(s)
    assert _plain(v) == [2] and waves == 2


def test_reducing_adds_accumulate_across_coalesced_ops():
    def s(p):
        desc = p["ks"].ReducingStateDescriptor("r", np.add, np.int64, 0)
        aec, st, _ = _aec_and_state(p, desc)
        for _ in range(5):
            st.add([7], 3)
        return st.get([7]).value(), aec.stats["waves"]

    v, waves = _both(s)
    assert _plain(v) == [15] and waves == 2


def test_put_then_add_same_key_do_not_commute_so_split_waves():
    def s(p):
        desc = p["ks"].ReducingStateDescriptor("r", np.add, np.int64, 0)
        aec, st, _ = _aec_and_state(p, desc)
        st.put([2], 100)
        st.add([2], 1)
        return st.get([2]).value(), aec.stats["waves"]

    v, waves = _both(s)
    assert _plain(v) == [101] and waves >= 3


# -- futures ----------------------------------------------------------------


def test_value_forces_drain_lazily():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        f = st.get([1])
        before = (f.done, aec.pending)
        return before, f.value(), (f.done, aec.pending)

    before, v, after = _both(s)
    assert before == (False, 1) and _plain(v) == [0] and after == (True, 0)


def test_then_chains_and_may_submit_more_ops():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        st.put([1], 41)
        st.get([1]).then(lambda v: st.put([2], int(v[0]) + 1))
        aec.drain()
        return st.get([2]).value()

    assert _plain(_both(s)) == [42]


def test_then_on_done_future_runs_immediately():
    def s(p):
        aec, st, _ = _aec_and_state(p)
        f = st.get([1])
        aec.drain()
        seen = []
        f.then(lambda v: seen.append(int(v[0])))
        return seen

    assert _both(s) == [0]


# -- map state --------------------------------------------------------------


def test_async_map_state_orders_and_reads():
    def s(p):
        aec = p["asy"].AsyncExecutionController()
        st = p["asy"].make_async_view(
            aec, p["store"](64).get_state(p["ks"].MapStateDescriptor("m")))
        st.put([1, 2], ["a", "a"], [10, 20])
        return st.get([1, 2, 3], ["a", "a", "a"], default=-1).value()

    assert _both(s) == [10, 20, -1]


def test_list_state_has_no_async_view():
    for p in PKGS.values():
        st = p["store"](64).get_state(p["ks"].ListStateDescriptor("l"))
        with pytest.raises(TypeError, match="ListState stays sync"):
            p["asy"].make_async_view(p["asy"].AsyncExecutionController(), st)


# -- equality: async == sync on a random op sequence ------------------------


@pytest.mark.parametrize("device_state", [False, True])
def test_async_matches_sync_on_random_sequence(device_state):
    def s(p):
        rng = np.random.default_rng(7)
        aec = p["asy"].AsyncExecutionController()
        store_a, store_s = p["store"](256), p["store"](256)
        cls = (p["asy"].DeviceValueStateDescriptor if device_state
               else p["ks"].ValueStateDescriptor)
        desc = cls("v", np.float32, 0.0)
        a = p["asy"].make_async_view(aec, store_a.get_state(desc))
        sy = store_s.get_state(desc)
        futs = []
        for _ in range(200):
            keys = rng.integers(0, 30, size=rng.integers(1, 6))
            if rng.random() < 0.5:
                vals = rng.normal(size=len(keys)).astype(np.float32)
                a.put(keys, vals)
                sy.put(keys, vals)
            else:
                futs.append((a.get(keys), np.asarray(sy.get(keys)).copy()))
        aec.drain()
        for fa, expect in futs:
            np.testing.assert_array_equal(fa.value(), expect)
        return [f.value() for f, _ in futs], aec.stats

    _both(s)


# -- device path ------------------------------------------------------------


def test_device_value_state_matches_host_and_defers_transfer():
    def s(p):
        aec = p["asy"].AsyncExecutionController()
        store = p["store"](128)
        dd = p["asy"].DeviceValueStateDescriptor("dv", np.float32, 0.0)
        dv = p["asy"].make_async_view(aec, store.get_state(dd))
        assert isinstance(store.get_state(dd), p["asy"].DeviceValueState)
        dv.put(np.arange(16), np.arange(16, dtype=np.float32) * 2)
        f = dv.get(np.arange(16))
        aec.drain()
        assert f.done
        return f.value()

    v = _both(s)
    np.testing.assert_array_equal(v, np.arange(16) * 2.0)
    assert v.dtype == np.float32


def test_port_device_gather_stays_a_tensor_until_value():
    aec = tas.AsyncExecutionController()
    store = tks.KeyedStateStore(128, device="cpu")
    st = store.get_state(tas.DeviceValueStateDescriptor("dv", np.int64, 3))
    assert st._dvals.device.type == "cpu" and st._dvals.dtype == torch.int64
    f = tas.make_async_view(aec, st).get(np.arange(4))
    aec.drain()
    assert isinstance(f._value, torch.Tensor)
    assert f.value().tolist() == [3, 3, 3, 3] and isinstance(f._value,
                                                            np.ndarray)


def test_device_state_checkpoint_restore_roundtrip():
    def s(p):
        store = p["store"](64)
        dd = p["asy"].DeviceValueStateDescriptor("dv", np.int64, 0)
        store.get_state(dd).put(np.array([3, 5, 9]), np.array([30, 50, 90]))
        snap = store.snapshot()
        store2 = p["store"](64)
        store2.restore(snap)
        st2 = store2.get_state(dd)
        assert isinstance(st2, p["asy"].DeviceValueState)
        return st2.get(np.array([3, 5, 9])), snap["keys"], snap["slots"]

    assert _plain(_both(s))[0] == [30, 50, 90]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_device_state_snapshot_restores_across_packages(writer, reader):
    w, r = PKGS[writer], PKGS[reader]
    store = w["store"](64)
    vals = np.random.default_rng(1).normal(size=40).astype(np.float32)
    store.get_state(w["asy"].DeviceValueStateDescriptor(
        "dv", np.float32, 0.0)).put(np.arange(40) * 7, vals)
    store2 = r["store"](8)
    store2.restore(store.snapshot())
    got = store2.get_state(r["asy"].DeviceValueStateDescriptor(
        "dv", np.float32, 0.0)).get(np.arange(40) * 7)
    np.testing.assert_array_equal(np.asarray(got).view(np.uint32),
                                  vals.view(np.uint32))


def test_device_state_grows_with_index():
    def s(p):
        store = p["store"](8)
        st = store.get_state(p["asy"].DeviceValueStateDescriptor(
            "dv", np.int64, -1))
        keys = np.arange(100)
        st.put(keys, keys * 3)
        return st.get(keys)

    np.testing.assert_array_equal(_both(s), np.arange(100) * 3)


def test_device_state_put_that_grows_the_index_keeps_every_write():
    """A put whose keys grow the slot index (1024 -> 4096 slots) keeps
    every write and the grown array, as the reference's host ValueState
    does. The reference's DeviceValueState does not (ROADMAP Queue C R6:
    its put reads the old array before the lookup that grows it, so the
    writes past the old capacity are dropped and the growth undone); the
    port is held to the host state here."""
    keys = np.arange(3000)
    want_store = jks.KeyedStateStore(8)
    want = want_store.get_state(jks.ValueStateDescriptor("v", np.int64, -1))
    want.put(keys, keys * 3)
    store = tks.KeyedStateStore(8, device="cpu")
    st = store.get_state(tas.DeviceValueStateDescriptor("dv", np.int64, -1))
    st.put(keys, keys * 3)
    np.testing.assert_array_equal(st.get(keys), want.get(keys))
    assert st.get(np.array([5000])).tolist() == \
        want.get(np.array([5000])).tolist() == [-1]
    assert store.capacity == want_store.capacity == len(st._dvals) == 4096
    ref_store = jks.KeyedStateStore(8)
    ref = ref_store.get_state(jas.DeviceValueStateDescriptor(
        "dv", np.float32, -1.0))
    ref.put(keys, (keys * 3).astype(np.float32))
    assert not np.array_equal(ref.get(keys), keys * 3)  # R6


def test_device_state_rejects_ttl():
    for p in PKGS.values():
        store = p["store"](8)
        dd = p["asy"].DeviceValueStateDescriptor(
            "dv", np.int64, 0, ttl=p["ttl"].StateTtlConfig(1000))
        with pytest.raises(ValueError, match="TTL"):
            store.get_state(dd)


def test_device_state_default_device_is_the_card():
    """Without a device the store's DeviceValueState asks for
    execution.device's default, the card, and never falls back."""
    store = tks.KeyedStateStore(8)
    assert store.device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            store.get_state(tas.DeviceValueStateDescriptor("dv"))


# -- the stream-ordered put and the clamped gather --------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_put_with_duplicates_is_last_wins_like_at_set(dtype):
    """200,000 lanes into 1,000 slots: the port's put equals JAX's
    ``.at[].set`` (the reference's scatter) and NumPy's ``a[s] = x``, bit
    for bit, through the state and through ``put_last_wins`` alone."""
    rng = np.random.default_rng(11)
    s = rng.integers(0, 1000, 200_000)
    x = (rng.normal(size=200_000) * 1000).astype(dtype)
    base = np.full(1000, 7, dtype=dtype)
    want = base.copy()
    want[s] = x
    ref = np.asarray(jnp.asarray(base).at[jnp.asarray(s)].set(
        jnp.asarray(x)))
    np.testing.assert_array_equal(ref.view(np.uint32), want.view(np.uint32))
    t = torch.from_numpy(base.copy())
    tas.put_last_wins(t, torch.from_numpy(s), torch.from_numpy(x))
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # torch's own index_put_ is not last-wins even on the CPU
    store = tks.KeyedStateStore(64, device="cpu")
    st = store.get_state(tas.DeviceValueStateDescriptor("dv", dtype, 7))
    keys = np.arange(1000) * 13
    st.get(keys)  # the keys take slots in order
    st.put(keys[s], x)
    np.testing.assert_array_equal(st.get(keys).view(np.uint32),
                                  want.view(np.uint32))


def test_gather_clamps_out_of_range_slots_like_take_clip():
    v = np.arange(10, dtype=np.float32) * 1.5
    s = np.array([-3, -1, 0, 4, 9, 10, 12, 1 << 20])
    want = np.asarray(jnp.take(jnp.asarray(v), jnp.asarray(s), axis=0,
                               mode="clip"))
    got = tas.gather_clip(torch.from_numpy(v), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().tolist() == [0.0, 0.0, 0.0, 6.0, 13.5, 13.5, 13.5,
                                    13.5]


# -- operator integration ---------------------------------------------------


def _async_counter(p):
    class _AsyncCounter(p["proc"].ProcessFunction):
        def open(self, ctx):
            self.desc = p["ks"].ReducingStateDescriptor("n", np.add,
                                                        np.int64, 0)

        def process_batch(self, batch, ctx):
            st = ctx.async_state(self.desc)
            keys = batch[JK]
            st.add(keys, np.ones(len(keys), dtype=np.int64))
            ctx.timer_service().register_event_time_timers(
                keys, np.full(len(keys), 100))

        def on_timer(self, key_ids, timestamps, ctx):
            counts = ctx.async_state(self.desc).get(key_ids)
            ctx.collect(p["Batch"]({
                JK: key_ids, JT: timestamps, "count": counts.value()}))

    return _AsyncCounter()


def _batch(p, keys, ts=0):
    keys = np.asarray(keys, dtype=np.int64)
    return p["Batch"]({JK: keys, JT: np.full(len(keys), ts, dtype=np.int64)})


def test_process_operator_async_state_end_to_end():
    def s(p):
        op = p["proc"].ProcessOperator(_async_counter(p), keyed=True)
        op.open(p["ctx"])
        op.process_batch(_batch(p, [1, 2, 1, 1, 2, 3]))
        op.process_batch(_batch(p, [1, 3]))
        outs = op.process_watermark(200)
        assert op.aec.pending == 0
        return [o.to_rows() for o in outs], op.aec.stats

    outs, _ = _both(s)
    assert {r[JK]: r["count"] for r in outs[0]} == {1: 4, 2: 2, 3: 2}


def test_snapshot_drains_pending_async_ops():
    def s(p):
        desc = p["ks"].ReducingStateDescriptor("n", np.add, np.int64, 0)
        op = p["proc"].ProcessOperator(_async_counter(p), keyed=True)
        op.open(p["ctx"])
        op.process_batch(_batch(p, [5, 5, 6]))
        op._ctx().async_state(desc).add(np.array([5]), np.array([10]))
        pending = op.aec.pending
        snap = op.snapshot_state()
        op2 = p["proc"].ProcessOperator(_async_counter(p), keyed=True)
        op2.open(p["ctx"])
        op2.restore_state(snap)
        return pending, op.aec.pending, \
            op2._ctx().async_state(desc).get(np.array([5])).value()

    got = _both(s)
    assert got[0] == 1 and got[1] == 0 and _plain(got[2]) == [12]
