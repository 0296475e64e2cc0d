"""Keyed state with TTL of the port against the reference's on the CPU:
the cases of ``tests/test_ttl.py``'s ``TestConfig``, ``TestValueState``,
``TestReducingState`` and ``TestHostStates`` (the GroupAgg, SQL and
upsert-materializer cases are ROADMAP items 11b and 11c). Each scenario
runs on both packages' ``KeyedStateStore`` with the same injected clock;
what it reads is equal, value for value (tolerance: none), and each also
holds the reference test's own expectation.
"""

import numpy as np
import pytest

from flink_tpu.state import keyed_state as jks
from flink_tpu.state import ttl as jttl
from flink_tpu_torch.state import keyed_state as tks
from flink_tpu_torch.state import ttl as tttl

PKGS = {"ref": (jks, jttl), "port": (tks, tttl)}
K = np.asarray([1, 2, 3], dtype=np.int64)


class Clock:
    def __init__(self, t=0):
        self.t = t

    def __call__(self):
        return self.t


def _both(scenario):
    """``scenario(ks, ttl)`` on both packages; the port's reads equal the
    reference's."""
    got = {name: scenario(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def _store(ks, clock):
    return ks.KeyedStateStore(capacity=1 << 10, clock=clock)


# ----------------------------------------------------------------- config


def test_builder_mirrors_reference():
    for _, ttl in PKGS.values():
        cfg = (ttl.StateTtlConfig.new_builder(5000)
               .update_ttl_on_read_and_write()
               .return_expired_if_not_cleaned_up()
               .build())
        assert cfg.ttl_ms == 5000
        assert cfg.update_type == ttl.ON_READ_AND_WRITE
        assert cfg.visibility == ttl.RETURN_EXPIRED_IF_NOT_CLEANED_UP
    assert tttl.ON_READ_AND_WRITE == jttl.ON_READ_AND_WRITE
    assert tttl.NEVER_RETURN_EXPIRED == jttl.NEVER_RETURN_EXPIRED


@pytest.mark.parametrize("kwargs", [
    {"ttl_ms": 0}, {"ttl_ms": 10, "update_type": "sometimes"},
    {"ttl_ms": 10, "visibility": "maybe"}])
def test_validation(kwargs):
    for _, ttl in PKGS.values():
        with pytest.raises(ValueError):
            ttl.StateTtlConfig(**kwargs)


def test_sweep_gate_cadence():
    def scenario(ks, ttl):
        gate = ttl.SweepGate(100)
        return [gate.should_sweep(t) for t in (0, 10, 24, 25, 40, 60, 200)]

    assert _both(scenario) == [False, False, False, True, False, True,
                               True]


# ------------------------------------------------------------- value state


def _value_scenario(cfg_kwargs, steps):
    """Put [10, 20, 30] at t=0, then for each (t, action) step read,
    write the first key, or sweep; returns the reads."""
    def scenario(ks, ttl):
        clock = Clock()
        store = _store(ks, clock)
        st = store.get_state(ks.ValueStateDescriptor(
            "v", ttl=ttl.StateTtlConfig(100, **cfg_kwargs)))
        st.put(K, [10.0, 20.0, 30.0])
        out = []
        for t, action in steps:
            clock.t = t
            if action == "get":
                out.append(st.get(K).tolist())
            elif action == "put":
                st.put(K[:1], [2.0])
            else:
                out.append(store.sweep_expired())
        return out

    return scenario


def test_on_create_and_write_expires():
    assert _both(_value_scenario({}, [(99, "get"), (101, "get")])) == [
        [10.0, 20.0, 30.0], [0.0, 0.0, 0.0]]


def test_read_does_not_extend_by_default():
    assert _both(_value_scenario({}, [(90, "get"), (150, "get")]))[1] == [
        0.0, 0.0, 0.0]


def test_on_read_and_write_extends():
    got = _both(_value_scenario(
        {"update_type": jttl.ON_READ_AND_WRITE},
        [(90, "get"), (150, "get")]))
    assert got[1] == [10.0, 20.0, 30.0]


def test_write_refreshes():
    got = _both(_value_scenario({}, [(90, "put"), (150, "get")]))
    assert got[0][0] == 2.0 and got[0][1] == 0.0


def test_return_expired_if_not_cleaned_up():
    got = _both(_value_scenario(
        {"visibility": jttl.RETURN_EXPIRED_IF_NOT_CLEANED_UP},
        [(200, "get"), (200, "sweep"), (200, "get")]))
    assert got == [[10.0, 20.0, 30.0], 3, [0.0, 0.0, 0.0]]


def test_expired_read_does_not_resurrect():
    got = _both(_value_scenario(
        {"update_type": jttl.ON_READ_AND_WRITE},
        [(150, "get"), (160, "get")]))
    assert got == [[0.0, 0.0, 0.0]] * 2


def test_sweep_clears_values():
    got = _both(_value_scenario({}, [(101, "sweep"), (0, "get")]))
    assert got == [3, [0.0, 0.0, 0.0]]


def test_restore_honors_remaining_ttl():
    def scenario(ks, ttl):
        clock = Clock()
        store = _store(ks, clock)
        desc = ks.ValueStateDescriptor("v", ttl=ttl.StateTtlConfig(100))
        store.get_state(desc).put(K, [4.0, 4.0, 4.0])
        clock.t = 60
        snap = store.snapshot()
        clock2 = Clock(60)
        store2 = _store(ks, clock2)
        store2.restore(snap)
        st2 = store2.get_state(desc)
        out = [st2.get(K).tolist()]
        clock2.t = 101  # written at 0 -> expires at 100, not 160
        out.append(st2.get(K).tolist())
        return out, snap["states"]["v"]["ttl_stamps"].tolist()

    got, stamps = _both(scenario)
    assert got == [[4.0] * 3, [0.0] * 3]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_ttl_snapshot_restores_across_packages(writer, reader):
    wks, wttl = PKGS[writer]
    rks, rttl = PKGS[reader]
    clock = Clock()
    store = _store(wks, clock)
    store.get_state(wks.ValueStateDescriptor(
        "v", ttl=wttl.StateTtlConfig(100))).put(K, [4.0, 5.0, 6.0])
    store.get_state(wks.ListStateDescriptor(
        "l", ttl=wttl.StateTtlConfig(100))).add(K, [1.0, 2.0, 3.0])
    store2 = _store(rks, Clock(50))
    store2.restore(store.snapshot())
    assert store2.get_state(rks.ValueStateDescriptor(
        "v", ttl=rttl.StateTtlConfig(100))).get(K).tolist() == [4.0, 5.0, 6.0]
    assert store2.get_state(rks.ListStateDescriptor(
        "l", ttl=rttl.StateTtlConfig(100))).get(2) == [2.0]


# ---------------------------------------------------------- reducing state


def test_fold_restarts_after_expiry():
    def scenario(ks, ttl):
        clock = Clock()
        st = _store(ks, clock).get_state(ks.ReducingStateDescriptor(
            "sum", reduce=np.add, ttl=ttl.StateTtlConfig(100)))
        st.add(K, [1.0, 1.0, 1.0])
        clock.t = 50
        st.add(K, [2.0, 2.0, 2.0])
        out = [st.get(K).tolist()]
        clock.t = 200
        st.add(K, [5.0, 5.0, 5.0])
        out.append(st.get(K).tolist())
        return out

    assert _both(scenario) == [[3.0] * 3, [5.0] * 3]


def test_reducing_duplicates_fold_in_order():
    def scenario(ks, ttl):
        st = _store(ks, Clock()).get_state(ks.ReducingStateDescriptor(
            "m", reduce=np.maximum, dtype=np.float32, default=-1.0))
        rng = np.random.default_rng(2)
        keys = rng.integers(0, 40, 1000)
        st.add(keys, rng.normal(size=1000).astype(np.float32))
        return st.get(np.arange(40)).tolist()

    _both(scenario)


# ------------------------------------------------------------- host states


def test_list_state_ttl_and_snapshot_shrink():
    def scenario(ks, ttl):
        clock = Clock()
        store = _store(ks, clock)
        st = store.get_state(
            ks.ListStateDescriptor("l", ttl=ttl.StateTtlConfig(100)))
        st.add(K, [1.0, 2.0, 3.0])
        clock.t = 150
        return st.get(1), store.sweep_expired(), st.snapshot()["lists"]

    assert _both(scenario) == ([], 3, {})


def test_list_append_after_expiry_starts_fresh():
    def scenario(ks, ttl):
        clock = Clock()
        st = _store(ks, clock).get_state(
            ks.ListStateDescriptor("l", ttl=ttl.StateTtlConfig(100)))
        st.add(K[:1], [1.0])
        clock.t = 200
        st.add(K[:1], [9.0])
        return st.get(1)

    assert _both(scenario) == [9.0]


def test_list_keys_agree_with_get_visibility():
    def scenario(ks, ttl):
        clock = Clock()
        st = _store(ks, clock).get_state(
            ks.ListStateDescriptor("l", ttl=ttl.StateTtlConfig(100)))
        st.add(K, [1.0, 2.0, 3.0])
        before = sorted(st.keys())
        clock.t = 150
        return before, st.keys(), st.get(1)

    assert _both(scenario) == ([1, 2, 3], [], [])


def test_map_state_ttl():
    def scenario(ks, ttl):
        clock = Clock()
        store = _store(ks, clock)
        st = store.get_state(
            ks.MapStateDescriptor("m", ttl=ttl.StateTtlConfig(100)))
        st.put(1, "a", 10)
        clock.t = 90
        st.put(1, "b", 20)  # a write refreshes the KEY's lifetime
        clock.t = 180
        out = [st.get(1, "a"), st.entries(1)]
        clock.t = 300
        out.append(st.get(1, "a"))
        store.sweep_expired()
        out.append(st.snapshot()["maps"])
        return out

    assert _both(scenario) == [10, {"a": 10, "b": 20}, None, {}]


def test_map_state_remove_contains_and_clear():
    def scenario(ks, ttl):
        st = _store(ks, Clock()).get_state(ks.MapStateDescriptor("m"))
        st.put(1, "a", 1)
        st.put(2, "a", 2)
        st.remove(1, "a")
        out = [st.contains(1, "a"), st.contains(2, "a")]
        st.clear([2])
        return out + [st.entries(2)]

    assert _both(scenario) == [False, True, {}]
