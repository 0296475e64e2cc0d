"""The port's session-metadata planes against the reference's: the
pure-Python ``SessionIntervalSet`` and the native ``NativeSessionIntervalSet``
(``native/sessions.cpp`` through the port's own loader) of
``flink_tpu_torch/windowing/`` against ``flink_tpu.windowing.session_meta.
SessionIntervalSet``.

Model: ``tests/test_native_sessions.py``'s absorb/pop fuzz. The same
batches, made from numpy seeds at heavy key collision (so the
multi-interval slow path, merges, stale sessions and extensions all run),
go through the three planes; sessionization, sid allocation, merge groups,
pops and the final interval sets must be equal. No tolerance: the planes
compute on integers.
"""

import numpy as np
import pytest

from flink_tpu.windowing.session_meta import (
    SessionIntervalSet as JSessionIntervalSet,
)
from flink_tpu_torch.native import load_sessions, native_fallbacks
from flink_tpu_torch.windowing.session_meta import (
    SessionIntervalSet,
    make_session_meta,
)

GAP = 100


@pytest.fixture
def native_cls():
    if load_sessions() is None:
        pytest.fail("the port's loader did not build native/sessions.cpp")
    from flink_tpu_torch.windowing.session_native import (
        NativeSessionIntervalSet,
    )

    return NativeSessionIntervalSet


def _groups(res):
    return [(g.keys_dst, g.sids_dst, g.keys_src, g.sids_src,
             g.absorbed_sids) for g in res.groups]


@pytest.mark.parametrize("lateness", [0, 10])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_absorb_pop_fuzz_parity(native_cls, seed, lateness):
    rng = np.random.default_rng(seed)
    ref = JSessionIntervalSet(GAP, lateness)
    planes = [SessionIntervalSet(GAP, lateness), native_cls(GAP, lateness)]
    fired = 0
    for step in range(150):
        n = int(rng.integers(1, 400))
        keys = rng.integers(0, 50, n).astype(np.int64)
        ts = (step * 80 + rng.integers(0, 300, n)).astype(np.int64)
        want = ref.absorb_batch_ex(keys, ts)
        for plane in planes:
            got = plane.absorb_batch_ex(keys, ts)
            for name in ("sess_key", "sess_sid", "rec_to_sess", "order"):
                np.testing.assert_array_equal(
                    getattr(got, name), getattr(want, name), err_msg=name)
            assert _groups(got) == _groups(want)
            # the native fresh set is a subset (slow-path creations probe)
            assert np.all(~got.fresh | want.fresh)
        if step % 3 == 2:
            want_pop = ref.pop_fired_ex(step * 80)
            fired += len(want_pop.keys)
            for plane in planes:
                got_pop = plane.pop_fired_ex(step * 80)
                for name in ("keys", "starts", "ends", "sids"):
                    np.testing.assert_array_equal(
                        getattr(got_pop, name), getattr(want_pop, name),
                        err_msg=name)
        for plane in planes:
            assert plane._next_sid == ref._next_sid
            assert plane.max_fired_watermark == ref.max_fired_watermark
    want_pop = ref.pop_fired_ex(1 << 60)
    for plane in planes:
        got_pop = plane.pop_fired_ex(1 << 60)
        for name in ("keys", "starts", "ends", "sids"):
            np.testing.assert_array_equal(getattr(got_pop, name),
                                          getattr(want_pop, name))
        assert plane.snapshot() == ref.snapshot()
    assert fired + len(want_pop.keys) > 0


def test_native_plane_folds_slots_and_pops_them(native_cls):
    """The native plane's slot fold: ``note_slots`` writes each session's
    device slot into its metadata row, the next absorb hands it back as a
    hint, and the pop returns it with the fired session."""
    meta = native_cls(GAP, 0)
    keys = np.array([5, 6, 7], dtype=np.int64)
    res = meta.absorb_batch_ex(keys, np.array([0, 10, 20], dtype=np.int64))
    slots = np.array([11, 12, 13], dtype=np.int32)
    meta.note_slots(res.sess_key, res.sess_sid, slots, rows=res.meta_row)
    res2 = meta.absorb_batch_ex(keys, np.array([50, 60, 70], np.int64))
    np.testing.assert_array_equal(res2.slot_hint, slots)
    pop = meta.pop_fired_ex(1 << 40)
    np.testing.assert_array_equal(pop.keys, keys)
    np.testing.assert_array_equal(pop.slot_hint, slots)


def test_make_session_meta_picks_the_native_plane(native_cls):
    before = native_fallbacks()
    assert type(make_session_meta(GAP)) is native_cls
    assert native_fallbacks() == before
