"""The port's host-side foundations against the JAX package's modules on
the same inputs: key groups, segment helpers, assigners, bookkeeping, the
slot index, aggregates' finish, the top-k projector, the watermark
generator, and the native loader.

Tolerance: none — everything here is integer or host NumPy arithmetic, so
outputs must be equal (the Avg finish divides float32 by float32 the same
way on both sides).
"""

import os

import numpy as np
import pytest
import torch

from flink_tpu.ops import segment_ops as jseg
from flink_tpu.state import keygroups as jkg
from flink_tpu.state import slot_table as jst
from flink_tpu.windowing import assigners as jasg
from flink_tpu.windowing import bookkeeping as jbook
from flink_tpu.windowing.fire_projectors import TopKFireProjector as JTopK
from flink_tpu_torch.ops import segment_ops as tseg
from flink_tpu_torch.state import keygroups as tkg
from flink_tpu_torch.state import slot_table as tst
from flink_tpu_torch.windowing import assigners as tasg
from flink_tpu_torch.windowing import bookkeeping as tbook
from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector as TTopK


@pytest.mark.parametrize("seed", [0, 1])
def test_key_groups_exact(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(1 << 62), 1 << 62, 5000, dtype=np.int64)
    for mp in (1, 7, 128, 32768):
        g = tkg.assign_key_groups(keys, mp)
        np.testing.assert_array_equal(g, jkg.assign_key_groups(keys, mp))
        for par in (1, 3, 8):
            if par <= mp:
                np.testing.assert_array_equal(
                    tkg.key_group_to_operator_index(g, mp, par),
                    jkg.key_group_to_operator_index(g, mp, par))
    words = np.array(["auction", "bid", "", "ünï", "x" * 40], dtype=object)
    for col in (words, keys[:50].astype(np.float64), keys[:50]):
        np.testing.assert_array_equal(tkg.hash_keys_to_i64(col),
                                      jkg.hash_keys_to_i64(col))


def test_segment_helpers():
    for n in (0, 1, 255, 256, 257, 1000, 1 << 20):
        assert tseg.pad_bucket_size(n) == jseg.pad_bucket_size(n)
        for cached in (0, 256, 4096, 1 << 22):
            assert tseg.sticky_bucket(n, cached, 64) == \
                jseg.sticky_bucket(n, cached, 64)
    for reduce in ("sum", "max", "min"):
        for dt in (np.int32, np.int64, np.float32):
            assert tseg.identity_for(reduce, dt) == \
                jseg.identity_for(reduce, dt)
    assert tseg.torch_dtype(np.float32) == torch.float32


@pytest.mark.parametrize("make", [
    lambda m: m.TumblingEventTimeWindows.of(500),
    lambda m: m.SlidingEventTimeWindows.of(10_000, 2_000),
    lambda m: m.SlidingEventTimeWindows.of(1000, 300, 50),
])
def test_assigners_and_bookkeeping(make):
    ta, ja = make(tasg), make(jasg)
    rng = np.random.default_rng(4)
    ts = rng.integers(0, 50_000, 4000).astype(np.int64)
    se = ta.assign_slice_ends(ts)
    np.testing.assert_array_equal(se, ja.assign_slice_ends(ts))
    np.testing.assert_array_equal(ta.last_window_ends(se),
                                  ja.last_window_ends(se))
    for s in np.unique(se)[:20].tolist():
        assert ta.window_ends_for_slice(s) == ja.window_ends_for_slice(s)
        assert ta.slice_ends_for_window(s) == ja.slice_ends_for_window(s)
        assert ta.window_start(s) == ja.window_start(s)
    tb, jb = tbook.SliceBookkeeper(ta, 700), jbook.SliceBookkeeper(ja, 700)
    for step in range(8):
        chunk = ts[step * 500:(step + 1) * 500]
        se_c = ta.assign_slice_ends(chunk)
        lt, lj = tb.live_mask(se_c), jb.live_mask(se_c)
        assert (lt is None) == (lj is None)
        if lt is not None:
            np.testing.assert_array_equal(lt, lj)
            se_c = se_c[lt]
        tb.register_slices(se_c)
        jb.register_slices(se_c)
        wm = step * 6000
        fired_t, fired_j = [], []
        while (w := tb.next_window(wm)) is not None:
            fired_t.append(w)
            tb.mark_fired(w)
        while (w := jb.next_window(wm)) is not None:
            fired_j.append(w)
            jb.mark_fired(w)
        assert fired_t == fired_j
        assert tb.expired_slices(wm) == jb.expired_slices(wm)
    assert tb.late_records_dropped == jb.late_records_dropped


@pytest.mark.parametrize("cls", ["HostSlotIndex", "NativeSlotIndex"])
def test_slot_index_matches_reference(cls):
    t = getattr(tst, cls)(1024)
    j = getattr(jst, cls)(1024)
    rng = np.random.default_rng(9)
    for step in range(6):
        keys = rng.integers(0, 3000, 2000).astype(np.int64)
        nss = rng.integers(step, step + 3, 2000).astype(np.int64) * 100
        np.testing.assert_array_equal(t.lookup_or_insert(keys, nss),
                                      j.lookup_or_insert(keys, nss))
        assert t.capacity == j.capacity
        for ns in sorted(set(nss.tolist())):
            np.testing.assert_array_equal(t.slots_for_namespace(ns),
                                          j.slots_for_namespace(ns))
        np.testing.assert_array_equal(t.lookup(keys[:50], nss[:50]),
                                      j.lookup(keys[:50], nss[:50]))
        a = t.free_namespaces([step * 100])
        b = j.free_namespaces([step * 100])
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        assert t.num_used == j.num_used
    keys = rng.integers(0, 50, 300).astype(np.int64)
    nss = rng.integers(0, 4, 300).astype(np.int64)
    for got, want in zip(tst.unique_pairs(keys, nss),
                         jst.unique_pairs(keys, nss)):
        np.testing.assert_array_equal(got, want)


def test_aggregate_finish_and_leaves():
    from flink_tpu.windowing import aggregates as jagg
    from flink_tpu_torch.windowing import aggregates as tagg

    rng = np.random.default_rng(2)
    s = rng.standard_normal(64).astype(np.float32)
    c = rng.integers(0, 5, 64).astype(np.float32)
    for name in ("SumAggregate", "MaxAggregate", "MinAggregate",
                 "AvgAggregate"):
        ta, ja = getattr(tagg, name)("v"), getattr(jagg, name)("v")
        assert ta.leaves == tuple(
            tagg.AccLeaf(l.name, l.dtype, l.reduce, l.const)
            for l in ja.leaves)
        assert ta.output_names == ja.output_names
        merged = (s, c)[:len(ja.leaves)]
        got = ta.finish(tuple(torch.from_numpy(m) for m in merged))
        want = ja.finish(merged)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert tagg.CountAggregate().leaves[0].const == 1


@pytest.mark.parametrize("descending", [True, False])
def test_top_k_projector_host_form(descending):
    rng = np.random.default_rng(6)
    keys = np.arange(500, dtype=np.int64)
    cols = {"count": rng.integers(0, 20, 500).astype(np.int32)}
    for k in (1, 16, 600):
        tk, tc = TTopK("count", k, descending).project_host(keys, cols)
        jk, jc = JTopK("count", k, descending).project_host(keys, cols)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tc["count"], jc["count"])


def test_watermark_generator_and_valve():
    from flink_tpu.runtime import watermarks as jwm
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.runtime import watermarks as twm

    tg = twm.WatermarkStrategy.for_bounded_out_of_orderness(5).create()
    jg = jwm.WatermarkStrategy.for_bounded_out_of_orderness(5).create()
    for ts in ([3, 9, 1], [2], [40, 7]):
        b = RecordBatch.from_pydict({"x": np.zeros(len(ts))},
                                    timestamps=ts)
        assert tg.on_batch(b) == jg.on_batch(b)
    tv, jv = twm.WatermarkValve(2), jwm.WatermarkValve(2)
    for i, v in [(0, 5), (1, 3), (1, 9), (0, 7), (0, 4)]:
        assert tv.advance(i, v) == jv.advance(i, v)


def test_native_loader_builds_into_its_own_stamped_directory():
    from flink_tpu_torch import native

    lib = native.load_slotmap()
    if lib is None:
        pytest.skip("no g++ on this host")
    so = os.path.join(native._BUILD_DIR, "_slotmap.so")
    assert os.path.dirname(so).endswith(
        os.path.join("flink_tpu_torch", "native", "build"))
    with open(so + ".srchash") as f:
        stamp = f.read().strip()
    assert stamp == native.source_hash(
        os.path.join(native._SRC_DIR, "slotmap.cpp"),
        native._build_provenance())
    assert native.load_datagen() is not None
