"""The port on a CUDA card: its kernels and the device paths against
their CPU runs. Every test is marked ``cuda`` and skips without a card
(decided inside the test). This file imports no JAX, so it also runs on a
GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the rank and Count are integers, bit-identical; Q5's rows are
counts, equal; the ordered fold, its grouping, the slice merge and the
float32 Sum job are compared on their raw bits against the CPU (NaN
payloads included).
"""

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_rank_kernel_bit_identical_to_plain():
    """Shapes across tile boundaries (4096 lanes), with out-of-range
    lanes, the [C] and [R, C] forms, and the largest D the kernel holds."""
    _need_card()
    from flink_tpu_torch.stateplane.rank import rank, rank_plain

    rng = np.random.default_rng(3)
    for R, C, D in [(1, 1, 1), (1, 1023, 3), (3, 1025, 8), (8, 131072, 8),
                    (2, 5000, 64), (1, 70000, 1024), (2, 4097, 1024)]:
        d = torch.from_numpy(
            rng.integers(-3, D + 3, size=(R, C)).astype(np.int32)).cuda()
        assert torch.equal(rank(d, D), rank_plain(d, D))
        assert torch.equal(rank(d[0], D), rank_plain(d[0], D))


@pytest.mark.cuda
def test_flat_rank_one_launch_per_call():
    """The flat form is the same kernel with its int64 epilogue: one
    launch per call, equal to exchange_rank_flat_plain across tile
    boundaries, with ranks past the bucket width and negative lanes."""
    _need_card()
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
        rank,
    )

    rng = np.random.default_rng(5)
    for R, C, D, W in [(1, 1, 1, 1), (1, 4095, 3, 100), (3, 4097, 8, 64),
                       (8, 131072, 8, 32768), (2, 70000, 64, 300),
                       (8, 4096 * 33 + 7, 5, 1), (1, 9000, 1024, 3)]:
        d = torch.from_numpy(
            rng.integers(-3, D + 3, size=(R, C)).astype(np.int32)).cuda()
        for _ in range(3):  # repeated calls reuse the status buffer
            before = rank.launches
            got = exchange_rank_flat(d, D, W)
            assert rank.launches == before + 1
            assert got.dtype == torch.int64
            assert torch.equal(got, exchange_rank_flat_plain(d, D, W))


@pytest.mark.cuda
def test_ordered_fold_bit_identical_to_cpu():
    """The ordered fold on the card against index_add_ on the CPU (the
    stream-order fold), as one plane: uniform slots, Zipf(1.1) over 100k
    keys, and half the lanes at the identity slot 0 (dropped by the
    kernel, folded with the identity by the CPU); max/min with NaN and
    signed zeros against the plain version."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_scatter_reduce_plain,
    )

    rng = np.random.default_rng(8)
    n = 1 << 18
    p = np.arange(1, 100_001, dtype=np.float64) ** -1.1
    cases = {
        "uniform": rng.integers(0, 4096, n),
        "zipf": rng.choice(100_000, size=n, p=p / p.sum()) + 1,
        "slot0": np.where(rng.random(n) < 0.5, 0, rng.integers(1, 64, n)),
    }
    for name, t in cases.items():
        target = torch.from_numpy(t.astype(np.int64))
        slots = target.to(torch.int32)[None].cuda()
        v = torch.from_numpy((rng.standard_normal(n)
                              * np.exp(rng.uniform(-8, 8, n)))
                             .astype(np.float32))
        v[target == 0] = 0.0                 # the identity slot's lanes
        size = int(t.max()) + 1
        want = torch.zeros(size).index_add_(0, target, v)
        before = ordered_fold_planes.launches
        got = ordered_fold_planes(torch.zeros(1, size, device="cuda"), slots,
                                  v[None].cuda(), "sum")
        assert ordered_fold_planes.launches == before + 1
        assert torch.equal(got[0].cpu().view(torch.int32),
                           want.view(torch.int32)), name
        vs = v.clone()
        pick = torch.from_numpy(rng.random(n))
        vs[pick < 0.02] = float("nan")
        vs[(pick >= 0.02) & (pick < 0.3)] = 0.0
        vs[(pick >= 0.3) & (pick < 0.6)] = -0.0
        for reduce, ident in (("max", -np.inf), ("min", np.inf)):
            vr = vs.masked_fill(target == 0, float(ident))
            acc = torch.full((size,), float(ident))
            want = ordered_scatter_reduce_plain(acc.clone(), target, vr,
                                                reduce)
            got = ordered_fold_planes(acc[None].cuda(), slots,
                                      vr[None].cuda(), reduce)
            assert torch.equal(got[0].cpu().view(torch.int32),
                               want.view(torch.int32)), (name, reduce)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _special_values(rng, n, dtype):
    """Wide-range values with NaN payloads (signalling, quiet, negative),
    +inf and -inf sprinkled in."""
    v = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
    v = v.astype(np.float32 if dtype == torch.float32 else np.float64)
    ib = v.view(np.int32 if v.itemsize == 4 else np.int64)
    pick = rng.random(n)
    if v.itemsize == 4:
        nans = [0x7FA00001, 0x7FC0000A, -0x003FFFFB]      # 0xffc00005
    else:
        nans = [0x7FF4000000000001, 0x7FF800000000000A,
                -0x0007FFFFFFFFFFFB]
    for j, b in enumerate(nans):
        sel = (pick >= 0.002 * j) & (pick < 0.002 * (j + 1))
        ib[sel] = b + rng.integers(0, 1 << 10, int(sel.sum()))
    v[(pick >= 0.01) & (pick < 0.02)] = np.inf
    v[(pick >= 0.02) & (pick < 0.03)] = -np.inf
    return torch.from_numpy(v)


@pytest.mark.cuda
def test_fold_planes_edge_cases_bit_identical_to_cpu():
    """ordered_fold_planes on the card against its plain version on the
    CPU: an empty plane, L = 0, a plane whose every lane is on slot 0, a
    cap that is not a power of two, runs past the long-run threshold,
    sums that meet NaN payloads and inf - inf, and float64."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    rng = np.random.default_rng(12)
    for dtype in (torch.float32, torch.float64):
        for P, L, cap in [(3, 0, 100), (1, 1, 1), (4, 5000, 1000),
                          (8, 20000, 65536), (2, 70000, 70001),
                          (3, 300000, 5)]:
            slots = rng.integers(0, cap, (P, L)).astype(np.int32)
            if L:
                slots[0] = 0                     # every lane on slot 0
                slots[-1, : L // 2] = min(cap - 1, 3)   # one hot slot
            s = torch.from_numpy(slots)
            for reduce, ident in (("sum", 0.0), ("max", -np.inf),
                                  ("min", np.inf)):
                v = _special_values(rng, P * L, dtype).view(P, L)
                v[s == 0] = ident                # padding carries identity
                acc = _special_values(rng, P * cap, dtype).view(P, cap)
                acc[:, 0] = ident
                if reduce != "sum":   # max/min write the canonical NaN
                    acc[torch.isnan(acc)] = 0.0
                want = ordered_fold_planes_plain(acc.clone(), s, v, reduce)
                before = ordered_fold_planes.launches
                got = ordered_fold_planes(acc.cuda(), s.cuda(), v.cuda(),
                                          reduce)
                torch.cuda.synchronize()
                assert ordered_fold_planes.launches == before + (L > 0)
                assert torch.equal(_bits(got.cpu()), _bits(want)), \
                    (dtype, P, L, cap, reduce)


@pytest.mark.cuda
def test_grouping_equals_stable_sort():
    """The radix grouping alone against a stable sort on the CPU: one,
    two and three passes, identity-slot and out-of-range lanes dropped."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import (
        group_planes,
        group_planes_plain,
    )

    rng = np.random.default_rng(13)
    for P, L, cap in [(2, 9000, 200), (8, 40000, 1 << 16),
                      (1, 100000, (1 << 17) + 3), (3, 5000, 1 << 20)]:
        slots = torch.from_numpy(
            rng.integers(-2, cap + 2, (P, L)).astype(np.int32))
        v = torch.from_numpy(rng.standard_normal((P, L)).astype(np.float32))
        got = group_planes(slots.cuda(), v.cuda(), cap)
        want = group_planes_plain(slots, v, cap)
        for (gk, gv), (wk, wv) in zip(got, want):
            assert torch.equal(gk.cpu(), wk), (P, L, cap)
            assert torch.equal(_bits(gv.cpu()), _bits(wv)), (P, L, cap)


@pytest.mark.cuda
def test_merge_sum_nan_card_equals_cpu():
    """The fire's slice merge of float sums on the card against the CPU,
    NaN payloads and inf - inf included, float32 and float64."""
    _need_card()
    from flink_tpu_torch.ops.segment_ops import MERGE_FN

    rng = np.random.default_rng(14)
    for dtype in (torch.float32, torch.float64):
        for k in (1, 2, 5, 16):
            x = _special_values(rng, 8 * 512 * k, dtype).view(8, 512, k)
            want = MERGE_FN["sum"](x)
            got = MERGE_FN["sum"](x.cuda())
            assert torch.equal(_bits(got.cpu()), _bits(want)), (dtype, k)


@pytest.mark.cuda
def test_fold_planes_checks_and_counts():
    """One counted launch per call that has lanes; what the kernel does
    not take raises (no fallback)."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes

    acc = torch.zeros(2, 64, device="cuda")
    s = torch.ones(2, 10, dtype=torch.int32, device="cuda")
    v = torch.ones(2, 10, device="cuda")
    before = ordered_fold_planes.launches
    ordered_fold_planes(acc, s, v, "sum")
    ordered_fold_planes(acc, s[:, :0], v[:, :0], "sum")
    assert ordered_fold_planes.launches == before + 1
    assert acc[:, 1].tolist() == [10.0, 10.0]
    with pytest.raises(TypeError):
        ordered_fold_planes(acc, s.to(torch.int64), v, "sum")
    with pytest.raises(TypeError):
        ordered_fold_planes(acc, s, v.double(), "sum")
    with pytest.raises(ValueError):
        ordered_fold_planes(acc, s, v, "mean")
    with pytest.raises(ValueError):
        ordered_fold_planes(acc, s.t().contiguous().t(), v, "sum")
    with pytest.raises(ValueError):
        ordered_fold_planes(acc, s[:1], v[:1], "sum")


@pytest.mark.cuda
def test_rank_wrapper_checks_and_counts():
    _need_card()
    from flink_tpu_torch.stateplane.rank import rank

    d = torch.zeros(64, dtype=torch.int32, device="cuda")
    before = rank.launches
    rank(d, 4)
    assert rank.launches == before + 1
    with pytest.raises(TypeError):
        rank(d.to(torch.int64), 4)
    with pytest.raises(ValueError):
        rank(d, 1025)
    with pytest.raises(ValueError):
        rank(torch.zeros(4, 64, dtype=torch.int32, device="cuda").t(), 4)


@pytest.mark.cuda
def test_q5_on_card_equals_cpu_run():
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.stateplane.rank import rank

    def run(device):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 14,
            "parallelism.default": 8, "execution.device": device}))
        sink = CollectSink()
        build_q5(env, BidSource(total_records=150_000, num_auctions=3_000,
                                events_per_second_of_eventtime=100_000)
                 ).sink_to(sink)
        env.execute()
        return sorted(sorted(r.items()) for r in sink.rows())

    before = rank.launches
    on_card = run("cuda")
    assert rank.launches > before
    assert on_card == run("cpu")


@pytest.mark.cuda
def test_q5_revenue_on_card_equals_cpu_run():
    """The float32 Sum job (Q5-revenue) at a small size: the card's fired
    rows equal the CPU run's bit for bit, through the ordered fold."""
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    def run(device):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 14,
            "parallelism.default": 8, "execution.device": device}))
        sink = CollectSink()
        (env.from_source(BidSource(total_records=150_000,
                                   num_auctions=3_000,
                                   events_per_second_of_eventtime=100_000),
                         WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by("auction")
         .window(SlidingEventTimeWindows.of(10_000, 2_000))
         .sum("price").sink_to(sink))
        env.execute()
        res = sink.result()
        return {c: np.asarray(res[c]) for c in
                ("auction", "window_end", "sum_price")}

    before = ordered_fold_planes.launches
    on_card = run("cuda")
    assert ordered_fold_planes.launches > before
    on_cpu = run("cpu")
    assert len(on_card["sum_price"]) > 0
    for c in ("auction", "window_end"):
        np.testing.assert_array_equal(on_card[c], on_cpu[c])
    np.testing.assert_array_equal(on_card["sum_price"].view(np.int32),
                                  on_cpu["sum_price"].view(np.int32))
