"""The port on a CUDA card: its kernels and the device paths against
their CPU runs. Every test is marked ``cuda`` and skips without a card
(decided inside the test). This file imports no JAX, so it also runs on a
GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the rank and Count are integers, bit-identical; Q5's rows are
counts, equal; the ordered fold and the float32 Sum job are compared on
their raw bits against the CPU's stream-order fold.
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
    stream-order fold): uniform targets, Zipf(1.1) over 100k keys, and
    padded lanes at slot 0; max/min with NaN and signed zeros against the
    plain version."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import (
        ordered_scatter_add,
        ordered_scatter_reduce,
        ordered_scatter_reduce_plain,
    )

    rng = np.random.default_rng(8)
    n = 1 << 18
    p = np.arange(1, 100_001, dtype=np.float64) ** -1.1
    cases = {
        "uniform": rng.integers(0, 4096, n),
        "zipf": rng.choice(100_000, size=n, p=p / p.sum()),
        "slot0": np.where(rng.random(n) < 0.5, 0, rng.integers(1, 64, n)),
    }
    for name, t in cases.items():
        target = torch.from_numpy(t.astype(np.int64))
        v = torch.from_numpy((rng.standard_normal(n)
                              * np.exp(rng.uniform(-8, 8, n)))
                             .astype(np.float32))
        size = int(t.max()) + 1
        want = torch.zeros(size).index_add_(0, target, v)
        before = ordered_scatter_add.launches
        got = ordered_scatter_add(torch.zeros(size, device="cuda"),
                                  target.cuda(), v.cuda())
        assert ordered_scatter_add.launches == before + 1
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), name
        # [P, 16] planes whose slot 0 takes only identity lanes: the
        # kernel skips them (identity_stride), the CPU folds them
        pads = torch.where(target % 16 == 0, torch.zeros_like(v), v)
        want = torch.zeros(size).index_add_(0, target, pads)
        got = ordered_scatter_add(torch.zeros(size, device="cuda"),
                                  target.cuda(), pads.cuda(),
                                  identity_stride=16)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), (name, "pads")
        vs = v.clone()
        pick = torch.from_numpy(rng.random(n))
        vs[pick < 0.02] = float("nan")
        vs[(pick >= 0.02) & (pick < 0.3)] = 0.0
        vs[(pick >= 0.3) & (pick < 0.6)] = -0.0
        for reduce, ident in (("max", -np.inf), ("min", np.inf)):
            acc = torch.full((size,), float(ident))
            want = ordered_scatter_reduce_plain(acc.clone(), target, vs,
                                                reduce)
            got = ordered_scatter_reduce(acc.cuda(), target.cuda(),
                                         vs.cuda(), reduce)
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), (name, reduce)


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
    from flink_tpu_torch.stateplane.fold import ordered_scatter_add
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

    before = ordered_scatter_add.launches
    on_card = run("cuda")
    assert ordered_scatter_add.launches > before
    on_cpu = run("cpu")
    assert len(on_card["sum_price"]) > 0
    for c in ("auction", "window_end"):
        np.testing.assert_array_equal(on_card[c], on_cpu[c])
    np.testing.assert_array_equal(on_card["sum_price"].view(np.int32),
                                  on_cpu["sum_price"].view(np.int32))
