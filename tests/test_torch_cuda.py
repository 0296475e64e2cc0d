"""The port on a CUDA card: the rank kernel and the device paths against
their CPU runs. Every test is marked ``cuda`` and skips without a card
(decided inside the test). This file imports no JAX, so it also runs on a
GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the rank and Count are integers, bit-identical; Q5's rows are
counts, equal.
"""

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_rank_kernel_bit_identical_to_plain():
    """Shapes across tile boundaries (1024 lanes), with out-of-range
    lanes, the [C] and [R, C] forms, and the largest D the kernel holds."""
    _need_card()
    from flink_tpu_torch.stateplane.rank import rank, rank_plain

    rng = np.random.default_rng(3)
    for R, C, D in [(1, 1, 1), (1, 1023, 3), (3, 1025, 8), (8, 131072, 8),
                    (2, 5000, 64), (1, 70000, 1024)]:
        d = torch.from_numpy(
            rng.integers(-3, D + 3, size=(R, C)).astype(np.int32)).cuda()
        assert torch.equal(rank(d, D), rank_plain(d, D))
        assert torch.equal(rank(d[0], D), rank_plain(d[0], D))


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
