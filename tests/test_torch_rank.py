"""The port's exchange rank (flink_tpu_torch/stateplane/rank.py) against
the JAX reference (flink_tpu/stateplane/rank.py).

Tolerance: none — ranks are integers, every case is bit-identical. On the
CPU the port's ``rank`` runs its plain version; the CUDA kernel is held to
the same plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from flink_tpu.stateplane.rank import exchange_rank_flat as jax_flat
from flink_tpu.stateplane.rank import pallas_rank, xla_rank
from flink_tpu_torch.stateplane.rank import (
    exchange_rank_flat,
    rank,
    rank_plain,
)


def _shapes(seed=19, n_cases=25):
    """The random shapes of tests/test_stateplane.py's parity test:
    destinations include negative and out-of-range lanes."""
    rng = np.random.default_rng(seed)
    for _ in range(n_cases):
        D = int(rng.integers(1, 17))
        n = int(rng.integers(1, 500))
        W = int(rng.integers(1, 64))
        yield D, W, rng.integers(-2, D + 3, size=n).astype(np.int32)


@pytest.mark.parametrize("case", range(25))
def test_rank_matches_xla_rank(case):
    D, W, d = list(_shapes())[case]
    t = torch.from_numpy(d)
    np.testing.assert_array_equal(rank_plain(t, D).numpy(),
                                  np.asarray(xla_rank(d, D)))
    np.testing.assert_array_equal(rank(t, D).numpy(),
                                  np.asarray(xla_rank(d, D)))
    np.testing.assert_array_equal(exchange_rank_flat(t, D, W).numpy(),
                                  np.asarray(jax_flat(d, D, W, "xla")))


def test_rank_matches_pallas_rank_standalone():
    """Against the Pallas kernel run standalone (interpret mode on the
    CPU), where the reference's own parity test passes."""
    for D, W, d in _shapes():
        t = torch.from_numpy(d)
        np.testing.assert_array_equal(rank(t, D).numpy(),
                                      np.asarray(pallas_rank(d, D)))
        np.testing.assert_array_equal(
            exchange_rank_flat(t, D, W).numpy(),
            np.asarray(jax_flat(d, D, W, "pallas")))


def test_batched_rows_are_independent():
    """[R, C]: each row ranks as its own [C] column does in the
    reference (one row per source shard)."""
    rng = np.random.default_rng(7)
    R, C, D, W = 8, 1024, 8, 256
    d = rng.integers(-1, D + 2, size=(R, C)).astype(np.int32)
    got_rank = rank(torch.from_numpy(d), D).numpy()
    got_flat = exchange_rank_flat(torch.from_numpy(d), D, W).numpy()
    for r in range(R):
        np.testing.assert_array_equal(got_rank[r],
                                      np.asarray(xla_rank(d[r], D)))
        np.testing.assert_array_equal(
            got_flat[r], np.asarray(jax_flat(d[r], D, W, "xla")))


def test_launch_counter_untouched_on_cpu():
    before = rank.launches
    rank(torch.zeros(16, dtype=torch.int32), 4)
    assert rank.launches == before

