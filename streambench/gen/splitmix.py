"""The counter-based hash every generator draws from: each event is a pure
function of its global index and the seed. A copy of ``_splitmix64`` in
``flink_tpu_torch/connectors/sources.py``; the benchmark keeps its own, so
that the events stay the same whatever the program does to its copy."""

from __future__ import annotations

import numpy as np

_GOLDEN = 0x9E3779B97F4A7C15
_MASK = 0xFFFFFFFFFFFFFFFF


def splitmix64(idx: np.ndarray, salt: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = idx.astype(np.uint64) + np.uint64((int(salt) * _GOLDEN) & _MASK)
        z = z + np.uint64(_GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))

