"""Sources (port of ``flink_tpu/connectors/sources.py``: the base class
and the counter-based hash the synthetic generators derive their records
from)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from flink_tpu_torch.core.records import RecordBatch


class Source:
    """A bounded batch source."""

    bounded: bool = True

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        pass

    def poll_batch(self, max_records: int) -> Optional[RecordBatch]:
        """Next batch, or None when exhausted."""
        raise NotImplementedError

    def close(self) -> None:
        pass


def _splitmix64(idx: np.ndarray, salt: int) -> np.ndarray:
    """Vectorized counter-based hash (splitmix64): record content derives
    from the GLOBAL record index, so a stream is identical under any batch
    size or source parallelism."""
    with np.errstate(over="ignore"):
        z = idx.astype(np.uint64) + np.uint64(
            (salt * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
        z = (z + np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))
