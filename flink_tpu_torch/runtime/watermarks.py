"""Watermark generation and multi-input merging (port of
``flink_tpu/runtime/watermarks.py``). A generator sees a whole batch's
timestamp column at once (one vectorized max)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.elements import MIN_WATERMARK


class WatermarkGenerator:
    def on_batch(self, batch: RecordBatch) -> Optional[int]:
        """Observe a batch; return a new watermark value or None."""
        raise NotImplementedError


class BoundedOutOfOrdernessWatermarks(WatermarkGenerator):
    def __init__(self, max_out_of_orderness_ms: int):
        self.delay = max_out_of_orderness_ms
        self._max_ts = MIN_WATERMARK

    def on_batch(self, batch: RecordBatch) -> Optional[int]:
        if len(batch) == 0 or not batch.has_timestamps:
            return None
        m = int(batch.timestamps.max())
        if m > self._max_ts:
            self._max_ts = m
        return self._max_ts - self.delay - 1


class MonotonousTimestamps(BoundedOutOfOrdernessWatermarks):
    def __init__(self):
        super().__init__(0)


@dataclasses.dataclass
class WatermarkStrategy:
    """Factory + timestamp assignment."""

    generator_factory: Callable[[], WatermarkGenerator]
    timestamp_field: Optional[str] = None

    @staticmethod
    def for_bounded_out_of_orderness(ms: int) -> "WatermarkStrategy":
        return WatermarkStrategy(lambda: BoundedOutOfOrdernessWatermarks(ms))

    @staticmethod
    def for_monotonous_timestamps() -> "WatermarkStrategy":
        return WatermarkStrategy(MonotonousTimestamps)

    def with_timestamp_field(self, field: str) -> "WatermarkStrategy":
        return dataclasses.replace(self, timestamp_field=field)

    def create(self) -> WatermarkGenerator:
        return self.generator_factory()

    def assign_timestamps(self, batch: RecordBatch) -> RecordBatch:
        if self.timestamp_field is not None:
            return batch.with_timestamps(
                np.asarray(batch[self.timestamp_field], dtype=np.int64))
        return batch


class WatermarkValve:
    """Min-merge of per-input watermarks; emits the combined watermark only
    when it advances."""

    def __init__(self, num_inputs: int):
        self._wms = [MIN_WATERMARK] * max(num_inputs, 1)
        self._combined = MIN_WATERMARK

    def advance(self, input_index: int, value: int) -> Optional[int]:
        if value > self._wms[input_index]:
            self._wms[input_index] = value
        combined = min(self._wms)
        if combined > self._combined:
            self._combined = combined
            return combined
        return None

    @property
    def combined(self) -> int:
        return self._combined
