"""Stream elements: record batches, watermarks, checkpoint barriers
(port of ``flink_tpu/runtime/elements.py``).

The record granularity is a whole columnar batch; watermarks and barriers
flow between batches, which makes barrier alignment a batch boundary.
"""

from __future__ import annotations

import dataclasses

MAX_WATERMARK = (1 << 62)  # end-of-input flush (reference: Watermark.MAX_WATERMARK)
MIN_WATERMARK = -(1 << 62)


@dataclasses.dataclass(frozen=True)
class Watermark:
    """Event-time watermark: no records with ts <= value will arrive later."""

    value: int

    def __le__(self, other):
        return self.value <= other.value


@dataclasses.dataclass(frozen=True)
class CheckpointBarrier:
    """Aligned checkpoint barrier (reference:
    runtime/io/checkpointing/CheckpointBarrierHandler.java). In a micro-batch
    engine alignment degenerates to 'snapshot between two batches'."""

    checkpoint_id: int
    timestamp: int = 0


@dataclasses.dataclass(frozen=True)
class EndOfInput:
    """Signals a finite source is drained (bounded streams / tests)."""
