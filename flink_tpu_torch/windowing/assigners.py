"""Window assigners built around slices (port of
``flink_tpu/windowing/assigners.py``: tumbling and sliding event time).

Each record is assigned to exactly ONE slice (one vectorized arithmetic op
over the timestamp column); a window is merged from its slices at fire
time. Times are int64 milliseconds; a slice or window is identified by its
exclusive END timestamp (window [s, e) fires when watermark >= e - 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class WindowAssigner:
    """Base: maps timestamps -> slice ends, and window ends -> slice ranges."""

    size: int            # full window span (ms)
    slide: int           # distance between consecutive window ends (ms)
    slice_width: int     # width of one slice (ms)
    offset: int = 0

    def assign_slice_ends(self, timestamps: np.ndarray) -> np.ndarray:
        """Each record -> exclusive end of its slice. Vectorized."""
        ts = np.asarray(timestamps, dtype=np.int64)
        w = self.slice_width
        start = ts - np.remainder(ts - self.offset, w)
        return start + w

    def window_ends_for_slice(self, slice_end: int) -> List[int]:
        """All window ends this slice contributes to (ascending)."""
        first = _align_up(slice_end, self.slide, self.offset)
        last = slice_end + self.size - self.slice_width
        return list(range(first, last + 1, self.slide))

    def slice_ends_for_window(self, window_end: int) -> List[int]:
        """The slices making up window (window_end - size, window_end]."""
        first = window_end - self.size + self.slice_width
        return list(range(first, window_end + 1, self.slice_width))

    def last_window_ends(self, slice_ends: np.ndarray) -> np.ndarray:
        """Vectorized last participating window end per slice (must agree
        exactly with ``window_ends_for_slice(se)[-1]``)."""
        se = np.asarray(slice_ends, dtype=np.int64)
        w = se + self.size - self.slice_width
        return w - np.remainder(w - self.offset, self.slide)

    def window_start(self, window_end: int) -> int:
        return window_end - self.size


def _align_up(t: int, step: int, offset: int = 0) -> int:
    """Smallest multiple of ``step`` (+offset) that is >= t."""
    r = (t - offset) % step
    return t if r == 0 else t + (step - r)


class TumblingEventTimeWindows(WindowAssigner):
    """One slice per window, fire = emit slice."""

    def __init__(self, size_ms: int, offset_ms: int = 0):
        super().__init__(size=size_ms, slide=size_ms, slice_width=size_ms,
                         offset=offset_ms)

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size_ms, offset_ms)


class SlidingEventTimeWindows(WindowAssigner):
    """HOP windows with slice sharing: slice width = gcd(size, slide)."""

    def __init__(self, size_ms: int, slide_ms: int, offset_ms: int = 0):
        width = math.gcd(size_ms, slide_ms)
        super().__init__(size=size_ms, slide=slide_ms, slice_width=width,
                         offset=offset_ms)

    @staticmethod
    def of(size_ms: int, slide_ms: int,
           offset_ms: int = 0) -> "SlidingEventTimeWindows":
        return SlidingEventTimeWindows(size_ms, slide_ms, offset_ms)
