"""Window assigners built around slices (port of
``flink_tpu/windowing/assigners.py``: tumbling, sliding and cumulative
event time, tumbling and sliding processing time, and event-time
sessions).

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

from flink_tpu_torch.core.annotations import public, public_evolving


@dataclasses.dataclass(frozen=True)
class WindowAssigner:
    """Base: maps timestamps -> slice ends, and window ends -> slice ranges."""

    size: int            # full window span (ms)
    slide: int           # distance between consecutive window ends (ms)
    slice_width: int     # width of one slice (ms)
    offset: int = 0

    @property
    def slices_per_window(self) -> int:
        return self.size // self.slice_width

    @property
    def is_merging(self) -> bool:
        return False

    def assign_slice_ends(self, timestamps: np.ndarray) -> np.ndarray:
        """Each record -> exclusive end of its slice. Vectorized."""
        ts = np.asarray(timestamps, dtype=np.int64)
        w = self.slice_width
        start = ts - np.remainder(ts - self.offset, w)
        return start + w

    def slice_plan(self, slice_ends: np.ndarray):
        """(unique_ends, inverse) of a batch's slice ends without sorting
        it: slice ends are multiples of ``slice_width`` in a narrow range,
        so bucketing by ``(se - min) // width`` gives ``np.unique``'s
        answer in O(n). Falls back to ``np.unique`` for spreads over 65536
        slices (wildly out-of-order timestamps)."""
        se = np.asarray(slice_ends, dtype=np.int64)
        base = int(se.min())
        w = self.slice_width
        span = (int(se.max()) - base) // w + 1
        if span > (1 << 16):
            uniq, inv = np.unique(se, return_inverse=True)
            return uniq, inv
        sidx = (se - base) // w
        counts = np.bincount(sidx, minlength=span)
        present = np.nonzero(counts)[0]
        uniq = base + present * w
        if len(present) == span:
            return uniq, sidx
        remap = np.cumsum(counts > 0) - 1
        return uniq, remap[sidx]

    def window_ends_for_slice(self, slice_end: int) -> List[int]:
        """All window ends this slice contributes to (ascending)."""
        first = _align_up(slice_end, self.slide, self.offset)
        last = slice_end + self.size - self.slice_width
        return list(range(first, last + 1, self.slide))

    def slice_ends_for_window(self, window_end: int) -> List[int]:
        """The slices making up window (window_end - size, window_end]."""
        first = window_end - self.size + self.slice_width
        return list(range(first, window_end + 1, self.slice_width))

    def last_window_end_for_slice(self, slice_end: int) -> int:
        """After this window fires (plus lateness), the slice can be freed."""
        return self.window_ends_for_slice(slice_end)[-1]

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


@public
class TumblingEventTimeWindows(WindowAssigner):
    """One slice per window, fire = emit slice."""

    def __init__(self, size_ms: int, offset_ms: int = 0):
        super().__init__(size=size_ms, slide=size_ms, slice_width=size_ms,
                         offset=offset_ms)

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size_ms, offset_ms)


@public
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


@public_evolving
class TumblingProcessingTimeWindows(TumblingEventTimeWindows):
    """Windows over WALL-CLOCK arrival time: records are assigned by the
    time they reach the operator, fires are driven by the executor's
    processing-time ticks, not by watermarks."""

    is_processing_time = True

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0
           ) -> "TumblingProcessingTimeWindows":
        return TumblingProcessingTimeWindows(size_ms, offset_ms)


@public_evolving
class SlidingProcessingTimeWindows(SlidingEventTimeWindows):
    """HOP over arrival time, slice-shared like the event-time form."""

    is_processing_time = True

    @staticmethod
    def of(size_ms: int, slide_ms: int, offset_ms: int = 0
           ) -> "SlidingProcessingTimeWindows":
        return SlidingProcessingTimeWindows(size_ms, slide_ms, offset_ms)


@public
class CumulativeEventTimeWindows(WindowAssigner):
    """CUMULATE windows: [s, s + step), [s, s + 2 step) ... [s, s +
    max_size), one slice per step."""

    def __init__(self, max_size_ms: int, step_ms: int, offset_ms: int = 0):
        super().__init__(size=max_size_ms, slide=step_ms,
                         slice_width=step_ms, offset=offset_ms)

    def _span_start_end(self, end):
        """The first slice end of the cumulate span holding slice end(s)
        ``end``."""
        return end - (end - self.offset - self.slice_width) % self.size

    def window_ends_for_slice(self, slice_end: int) -> List[int]:
        span_end = self._span_start_end(slice_end) + self.size \
            - self.slice_width
        return list(range(slice_end, span_end + 1, self.slide))

    def slice_ends_for_window(self, window_end: int) -> List[int]:
        return list(range(self._span_start_end(window_end), window_end + 1,
                          self.slice_width))

    def window_start(self, window_end: int) -> int:
        return self._span_start_end(window_end) - self.slice_width

    def last_window_ends(self, slice_ends: np.ndarray) -> np.ndarray:
        se = np.asarray(slice_ends, dtype=np.int64)
        return self._span_start_end(se) + self.size - self.slice_width


@public
@dataclasses.dataclass(frozen=True)
class EventTimeSessionWindows:
    """Session windows with a gap: a merging assigner. Sessions merge on
    host metadata over device accumulators (``windowing/sessions.py``)."""

    gap: int

    @staticmethod
    def with_gap(gap_ms: int) -> "EventTimeSessionWindows":
        return EventTimeSessionWindows(gap=gap_ms)

    @property
    def is_merging(self) -> bool:
        return True
