"""Host-side window lifecycle bookkeeping (port of
``flink_tpu/windowing/bookkeeping.py``): the pending-window heap, the slice
cleanup heap, late-record dropping, and the fire/release ordering on
watermark advance. Pure host metadata — the engines own the state planes.

A window first fires when the watermark passes its end; its slices are
retained for ``allowed_lateness`` more event-time ms, and a late record
landing in a retained slice re-schedules the windows it contributes to.
Records whose slices are past retention are dropped. The snapshot and
restore methods belong to the checkpoint slice.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Set

import numpy as np

from flink_tpu_torch.windowing.assigners import WindowAssigner

_NEG_INF = -(1 << 62)


class SliceBookkeeper:
    def __init__(self, assigner: WindowAssigner, allowed_lateness: int = 0):
        self.assigner = assigner
        self.allowed_lateness = allowed_lateness
        self._pending: List[int] = []
        self._pending_set: Set[int] = set()
        # slice end -> last participating window end (live slices)
        self._slice_last_window: Dict[int, int] = {}
        # (cleanup_time, slice_end): slice freed when watermark >= cleanup
        self._cleanup: List[tuple] = []
        self.watermark: int = _NEG_INF
        self.max_fired_end: int = _NEG_INF
        self.late_records_dropped = 0

    def live_mask(self, slice_ends: np.ndarray) -> Optional[np.ndarray]:
        """Late-record filter: None when nothing is dropped, else the mask
        of records whose slice is still within retention."""
        if self.watermark <= _NEG_INF // 2:
            return None
        oldest = int(np.asarray(slice_ends).min())
        oldest_last = int(self.assigner.last_window_ends(
            np.asarray([oldest], dtype=np.int64))[0])
        if oldest_last - 1 + self.allowed_lateness > self.watermark:
            return None
        last_ends = self.assigner.last_window_ends(slice_ends)
        live = last_ends - 1 + self.allowed_lateness > self.watermark
        dropped = len(live) - int(live.sum())
        if dropped == 0:
            return None
        self.late_records_dropped += dropped
        return live

    def register_slices(self, slice_ends: np.ndarray,
                        uniq: Optional[np.ndarray] = None) -> None:
        """Track new slices and (re-)schedule their windows."""
        lateness = self.allowed_lateness
        if uniq is None:
            uniq = np.unique(slice_ends)
        for se in uniq.tolist():
            ends = None
            if se not in self._slice_last_window:
                ends = self.assigner.window_ends_for_slice(se)
                last = ends[-1]
                self._slice_last_window[se] = last
                heapq.heappush(self._cleanup, (last - 1 + lateness, se))
            elif lateness > 0:
                ends = self.assigner.window_ends_for_slice(se)
            if ends is None:
                continue
            for w in ends:
                if (w - 1 + lateness > self.watermark
                        and w not in self._pending_set):
                    self._pending_set.add(w)
                    heapq.heappush(self._pending, w)

    def next_window(self, watermark: int) -> Optional[int]:
        """Pop the next window due at ``watermark`` (end-1 <= watermark)."""
        self.watermark = max(self.watermark, watermark)
        if self._pending and self._pending[0] - 1 <= watermark:
            w_end = heapq.heappop(self._pending)
            self._pending_set.discard(w_end)
            return w_end
        return None

    def mark_fired(self, window_end: int) -> None:
        self.max_fired_end = max(self.max_fired_end, window_end)

    def expired_slices(self, watermark: int) -> List[int]:
        """Slices past retention at ``watermark`` — free their state.
        Call after the fire loop of the same watermark."""
        self.watermark = max(self.watermark, watermark)
        out: List[int] = []
        while self._cleanup and self._cleanup[0][0] <= watermark:
            _, se = heapq.heappop(self._cleanup)
            if se in self._slice_last_window:
                del self._slice_last_window[se]
                out.append(se)
        return out
