"""The benchmark's own source and sink, written to the port's connector API.

``ReplaySource`` hands out the replayed stream (``events.Pool``): as fast as
the executor polls (``rate=None``: the executor's micro-batch per poll), or
open loop, where event ``i`` is due ``i / rate`` s after the first poll and a
poll returns everything due so far, up to one micro-batch, the way a Kafka
poll returns what is available. It returns ``None`` once ``seconds`` have
passed since its first poll (or ``max_events`` are out).

``RecordingSink`` keeps every result row with the host clock at its arrival.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.connectors.sinks import Sink
from flink_tpu_torch.connectors.sources import Source
from flink_tpu_torch.core.records import RecordBatch

from streambench.events import Pool


class ReplaySource(Source):
    bounded = False

    def __init__(self, pool: Pool, seconds: float,
                 rate: Optional[float] = None,
                 max_events: Optional[int] = None):
        self.pool = pool
        self.seconds = float(seconds)
        self.rate = None if rate is None else float(rate)
        self.max_events = max_events
        self.first: Optional[float] = None
        self.handed = 0
        #: open loop: per poll, its time minus the due time of the oldest
        #: event it returned (s)
        self.lags: List[float] = []

    def due(self, g) -> np.ndarray:
        """Host clock (``time.perf_counter``) at which events ``g`` were due."""
        return self.first + np.asarray(g, dtype=np.float64) / self.rate

    def _closed(self, now: float) -> bool:
        return (now - self.first >= self.seconds
                or (self.max_events is not None
                    and self.handed >= self.max_events))

    def poll_batch(self, max_records: int) -> Optional[RecordBatch]:
        now = time.perf_counter()
        if self.first is None:
            self.first = now
        if self._closed(now):
            return None
        a = self.handed
        n = max_records
        if self.rate is not None:
            due = math.floor((now - self.first) * self.rate) + 1
            while due <= a:
                time.sleep(min((a + 1 - due) / self.rate, 0.002))
                now = time.perf_counter()
                if self._closed(now):
                    return None
                due = math.floor((now - self.first) * self.rate) + 1
            n = min(n, due - a)
            self.lags.append(now - float(self.due(a)))
        if self.max_events is not None:
            n = min(n, self.max_events - a)
        cols, ts = self.pool.take(a, a + n)
        self.handed = a + n
        return RecordBatch.from_pydict(cols, timestamps=ts)


class RecordingSink(Sink):
    def __init__(self, columns: Sequence[str]):
        self.columns = tuple(columns)
        self._arrivals: List[float] = []
        self._batches: List[Dict[str, np.ndarray]] = []

    def write(self, batch: RecordBatch) -> None:
        t = time.perf_counter()
        if len(batch) == 0:
            return
        self._arrivals.append(t)
        self._batches.append({c: np.array(batch[c]) for c in self.columns})

    def rows(self) -> Dict[str, np.ndarray]:
        """Every row received, with ``_arrival``: the host clock at its
        batch's arrival."""
        sizes = [len(b[self.columns[0]]) for b in self._batches]
        out = {c: (np.concatenate([b[c] for b in self._batches])
                   if self._batches else np.zeros(0))
               for c in self.columns}
        out["_arrival"] = np.repeat(np.array(self._arrivals), sizes)
        return out
