"""The events of a run: a pool made from the seed, replayed in a cycle.

The pool holds ``n`` events of the configuration's generator. Event ``g`` of
the replayed stream is pool event ``g % n`` with its event time shifted
forward by ``g // n`` spans of the pool, where a span is the event time the
pool covers. The pool's size is a multiple of the event-time rate's events a
second, so that event ``g``'s time is ``g * 1000 // rate`` ms everywhere: the
stream's time runs on without a seam, and a key that recurs in the next
cycle opens new state, as it would in a live stream.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

Columns = Dict[str, np.ndarray]


class Pool:
    def __init__(self, generator, seed: int, params: dict, events: int):
        rate = int(params["events_per_s_of_event_time"])
        if events <= 0 or events * 1000 % rate:
            raise ValueError(
                f"a pool of {events} events does not span a whole number of "
                f"ms at {rate} events/s of event time")
        self.n = int(events)
        self.rate = rate
        self.span_ms = self.n * 1000 // rate
        self.cols, self.ts = generator.generate(
            np.arange(self.n, dtype=np.int64), int(seed), **params)

    def pieces(self, a: int, b: int) -> Iterator[Tuple[int, int, int, int]]:
        """``(g0, pool start, pool end, time shift)`` covering events
        ``[a, b)`` of the replayed stream, one piece per cycle."""
        g = a
        while g < b:
            cycle, s = divmod(g, self.n)
            e = min(self.n, s + (b - g))
            yield g, s, e, cycle * self.span_ms
            g += e - s

    def take(self, a: int, b: int) -> Tuple[Columns, np.ndarray]:
        """Columns and event times of events ``[a, b)``. The columns are
        views of the pool where they lie in one cycle."""
        parts = [({k: v[s:e] for k, v in self.cols.items()},
                  self.ts[s:e] + shift)
                 for _, s, e, shift in self.pieces(a, b)]
        if len(parts) == 1:
            return parts[0]
        return ({k: np.concatenate([p[0][k] for p in parts])
                 for k in self.cols},
                np.concatenate([p[1] for p in parts]))


class EventLog:
    """The first ``count`` events of the replayed stream: what a run's
    source handed out, which the reference recomputes from."""

    def __init__(self, pool: Pool, count: int):
        self.pool = pool
        self.count = int(count)

    def chunks(self) -> Iterator[Tuple[int, Columns, np.ndarray]]:
        """``(first global index, columns, event times)``, a cycle at a
        time."""
        p = self.pool
        for g0, s, e, shift in p.pieces(0, self.count):
            yield g0, {k: v[s:e] for k, v in p.cols.items()}, p.ts[s:e] + shift

    def ts_of(self, g: np.ndarray) -> np.ndarray:
        return (np.asarray(g, dtype=np.int64) * 1000) // self.pool.rate
