"""Nexmark Q5 and Q7 (port of the Q5 and Q7 part of
``flink_tpu/benchmarks/nexmark.py``).

Q5 (hot items): which auctions received the most bids in the last sliding
window? HOP count per auction + per-window arg-max. A fired batch holds
one whole window, so the arg-max is one vectorized pass over it.

Q7 (highest bid): the bids whose price equals their tumbling window's
maximum price: a window max joined back to the bids on the price, per
window (a diamond: one source feeds both inputs of the window join).
"""

from __future__ import annotations

import ctypes

import numpy as np

from flink_tpu_torch.connectors.sources import Source, _splitmix64
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
from flink_tpu_torch.windowing.assigners import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)


class BidSource(Source):
    """Synthetic Nexmark bid stream: (auction, bidder, price, ts).

    Deterministic: bid i is a pure function of its global index
    (splitmix64), with a hot-auction bias (``hot_ratio`` of the bids go to
    the first 1% of auctions). The native generator (native/datagen.cpp)
    and the NumPy form below produce identical streams — the same stream
    the reference's ``BidSource`` produces.
    """

    def __init__(self, total_records: int, num_auctions: int = 10_000,
                 num_bidders: int = 50_000,
                 events_per_second_of_eventtime: int = 100_000,
                 hot_ratio: float = 0.5, seed: int = 42):
        self.total = int(total_records)
        self.num_auctions = num_auctions
        self.num_bidders = num_bidders
        self.rate = events_per_second_of_eventtime
        self.hot_ratio = hot_ratio
        self.seed = seed
        self._emitted = 0
        self._stride = 1
        self._offset = 0

    def estimate_records(self):
        return self.total

    def open(self, subtask_index=0, parallelism=1):
        # strided split of the global index space: event time is a
        # function of the global index, so subtasks advance together
        self._stride = max(parallelism, 1)
        self._offset = subtask_index
        self._emitted = 0

    def poll_batch(self, max_records):
        own = (self.total - self._offset + self._stride - 1) // self._stride
        if self._emitted >= own:
            return None
        n = min(max_records, own - self._emitted)
        first = self._emitted * self._stride + self._offset
        self._emitted += n
        from flink_tpu_torch.native import load_datagen

        lib = load_datagen()
        if lib is not None:
            auctions = np.empty(n, dtype=np.int64)
            bidders = np.empty(n, dtype=np.int64)
            prices = np.empty(n, dtype=np.float32)
            ts = np.empty(n, dtype=np.int64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.ngen_bids(
                n, first, self._stride, self.seed * 4 + 1,
                self.num_auctions, self.num_bidders,
                int(self.hot_ratio * 1024), max(self.rate, 1),
                auctions.ctypes.data_as(i64p),
                bidders.ctypes.data_as(i64p),
                prices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ts.ctypes.data_as(i64p))
        else:
            idx = np.arange(n, dtype=np.int64) * self._stride + first
            auctions, bidders, prices, ts = self._generate(idx)
        return RecordBatch.from_pydict(
            {"auction": auctions, "bidder": bidders, "price": prices},
            timestamps=ts)

    def _generate(self, idx: np.ndarray):
        """One hash per record; the fields are sliced from its 64 bits
        (hot flag 10, auction uniform 22, bidder 16, price 16)."""
        u64 = _splitmix64(idx, self.seed * 4 + 1)
        hot = (u64 & np.uint64(0x3FF)).astype(np.int64) < int(
            self.hot_ratio * 1024)
        u_auction = ((u64 >> np.uint64(10)) & np.uint64(0x3FFFFF)
                     ).astype(np.float64) / (1 << 22)
        auctions = np.where(
            hot, u_auction * max(self.num_auctions // 100, 1),
            u_auction * self.num_auctions).astype(np.int64)
        bidders = (((u64 >> np.uint64(32)) & np.uint64(0xFFFF)
                    ).astype(np.int64) * self.num_bidders) >> 16
        u_price = np.maximum(
            (u64 >> np.uint64(48)).astype(np.float64) / (1 << 16), 1e-12)
        prices = ((np.power(u_price, -1.0 / 3.0) - 1.0) * 100 + 1
                  ).astype(np.float32)
        ts = (idx * 1000) // max(self.rate, 1)
        return auctions, bidders, prices, ts

    def snapshot_position(self):
        return {"emitted": self._emitted}

    def restore_position(self, pos):
        self._emitted = pos["emitted"]


def _window_argmax(field: str):
    """Per-window arg-max over one fired window's batch."""

    def fn(batch: RecordBatch):
        counts = batch[field]
        return batch.filter(counts == counts.max())

    return fn


def build_q5(env, source: BidSource, size_ms: int = 10_000,
             slide_ms: int = 2_000, device_top_k: int = 0):
    """Q5 hot items -> stream of (auction, count, window) winners.

    ``device_top_k`` > 0 keeps only the top k rows of each fired window
    (TopKFireProjector) before the arg-max; exact while the ties for the
    max fit in k."""
    from flink_tpu_torch.windowing.aggregates import CountAggregate

    projector = None
    if device_top_k:
        from flink_tpu_torch.windowing.fire_projectors import (
            TopKFireProjector,
        )

        projector = TopKFireProjector("count", k=device_top_k)
    return (
        env.from_source(source,
                        WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(size_ms, slide_ms))
        .aggregate(CountAggregate(), fire_projector=projector)
        .map(_window_argmax("count"), name="hot_items_argmax")
    )


def build_q7(env, source: BidSource, size_ms: int = 10_000):
    """Q7 highest bid -> the bid rows achieving the per-window max price.
    The window max stays float32 (its bits are the join key's), and the
    join keys on the float price against ``max_price``."""
    bids = env.from_source(
        source, WatermarkStrategy.for_bounded_out_of_orderness(0))
    bids = bids.map(lambda b: b.with_column(
        "g", np.zeros(len(b), dtype=np.int64)), name="const_key")
    maxes = (
        bids.key_by("g")
        .window(TumblingEventTimeWindows.of(size_ms))
        .max("price")
        .map(lambda b: b.drop("g"), name="drop_g")
    )
    return (
        bids.join(maxes).where("price").equal_to("max_price")
        .window(TumblingEventTimeWindows.of(size_ms))
        .apply(name="q7_join")
    )


def oracle_q7(bids, size_ms):
    """bids: iterable of (auction, bidder, price, ts). Returns
    {window_end: (max_price, [(auction, bidder)])} — plain Python, for
    tests."""
    import collections

    per_w = collections.defaultdict(list)
    for auction, bidder, price, ts in bids:
        w = ts - (ts % size_ms) + size_ms
        per_w[w].append((auction, bidder, price))
    out = {}
    for w, rows in per_w.items():
        mx = max(r[2] for r in rows)
        out[w] = (mx, [(a, b) for a, b, p in rows if p == mx])
    return out


def oracle_q5(bids, size_ms, slide_ms):
    """bids: iterable of (auction, ts). Returns {window_end: (max_count,
    set of auctions with that count)} — plain Python, for tests."""
    import collections

    counts = collections.defaultdict(lambda: collections.defaultdict(int))
    for auction, ts in bids:
        first = ts - (ts % slide_ms) + slide_ms
        for w in range(first, ts + size_ms + 1, slide_ms):
            if w - size_ms <= ts < w:
                counts[w][auction] += 1
    out = {}
    for w, per_auction in counts.items():
        best = max(per_auction.values())
        out[w] = (best, {a for a, c in per_auction.items() if c == best})
    return out
