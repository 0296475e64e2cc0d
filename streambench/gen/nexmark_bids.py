"""Nexmark bids (auction, bidder, price) with event time.

The laws of the Nexmark generator's ``BidGenerator`` (Apache Beam's Nexmark
suite, which Flink's nexmark suite copies), with its default configuration:

- events come in epochs of 50, one person, 3 auctions and 46 bids, so the
  last auction (person) made before bid ``b`` is ``3 * (b // 46) + 2``
  (``b // 46``), counted from 0;
- an auction is hot with probability ``1 - 1 / hot_auction_ratio``: it is
  then the first of the last ``HOT_AUCTION_RATIO`` auctions; else it is
  uniform over the ``num_in_flight_auctions`` before the last one, the last
  one and ``AUCTION_ID_LEAD`` after it;
- a bidder is hot with probability ``1 - 1 / hot_bidders_ratio``: it is
  then the second of the last ``HOT_BIDDER_RATIO`` people; else it is
  uniform over the ``num_active_people`` up to the last one and
  ``PERSON_ID_LEAD`` after it;
- a price is ``round(10 ** (6 u) * 100)`` for a uniform ``u``;
- auction and person ids start at 1000.

The Java generator draws from ``java.util.Random`` seeded by the event; here
every draw is sliced from two splitmix64 hashes of the bid's index and the
seed, so a bid is a pure function of both. Only the bids are made, as Q5
reads only them, and they are spaced evenly in event time:
``1000 / events_per_s_of_event_time`` ms a bid.
"""

from __future__ import annotations

import numpy as np

from streambench.gen.splitmix import splitmix64

PERSON_PROPORTION, AUCTION_PROPORTION, BID_PROPORTION = 1, 3, 46
HOT_AUCTION_RATIO = 100
HOT_BIDDER_RATIO = 100
AUCTION_ID_LEAD = 10
PERSON_ID_LEAD = 10
FIRST_AUCTION_ID = 1000
FIRST_PERSON_ID = 1000


def _below(bits: np.ndarray, n) -> np.ndarray:
    """A uniform whole number below ``n`` from 32 uniform bits."""
    return ((bits & np.uint64(0xFFFFFFFF)) * np.asarray(n, dtype=np.uint64)
            >> np.uint64(32)).astype(np.int64)


def generate(idx: np.ndarray, seed: int, hot_auction_ratio: int,
             num_in_flight_auctions: int, hot_bidders_ratio: int,
             num_active_people: int, events_per_s_of_event_time: int):
    """Columns and event times of the bids with global indices ``idx``."""
    idx = np.asarray(idx, dtype=np.int64)
    h1 = splitmix64(idx, seed * 4 + 1)
    h2 = splitmix64(idx, seed * 4 + 2)
    epoch = idx // BID_PROPORTION

    last_auction = epoch * AUCTION_PROPORTION + (AUCTION_PROPORTION - 1)
    lo = np.maximum(last_auction - num_in_flight_auctions, 0)
    spread = last_auction - lo + 1 + AUCTION_ID_LEAD
    hot = _below(h1, hot_auction_ratio) > 0
    auctions = np.where(
        hot, last_auction // HOT_AUCTION_RATIO * HOT_AUCTION_RATIO,
        lo + _below(h1 >> np.uint64(32), spread)) + FIRST_AUCTION_ID

    people = epoch * PERSON_PROPORTION + PERSON_PROPORTION
    active = np.minimum(people, num_active_people)
    hot = _below(h2, hot_bidders_ratio) > 0
    bidders = np.where(
        hot, (people - 1) // HOT_BIDDER_RATIO * HOT_BIDDER_RATIO + 1,
        people - active + _below(h2 >> np.uint64(32),
                                 active + PERSON_ID_LEAD)) + FIRST_PERSON_ID

    u = splitmix64(idx, seed * 4 + 3) >> np.uint64(11)
    u = u.astype(np.float64) / float(1 << 53)
    prices = np.round(np.power(10.0, u * 6.0) * 100.0).astype(np.int64)
    ts = (idx * 1000) // events_per_s_of_event_time
    return {"auction": auctions, "bidder": bidders, "price": prices}, ts
