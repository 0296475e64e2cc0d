"""Bounded sources that hold their end of stream until released: the cut
at which a running job's point queries are checked against an oracle.

A held source hands out its inner source's batches; once those are done
it returns empty batches (which every executor skips, as it does an idle
source) and writes ``<hold_dir>/held``, until ``<hold_dir>/release``
exists; then it ends the stream and the job fires what is open. The flags
are files, so a job graph shipped to a TaskExecutor (pickled, unpickled
in its own task) is held and released the same way.

``settle(query, rounds)`` turns "the source is held" into "the job has
consumed every record": each query is served at a batch boundary of the
task loop, and each loop iteration takes at most one pumped batch per
source, so after ``in-flight batches + 2`` sequential queries the pumps'
queues are empty. It then repeats until two answers in a row agree, which
covers executors whose channels hold more (the stage executor).
"""

from __future__ import annotations

import os
import time

from flink_tpu_torch.benchmarks.nexmark import BidSource
from flink_tpu_torch.connectors.sources import DataGenSource
from flink_tpu_torch.core.records import RecordBatch


class _HoldEnd:
    """The hold: mixed in before a bounded source class."""

    #: poll interval while holding (s): a pump thread polls in a loop
    hold_poll_s = 0.001

    def _init_hold(self, hold_dir: str) -> None:
        self.hold_dir = str(hold_dir)
        os.makedirs(self.hold_dir, exist_ok=True)
        self.records_out = 0

    def poll_batch(self, max_records):
        batch = super().poll_batch(max_records)
        if batch is not None:
            self.records_out += len(batch)
            return batch
        if os.path.exists(os.path.join(self.hold_dir, "release")):
            return None
        held = os.path.join(self.hold_dir, "held")
        if not os.path.exists(held):
            with open(held, "w") as f:
                f.write(str(self.records_out))
        time.sleep(self.hold_poll_s)
        return RecordBatch({})


class HeldBidSource(_HoldEnd, BidSource):
    """``BidSource`` whose end of stream waits for ``release``."""

    def __init__(self, hold_dir: str, *args, **kwargs):
        BidSource.__init__(self, *args, **kwargs)
        self._init_hold(hold_dir)


class HeldDataGenSource(_HoldEnd, DataGenSource):
    """``DataGenSource`` whose end of stream waits for ``release``."""

    def __init__(self, hold_dir: str, *args, **kwargs):
        DataGenSource.__init__(self, *args, **kwargs)
        self._init_hold(hold_dir)


def wait_held(hold_dir: str, timeout_s: float = 600.0) -> int:
    """Block until the source holds; returns the records it handed out."""
    held = os.path.join(hold_dir, "held")
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(held):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the source never held ({hold_dir})")
        time.sleep(0.005)
    time.sleep(0.002)
    with open(held) as f:
        return int(f.read() or 0)


def release(hold_dir: str) -> None:
    """End the held stream: the job fires what is open and finishes."""
    with open(os.path.join(hold_dir, "release"), "w") as f:
        f.write("1")


def settle(query, rounds: int = 4, max_rounds: int = 200):
    """Sequential ``query()`` calls until the job has consumed every record
    the held source handed out: at least ``rounds`` of them, then until two
    answers in a row are equal (by ``repr``, so NaN answers compare).
    Returns the last answer."""
    last = repr(query())
    for i in range(1, max_rounds):
        ans = query()
        cur = repr(ans)
        if i >= rounds and cur == last:
            return ans
        last = cur
    raise RuntimeError("the job's state did not settle at the held cut")
