"""Async I/O: overlap external lookups with stream processing (port of
``flink_tpu/runtime/async_operator.py``).

The unit of async work is a whole RecordBatch, run on a thread pool.
Capacity bounds the batches in flight; when it is full, ``process_batch``
blocks on the oldest. Results leave in submission order (ordered) or as
they complete (unordered), on later operator calls and at the watermark
and close drains; a request past its timeout goes to
``AsyncFunction.timeout``.
"""

from __future__ import annotations

import collections
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Callable, List, Optional

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.operators import Operator


class AsyncFunction:
    """Override ``invoke``; optional ``timeout`` fallback (the reference's
    AsyncFunction.timeout — default re-raises, failing the job)."""

    def invoke(self, batch: RecordBatch) -> RecordBatch:
        raise NotImplementedError

    def timeout(self, batch: RecordBatch) -> Optional[RecordBatch]:
        raise TimeoutError("async request timed out")

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass


class _FnAsyncFunction(AsyncFunction):
    def __init__(self, fn: Callable[[RecordBatch], RecordBatch]):
        self.fn = fn

    def invoke(self, batch):
        return self.fn(batch)


class AsyncWaitOperator(Operator):
    name = "async_wait"

    def __init__(self, fn, ordered: bool = True, capacity: int = 8,
                 timeout_ms: Optional[int] = None, workers: int = 8):
        self.fn = fn if isinstance(fn, AsyncFunction) else _FnAsyncFunction(fn)
        self.ordered = ordered
        self.capacity = max(int(capacity), 1)
        self.timeout_s = timeout_ms / 1000.0 if timeout_ms else None
        self.workers = workers
        self._pool: Optional[ThreadPoolExecutor] = None
        # (future, input_batch) in submission order
        self._inflight: collections.deque = collections.deque()

    def open(self, ctx):
        self._pool = ThreadPoolExecutor(
            max_workers=min(self.workers, self.capacity),
            thread_name_prefix="async-wait")
        self.fn.open()

    # -- result harvesting ---------------------------------------------------

    def _result(self, fut: Future, batch: RecordBatch) -> Optional[RecordBatch]:
        try:
            return fut.result(timeout=self.timeout_s)
        except (TimeoutError, _FutTimeout):
            fut.cancel()
            return self.fn.timeout(batch)

    def _harvest(self, block_for_one: bool) -> List[RecordBatch]:
        outs: List[RecordBatch] = []
        inflight = self._inflight
        if self.ordered:
            while inflight and (inflight[0][0].done() or block_for_one):
                fut, b = inflight.popleft()
                r = self._result(fut, b)
                if r is not None and len(r):
                    outs.append(r)
                block_for_one = False
        else:
            if block_for_one and inflight and not any(
                    f.done() for f, _ in inflight):
                wait([f for f, _ in inflight], timeout=self.timeout_s,
                     return_when=FIRST_COMPLETED)
            pending = collections.deque()
            for fut, b in inflight:
                if fut.done():
                    r = self._result(fut, b)
                    if r is not None and len(r):
                        outs.append(r)
                else:
                    pending.append((fut, b))
            # timeout path: if still over capacity, force the oldest
            while len(pending) >= self.capacity:
                fut, b = pending.popleft()
                r = self._result(fut, b)
                if r is not None and len(r):
                    outs.append(r)
            self._inflight = pending
        return outs

    # -- operator hooks ------------------------------------------------------

    def process_batch(self, batch, input_index=0):
        outs = self._harvest(block_for_one=len(self._inflight) >= self.capacity)
        self._inflight.append((self._pool.submit(self.fn.invoke, batch), batch))
        return outs

    def process_watermark(self, watermark, input_index=0):
        # a watermark may not overtake pending results: drain everything
        # in-flight first (the reference stalls the watermark in the
        # ordered queue the same way)
        outs: List[RecordBatch] = []
        while self._inflight:
            if self.ordered:
                outs.extend(self._harvest(block_for_one=True))
            else:
                fut, b = self._inflight.popleft()
                r = self._result(fut, b)
                if r is not None and len(r):
                    outs.append(r)
        return outs

    def close(self):
        outs = self.process_watermark(None)
        self.fn.close()
        self._pool.shutdown(wait=False)
        return outs

    def dispose(self):
        for fut, _ in self._inflight:
            fut.cancel()
        self._inflight.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self.fn.close()

    # -- checkpoint ----------------------------------------------------------
    # reference: AsyncWaitOperator snapshots its work queue of *input*
    # elements and replays the async requests on restore — results of
    # in-flight requests have not been emitted yet, so replaying keeps
    # emission exactly-once (the async function itself runs at-least-once,
    # as in the reference).

    def snapshot_state(self):
        return {
            "pending_inputs": [dict(b.columns) for _, b in self._inflight],
        }

    def restore_state(self, state):
        for cols in state.get("pending_inputs", []):
            b = RecordBatch(cols)
            self._inflight.append((self._pool.submit(self.fn.invoke, b), b))
