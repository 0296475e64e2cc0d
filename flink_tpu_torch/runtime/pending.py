"""Deferred device work: dispatch fences and asynchronous window-fire
results (port of ``flink_tpu/runtime/pending.py``).

A window fire is *dispatched* (its programs enqueued, the device->host
copies of its outputs started) and *harvested* later, once the copies have
landed; the executor keeps ingesting in between and holds the covering
watermark back until the results are emitted. On a CUDA device the copies
go to pinned host memory (``non_blocking``) and a CUDA event marks their
completion; on the CPU everything is ready at once.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


class Fence:
    """Proof that the device finished everything enqueued before it: a
    CUDA event recorded on the current stream (None on the CPU, where
    every program ran before it returned). ``value``: the small device
    read the fence was enqueued behind, if any."""

    __slots__ = ("event", "value")

    def __init__(self, device: torch.device, value=None):
        self.value = value
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def block_until_ready(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class PendingFire:
    """A dispatched-but-unharvested fire: host copies of the device output
    tensors (in flight) plus a host-side finisher that assembles the result
    batch once the bytes land."""

    __slots__ = ("host", "fence", "build", "dispatched_at")

    def __init__(self, tensors: Sequence[torch.Tensor],
                 build: Callable[[List[np.ndarray]], object]):
        self.dispatched_at = time.perf_counter()
        self.build = build
        # from a CUDA tensor, non_blocking=True copies into pinned memory
        self.host = [t.to("cpu", non_blocking=True) for t in tensors]
        self.fence = Fence(tensors[0].device) if tensors else None

    def ready(self) -> bool:
        return self.fence is None or self.fence.is_ready()

    def harvest(self) -> Optional[object]:
        """Wait for the copies (if still in flight) and build the result."""
        if self.fence is not None:
            self.fence.block_until_ready()
        return self.build([h.numpy() for h in self.host])
