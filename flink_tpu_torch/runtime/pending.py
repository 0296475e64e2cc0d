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

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.observe import flight_recorder as flight


class _NullSection:
    """The section of an engine with no watchdog: times nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_SECTION = _NullSection()


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

    __slots__ = ("host", "fence", "build", "dispatched_at", "watchdog")

    def __init__(self, tensors: Sequence[torch.Tensor],
                 build: Callable[[List[np.ndarray]], object],
                 watchdog=None):
        self.dispatched_at = time.perf_counter()
        self.build = build
        #: an optional DeviceWatchdog: the wait for the copies is a
        #: deadline-tracked section (a fire whose copies never land is a
        #: dead device)
        self.watchdog = watchdog
        # from a CUDA tensor, non_blocking=True copies into pinned memory
        self.host = [t.to("cpu", non_blocking=True) for t in tensors]
        self.fence = Fence(tensors[0].device) if tensors else None

    def ready(self) -> bool:
        return self.fence is None or self.fence.is_ready()

    def harvest(self) -> Optional[object]:
        """Wait for the copies (if still in flight) and build the result."""
        # chaos: a harvest failure — the fire was dispatched but its
        # device-to-host results never land
        chaos.fault_point("harvest.pending_fire", arrays=len(self.host))
        with flight.span("fire.harvest"):
            if self.fence is not None:
                with (self.watchdog.section("pending_harvest")
                      if self.watchdog is not None else NULL_SECTION):
                    self.fence.block_until_ready()
            return self.build([h.numpy() for h in self.host])


def harvest_to_host(tensors) -> List[np.ndarray]:
    """Host copies of ``tensors`` through ONE device-to-host copy: their
    bytes are concatenated on the device (widest dtype first, so every
    part stays aligned) and split again on the host. CPU tensors come
    back as their arrays."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    flat = torch.cat([tensors[i].contiguous().view(-1).view(torch.uint8)
                      for i in order]).cpu()
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    off = 0
    for i in order:
        t = tensors[i]
        nb = t.numel() * t.element_size()
        out[i] = flat[off:off + nb].view(t.dtype).view(t.shape).numpy()
        off += nb
    return out
