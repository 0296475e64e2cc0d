"""Shuffle SPI — the pluggable data plane between subtasks (port of
``flink_tpu/runtime/shuffle_spi.py``).

reference: flink-runtime/.../runtime/shuffle/ShuffleEnvironment.java (TM-side
factory for writers/readers), ShuffleServiceFactory.java (pluggability),
io/network/api/writer/RecordWriter.java:105 (emit -> channel selection),
io/network/partition/consumer/RemoteInputChannel.java:114,374 (credit-based
flow control: the receiver grants credits equal to free buffers; the sender
only sends with credit, bounding in-flight data and producing natural
backpressure).

The unit in flight is a columnar RecordBatch (not a serialized record), and
a "buffer" of credit is one batch. Built-in transports:

- ``LocalShuffleService`` — bounded in-process queues (threads within one
  process). The credit IS the queue bound.
- ``sort-merge`` (``runtime/sort_merge_shuffle.py``) — the batch data
  plane: partitions spill as encoded runs.

The reference's ``grpc`` transport (``cluster/rpc_shuffle.py``) is ROADMAP
Queue A item 12c; selecting it raises naming the item.

Within one keyed mesh operator the data plane is NOT this module: records
reach their shards through the device exchange (``parallel/shuffle.py``).
This SPI connects *subtasks* — pipeline stages and parallel instances.
"""

from __future__ import annotations

import queue as _q
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from flink_tpu_torch.core.records import RecordBatch

#: sentinel channel events (travel in-band, like the reference's
#: EndOfPartitionEvent / CheckpointBarrier)
END_OF_PARTITION = "__eop__"


class Barrier:
    """Checkpoint barrier riding the data channels (reference:
    io/network/api/CheckpointBarrier). Aligned handling is the consumer's
    job; ``unaligned`` barriers instead OVERTAKE queued data (reference:
    CheckpointBarrier.asUnaligned + the priority-event path of
    CheckpointedInputGate) — the overtaken batches become channel state
    in the snapshot so the checkpoint never waits behind a backpressured
    backlog. Savepoints are always aligned (reference: savepoints force
    alignment)."""

    __slots__ = ("checkpoint_id", "savepoint", "stop", "unaligned")

    def __init__(self, checkpoint_id: int, savepoint: Optional[str] = None,
                 stop: bool = False, unaligned: bool = False):
        self.checkpoint_id = checkpoint_id
        self.savepoint = savepoint
        self.stop = stop
        self.unaligned = unaligned and savepoint is None

    def __repr__(self):
        return f"Barrier({self.checkpoint_id})"


class ResultPartitionWriter:
    """One producer subtask's view of its output partition: emit a batch to
    one subpartition (consumer channel), broadcast events to all."""

    def emit(self, subpartition: int, batch: RecordBatch) -> None:
        raise NotImplementedError

    def broadcast_event(self, event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Broadcast END_OF_PARTITION and release resources."""
        raise NotImplementedError


class InputGate:
    """One consumer subtask's view of its inputs: a union of channels, one
    per producer subtask."""

    num_channels: int

    def poll(self, timeout: float = 0.0):
        """Next (channel_index, item) where item is a RecordBatch, Barrier,
        a watermark (int), or END_OF_PARTITION. None on timeout."""
        raise NotImplementedError

    def take_inflight(self, channel: int, checkpoint_id: int) -> list:
        """Batches an unaligned barrier overtook on ``channel`` (channel
        state). Transports without overtaking return [] — the consumer's
        capture-while-polling then covers all pre-barrier data."""
        return []

    def close(self) -> None:
        raise NotImplementedError


class ShuffleService:
    """SPI: creates the writers/readers connecting subtasks (reference:
    ShuffleEnvironment.createResultPartitionWriters / createInputGates)."""

    def create_partition(self, partition_id: str, num_subpartitions: int,
                         credits_per_channel: int = 2
                         ) -> ResultPartitionWriter:
        raise NotImplementedError

    def create_gate(self, partition_ids: Sequence[str], subpartition: int
                    ) -> InputGate:
        """A gate consuming subpartition ``subpartition`` of every listed
        partition (one channel per producer)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Local (in-process) transport with credit-based flow control
# ---------------------------------------------------------------------------


class _Subpartition:
    """One (producer, consumer-channel) pipe. ``credits`` mirrors the
    reference's buffer-backed credit: the producer blocks once
    ``credits_per_channel`` items are in flight; consuming an item grants
    the credit back (RemoteInputChannel.notifyCreditAvailable).

    Unaligned barriers use ``put_front``: the barrier jumps ahead of the
    queued data batches, and those overtaken batches are recorded as the
    channel's in-flight state for that checkpoint (reference:
    ChannelStateWriterImpl persisting the buffers a priority barrier
    overtook)."""

    def __init__(self, credits_per_channel: int):
        import collections

        self._data = collections.deque()
        self._prio = collections.deque()
        self._cond = threading.Condition()
        self.credits = threading.Semaphore(credits_per_channel)
        #: checkpoint_id -> [overtaken RecordBatches] (consumer pops)
        self._inflight: Dict[int, list] = {}

    def put(self, item, is_event: bool, cancelled: Callable[[], bool]) -> None:
        if not is_event:
            # events (watermarks, barriers, EOP) ride credit-free like the
            # reference's priority events — only data consumes credit
            while not self.credits.acquire(timeout=0.05):
                if cancelled():
                    return
        with self._cond:
            self._data.append(item)
            self._cond.notify()

    def put_front(self, barrier) -> None:
        """Unaligned barrier: overtake queued data, snapshotting the
        overtaken batches as this channel's in-flight state."""
        with self._cond:
            self._inflight.setdefault(barrier.checkpoint_id, []).extend(
                b for b in self._data if isinstance(b, RecordBatch))
            self._prio.append(barrier)
            self._cond.notify()

    def take_inflight(self, checkpoint_id: int) -> list:
        with self._cond:
            return self._inflight.pop(checkpoint_id, [])

    def get(self, timeout: float):
        with self._cond:
            if not self._prio and not self._data:
                if not timeout or not self._cond.wait_for(
                        lambda: self._prio or self._data, timeout):
                    raise _q.Empty
            item = self._prio.popleft() if self._prio else \
                self._data.popleft()
        if isinstance(item, RecordBatch):
            self.credits.release()
        return item


class LocalShuffleService(ShuffleService):
    """In-process transport: subtasks are threads, channels are bounded
    queues. Also the reference's default for its MiniCluster tests."""

    def __init__(self, default_credits: int = 2):
        self._partitions: Dict[str, "_LocalPartition"] = {}
        self._lock = threading.Lock()
        self._cancelled = threading.Event()
        self._default_credits = default_credits

    def cancel(self) -> None:
        """Release all producers blocked on credits (job teardown)."""
        self._cancelled.set()

    def _partition(self, partition_id: str, num_subpartitions: int,
                   credits: Optional[int] = None) -> "_LocalPartition":
        with self._lock:
            part = self._partitions.get(partition_id)
            if part is None:
                part = _LocalPartition(partition_id, num_subpartitions,
                                       credits or self._default_credits)
                self._partitions[partition_id] = part
            else:
                # a gate may materialize the partition before its writer
                # (the SPI mandates no ordering) — grow to the larger view,
                # re-crediting if the writer brought an explicit window
                part.ensure(num_subpartitions, credits)
            return part

    def create_partition(self, partition_id: str, num_subpartitions: int,
                         credits_per_channel: int = 2) -> "LocalWriter":
        part = self._partition(partition_id, num_subpartitions,
                               credits=credits_per_channel)
        return LocalWriter(part, self._cancelled)

    def create_gate(self, partition_ids: Sequence[str], subpartition: int
                    ) -> "LocalGate":
        parts = [self._partition(pid, subpartition + 1)
                 for pid in partition_ids]
        return LocalGate(parts, subpartition)


class _LocalPartition:
    def __init__(self, partition_id: str, num_subpartitions: int,
                 credits_per_channel: int):
        self.partition_id = partition_id
        self.credits = credits_per_channel
        self.subpartitions = [
            _Subpartition(credits_per_channel)
            for _ in range(num_subpartitions)
        ]

    def ensure(self, num: int, credits: Optional[int] = None) -> None:
        """Grow to ``num`` subpartitions. A WIDER credit window from the
        writer grants the extra permits to channels materialized
        gate-first with the default (gates hold channel references, so
        the semaphore is adjusted in place; narrowing is not supported —
        outstanding credits cannot be revoked)."""
        if credits is not None and credits > self.credits:
            extra = credits - self.credits
            self.credits = credits
            for sp in self.subpartitions:
                for _ in range(extra):
                    sp.credits.release()
        while len(self.subpartitions) < num:
            self.subpartitions.append(_Subpartition(self.credits))


class LocalWriter(ResultPartitionWriter):
    def __init__(self, partition: _LocalPartition, cancelled: threading.Event):
        self.partition = partition
        self._cancelled = cancelled

    def emit(self, subpartition: int, batch: RecordBatch) -> None:
        self.partition.subpartitions[subpartition].put(
            batch, is_event=False, cancelled=self._cancelled.is_set)

    def broadcast_event(self, event) -> None:
        if isinstance(event, Barrier) and event.unaligned:
            for sp in self.partition.subpartitions:
                sp.put_front(event)
            return
        for sp in self.partition.subpartitions:
            sp.put(event, is_event=True, cancelled=self._cancelled.is_set)

    def close(self) -> None:
        self.broadcast_event(END_OF_PARTITION)


class LocalGate(InputGate):
    """Fair-ish polling over the channels of one subpartition index."""

    def __init__(self, partitions: List[_LocalPartition], subpartition: int):
        self._chans = [p.subpartitions[subpartition] for p in partitions]
        self.num_channels = len(self._chans)
        self._rr = 0

    def poll(self, timeout: float = 0.0):
        n = self.num_channels
        deadline = None
        while True:
            for i in range(n):
                ch = (self._rr + i) % n
                try:
                    item = self._chans[ch].get(timeout=0)
                    self._rr = (ch + 1) % n
                    return ch, item
                except _q.Empty:
                    continue
            if not timeout:
                return None
            if deadline is None:
                import time as _t

                deadline = _t.monotonic() + timeout
                continue
            import time as _t

            if _t.monotonic() >= deadline:
                return None
            # block briefly on one channel to avoid spinning
            try:
                item = self._chans[self._rr].get(timeout=min(
                    0.01, max(deadline - _t.monotonic(), 0.001)))
                ch = self._rr
                self._rr = (ch + 1) % n
                return ch, item
            except _q.Empty:
                continue

    def take_inflight(self, channel: int, checkpoint_id: int) -> list:
        return self._chans[channel].take_inflight(checkpoint_id)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Partitioners (reference: streaming/runtime/partitioner/*)
# ---------------------------------------------------------------------------


class Partitioner:
    """Routes a batch's records to output subpartitions (reference:
    StreamPartitioner.selectChannel — but vectorized: one call splits a
    whole batch into per-channel sub-batches)."""

    def partition(self, batch: RecordBatch, num_channels: int
                  ) -> List[Tuple[int, RecordBatch]]:
        raise NotImplementedError


class KeyGroupPartitioner(Partitioner):
    """keyBy routing: key -> key group -> owning subtask (reference:
    KeyGroupStreamPartitioner.java:55)."""

    def __init__(self, key_field: str, max_parallelism: int = 128):
        self.key_field = key_field
        self.max_parallelism = max_parallelism

    def partition(self, batch, num_channels):
        import numpy as np

        from flink_tpu_torch.state.keygroups import (
            assign_key_groups,
            hash_keys_to_i64,
            key_group_to_operator_index,
        )

        key_ids = hash_keys_to_i64(batch[self.key_field])
        groups = assign_key_groups(key_ids, self.max_parallelism)
        targets = key_group_to_operator_index(
            groups, self.max_parallelism, num_channels)
        return [(ch, batch.filter(targets == ch))
                for ch in np.unique(targets).tolist()]


class RebalancePartitioner(Partitioner):
    """Round-robin at batch granularity: each whole micro-batch goes to
    the next channel (reference: RebalancePartitioner — per record there;
    the batch IS the unit here, keeping batches device-sized)."""

    def __init__(self):
        self._next = 0

    def partition(self, batch, num_channels):
        ch = self._next
        self._next = (ch + 1) % num_channels
        return [(ch, batch)]


class BroadcastPartitioner(Partitioner):
    """Every channel sees every record (reference: BroadcastPartitioner —
    backs broadcast state)."""

    def partition(self, batch, num_channels):
        return [(ch, batch) for ch in range(num_channels)]


class ForwardPartitioner(Partitioner):
    """Producer subtask i feeds consumer subtask i only (reference:
    ForwardPartitioner — the chaining-eligible edge)."""

    def __init__(self, producer_index: int):
        self.producer_index = producer_index

    def partition(self, batch, num_channels):
        return [(self.producer_index % num_channels, batch)]


class RescalePartitioner(Partitioner):
    """Round-robin over the consumer subset assigned to this producer
    (reference: RescalePartitioner — locality-friendly redistribution for
    producer/consumer parallelism ratios)."""

    def __init__(self, producer_index: int, num_producers: int):
        self.producer_index = producer_index
        self.num_producers = num_producers
        self._i = 0

    def partition(self, batch, num_channels):
        if num_channels >= self.num_producers:
            per = num_channels // self.num_producers
            base = self.producer_index * per
            span = per if self.producer_index < self.num_producers - 1 \
                else num_channels - base
        else:
            base = self.producer_index * num_channels // self.num_producers
            span = 1
        ch = base + (self._i % max(span, 1))
        self._i += 1
        return [(ch, batch)]


# ---------------------------------------------------------------------------
# Factory registry (reference: ShuffleServiceFactory discovery)
# ---------------------------------------------------------------------------

_FACTORIES: Dict[str, Callable[[], ShuffleService]] = {
    "local": LocalShuffleService,
}


def register_shuffle_service(name: str,
                             factory: Callable[[], ShuffleService]) -> None:
    _FACTORIES[name] = factory


#: built-in services that register themselves on import — configuring
#: shuffle.service must not require the user to import the module
_LAZY_MODULES = {
    "sort-merge": "flink_tpu_torch.runtime.sort_merge_shuffle",
}


def create_shuffle_service(name: str = "local") -> ShuffleService:
    if name == "grpc" and name not in _FACTORIES:
        raise NotImplementedError(
            "shuffle.service 'grpc' (cluster/rpc_shuffle.py) is not ported "
            "to flink_tpu_torch yet (ROADMAP.md, Queue A item 12c)")
    if name not in _FACTORIES and name in _LAZY_MODULES:
        import importlib

        importlib.import_module(_LAZY_MODULES[name])
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown shuffle.service {name!r}; registered: "
            f"{sorted(_FACTORIES)}") from None
    return factory()
