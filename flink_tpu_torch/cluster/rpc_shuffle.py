"""RPC shuffle transport — record batches between task executors (port of
``flink_tpu/cluster/rpc_shuffle.py``).

reference: the NettyShuffleEnvironment role (io/network/NettyShuffleEnvironment
.java): the default transport moving serialized buffers between TaskManagers,
with credit-based flow control (RemoteInputChannel.java:114,374). Here the
wire unit is a columnar RecordBatch (the native framed codec of
``native/codec.py``; events through the RPC serializer), the server is
the CONSUMER side (buffers live where they are polled, like the reference's
input gates), and backpressure is the bounded consumer queue: a producer's
push blocks server-side until the subpartition has room, which blocks the
producer's RPC — the same bounded-in-flight property credits give Netty,
traded for per-call latency.

Topology: every process hosts one ``ShuffleServerEndpoint`` on its RpcService.
Partitions are LOCATED AT THEIR CONSUMER: ``RpcShuffleService`` takes a
routing function (partition_id, subpartition) -> RPC address (None = this
process). Writers route each emit; gates only ever poll local buffers.
The service registers as ``shuffle.service: grpc``, the reference's key, so
a reference configuration runs unchanged; the transport is the port's TCP
RPC (``cluster/rpc.py``), not gRPC. ``bytes_sent`` counts the encoded
bytes that crossed a socket.
"""

from __future__ import annotations

import queue as _q
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from flink_tpu_torch.cluster.rpc import RpcEndpoint, RpcService, dumps, loads
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.shuffle_spi import (
    END_OF_PARTITION,
    Barrier,
    InputGate,
    LocalGate,
    LocalShuffleService,
    ResultPartitionWriter,
    ShuffleService,
    _LocalPartition,
)


def _encode(item) -> bytes:
    if isinstance(item, RecordBatch):
        # record batches are the bulk bytes: native framed codec
        # (compressed + CRC, no pickle on the decode fast path) when the
        # library is available (native/codec.py; reference: compiled fast
        # coders + lz4 buffer compression)
        from flink_tpu_torch.native.codec import codec_available, encode_batch

        if codec_available():
            return b"B" + encode_batch(item)
        return b"P" + dumps(("batch", dict(item.columns)))
    if isinstance(item, Barrier):
        # the unaligned flag travels too (the reference's drops it)
        return b"P" + dumps(
            ("barrier", (item.checkpoint_id, item.savepoint, item.stop,
                         item.unaligned)))
    if item is END_OF_PARTITION:
        return b"P" + dumps(("eop", None))
    return b"P" + dumps(("event", item))


def _decode(payload: bytes):
    tag, payload = payload[:1], memoryview(payload)[1:]
    if tag == b"B":
        from flink_tpu_torch.native.codec import decode_batch

        return decode_batch(payload)
    kind, data = loads(payload)
    if kind == "batch":
        return RecordBatch(data)
    if kind == "barrier":
        cid, sp, stop, unaligned = data
        return Barrier(cid, savepoint=sp, stop=stop, unaligned=unaligned)
    if kind == "eop":
        return END_OF_PARTITION
    return data


class ShuffleServerEndpoint(RpcEndpoint):
    """Consumer-side buffer server: producers push items into the
    subpartition queues polled by this process's gates.

    ``push`` runs on the RPC worker thread pool, NOT the endpoint main
    thread — a blocked push (backpressure) must not stall control traffic.
    The queue's bound is the credit window.
    """

    def __init__(self, endpoint_id: str = "shuffle-server",
                 credits_per_channel: int = 2):
        super().__init__(endpoint_id)
        self.credits = credits_per_channel
        self._parts: Dict[str, _LocalPartition] = {}
        self._lock = threading.Lock()
        self._cancelled = threading.Event()

    def on_stop(self) -> None:
        # release any producer blocked on backpressure — a push stuck in
        # its credit wait would otherwise pin an RPC worker past server
        # shutdown
        self._cancelled.set()

    def partition(self, partition_id: str, num_subpartitions: int,
                  credits: Optional[int] = None) -> _LocalPartition:
        with self._lock:
            part = self._parts.get(partition_id)
            if part is None:
                part = _LocalPartition(partition_id, num_subpartitions,
                                       credits or self.credits)
                self._parts[partition_id] = part
            else:
                part.ensure(num_subpartitions, credits)
            return part

    def cancel(self) -> None:
        self._cancelled.set()

    # -- remote methods (called via gateway) --------------------------------

    def push(self, partition_id: str, subpartition: int,
             payload: bytes, is_event: bool) -> bool:
        """Blocking enqueue — the producer's RPC completes only once the
        subpartition accepted the item (bounded queue = credit window)."""
        item = _decode(payload)
        part = self.partition(partition_id, subpartition + 1)
        part.subpartitions[subpartition].put(
            item, is_event=is_event, cancelled=self._cancelled.is_set)
        return True

    def _invoke(self, method, args, kwargs, expected_token=None):
        # data-plane pushes bypass the single main thread: they may block
        # on backpressure and MUST NOT serialize behind each other or
        # control traffic (the reference likewise keeps Netty I/O threads
        # apart from the actor main thread)
        if method == "push":
            return self.push(*args, **kwargs)
        return super()._invoke(method, args, kwargs, expected_token)


class _RemoteWriter(ResultPartitionWriter):
    """Producer-side writer routing each subpartition to its consumer."""

    def __init__(self, service: "RpcShuffleService", partition_id: str,
                 num_subpartitions: int):
        self.service = service
        self.partition_id = partition_id
        self.num_subpartitions = num_subpartitions

    def _push(self, subpartition: int, item, is_event: bool) -> None:
        addr = self.service.route(self.partition_id, subpartition)
        if addr is None:
            part = self.service.server.partition(self.partition_id,
                                                 self.num_subpartitions)
            part.subpartitions[subpartition].put(
                item, is_event=is_event,
                cancelled=self.service.server._cancelled.is_set)
            return
        gw = self.service._gateway(addr)
        payload = _encode(item)
        with self.service._gw_lock:
            self.service.bytes_sent += len(payload)
        gw.push(self.partition_id, subpartition, payload, is_event)

    def emit(self, subpartition: int, batch: RecordBatch) -> None:
        self._push(subpartition, batch, is_event=False)

    def broadcast_event(self, event) -> None:
        for sub in range(self.num_subpartitions):
            self._push(sub, event, is_event=True)

    def close(self) -> None:
        self.broadcast_event(END_OF_PARTITION)


class RpcShuffleService(ShuffleService):
    """ShuffleService whose channels cross process boundaries over RPC.

    ``route(partition_id, subpartition)`` returns the consumer's RPC
    address, or None when the consumer lives in this process (then the
    local buffer is used directly — no loopback socket hop)."""

    def __init__(self, rpc_service: RpcService,
                 route: Callable[[str, int], Optional[str]],
                 server: Optional[ShuffleServerEndpoint] = None,
                 credits_per_channel: int = 2):
        self.rpc = rpc_service
        self.route = route
        if server is None:
            # one shuffle server per RpcService: a second service on the
            # same process must SHARE the registered server's buffers
            existing = self.rpc._endpoints.get("shuffle-server")
            server = existing or ShuffleServerEndpoint(
                credits_per_channel=credits_per_channel)
        self.server = server
        if self.server.endpoint_id not in self.rpc._endpoints:
            self.rpc.register(self.server)  # register() starts the endpoint
        self._gateways: Dict[str, object] = {}
        self._gw_lock = threading.Lock()
        #: encoded bytes pushed to remote consumers
        self.bytes_sent = 0
        #: set by the factory that created ``rpc_service`` for this
        #: service alone: ``close`` then stops it
        self.owns_rpc = False

    def _gateway(self, address: str):
        with self._gw_lock:
            gw = self._gateways.get(address)
            if gw is None:
                gw = self.rpc.connect(address, self.server.endpoint_id)
                self._gateways[address] = gw
            return gw

    def create_partition(self, partition_id: str, num_subpartitions: int,
                         credits_per_channel: int = 2
                         ) -> ResultPartitionWriter:
        """The credit window applies to LOCALLY consumed subpartitions;
        remotely consumed ones are bounded by the CONSUMER's server
        (receiver-side flow control, like the reference's receiver-granted
        credits)."""
        for sub in range(num_subpartitions):
            if self.route(partition_id, sub) is None:
                self.server.partition(partition_id, num_subpartitions,
                                      credits=credits_per_channel)
                break
        return _RemoteWriter(self, partition_id, num_subpartitions)

    def create_gate(self, partition_ids: Sequence[str], subpartition: int
                    ) -> InputGate:
        parts = [self.server.partition(pid, subpartition + 1)
                 for pid in partition_ids]
        return LocalGate(parts, subpartition)

    def cancel(self) -> None:
        self.server.cancel()

    def close(self) -> None:
        self.server.cancel()
        if self.owns_rpc:
            self.rpc.stop()


def register_grpc_shuffle() -> None:
    """Register 'grpc' (the reference's key) in the shuffle factory
    registry. The standalone
    factory builds a single-process loopback topology (every consumer
    local) — multi-process deployments construct RpcShuffleService with
    their cluster's RpcService + routing table instead."""
    from flink_tpu_torch.runtime.shuffle_spi import register_shuffle_service

    def factory():
        svc = RpcShuffleService(RpcService(), route=lambda pid, sub: None)
        svc.owns_rpc = True
        return svc

    register_shuffle_service("grpc", factory)


register_grpc_shuffle()
