"""Kafka-shaped partitioned source/sink on the split framework (port of
``flink_tpu/connectors/kafka.py``).

reference: the split-reader connector stack —
flink-connector-base/.../source/reader/SourceReaderBase.java:1 (split
readers over fetchers), flink-connectors/flink-connector-kafka (partitions
as splits, offsets in checkpoint state, partition discovery). Re-design:
a partition IS a SourceSplit; the per-split reader is a plain Source whose
position is the partition offset, so offsets ride checkpoints through the
existing SplitSource snapshot contract with nothing Kafka-specific in the
checkpoint path.

The broker here is an in-process fake (``FakeBroker``) — topics of
append-only partitioned logs with offset-addressed fetch, the exact
surface the real client exposes. Wire a real cluster by implementing the
same four methods against it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.connectors.source_v2 import (
    SourceCoordinator,
    SourceSplit,
    SplitEnumerator,
    SplitSource,
)
from flink_tpu_torch.connectors.sources import Source
from flink_tpu_torch.core.records import RecordBatch


class FakeBroker:
    """In-process broker: named topics of partitioned append-only logs.

    Offset-addressed fetch over columnar chunks; thread-safe (producers
    and the source's split readers run on different threads). Process-wide
    named registry so tests and SQL DDL reach the same instance."""

    _registry: Dict[str, "FakeBroker"] = {}
    _registry_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        #: topic -> partition -> list of (base_offset, RecordBatch)
        self._logs: Dict[str, List[List[Tuple[int, RecordBatch]]]] = {}

    @classmethod
    def get(cls, name: str = "default") -> "FakeBroker":
        with cls._registry_lock:
            b = cls._registry.get(name)
            if b is None:
                b = cls._registry[name] = FakeBroker()
            return b

    @classmethod
    def reset(cls, name: Optional[str] = None) -> None:
        with cls._registry_lock:
            if name is None:
                cls._registry.clear()
            else:
                cls._registry.pop(name, None)

    def create_topic(self, topic: str, partitions: int) -> None:
        with self._lock:
            log = self._logs.setdefault(topic, [])
            while len(log) < partitions:
                log.append([])

    def add_partitions(self, topic: str, new_total: int) -> None:
        """Partition expansion (triggers source re-discovery)."""
        self.create_topic(topic, new_total)

    def partitions(self, topic: str) -> int:
        with self._lock:
            return len(self._logs.get(topic, []))

    def append(self, topic: str, partition: int,
               batch: RecordBatch) -> int:
        """Append a batch to one partition; returns its base offset."""
        with self._lock:
            log = self._logs.setdefault(topic, [])
            while len(log) <= partition:
                log.append([])
            part = log[partition]
            base = (part[-1][0] + len(part[-1][1])) if part else 0
            part.append((base, batch))
            return base

    RAW_FIELD = "__raw__"

    def append_raw(self, topic: str, partition: int, records,
                   timestamps=None) -> int:
        """Append RAW byte records (what a real producer writes); a
        format's DeserializationSchema turns them into columns on the
        consumer side."""
        arr = np.empty(len(records), dtype=object)
        arr[:] = list(records)
        return self.append(topic, partition, RecordBatch.from_pydict(
            {self.RAW_FIELD: arr},
            timestamps=np.asarray(timestamps, dtype=np.int64)
            if timestamps is not None else None))

    def produce_rows(self, topic: str, rows, partition_by=None,
                     num_partitions: Optional[int] = None,
                     timestamp_field: Optional[str] = None) -> None:
        """Test/DDL convenience: route rows to partitions by a key field
        (hash) or round-robin, preserving order within a partition."""
        rows = list(rows)
        if not rows:
            return
        n_parts = num_partitions or max(self.partitions(topic), 1)
        # flint: disable=LCK03 -- topics only grow: create_topic is
        # idempotent-or-raise on a partition-count conflict, so a racing
        # creator changes nothing this routing read depends on
        self.create_topic(topic, n_parts)
        buckets: List[List[dict]] = [[] for _ in range(n_parts)]
        for i, r in enumerate(rows):
            p = (hash(r[partition_by]) % n_parts) if partition_by \
                else i % n_parts
            buckets[p].append(r)
        for p, rs in enumerate(buckets):
            if not rs:
                continue
            cols = {k: np.asarray([r[k] for r in rs]) for k in rs[0]}
            ts = (np.asarray(cols[timestamp_field], dtype=np.int64)
                  if timestamp_field else None)
            # flint: disable=LCK03 -- the partition count read above is
            # only a routing hint; append() self-extends the partition
            # list under its own hold, so a stale count cannot drop rows
            self.append(topic, p, RecordBatch.from_pydict(
                {k: v for k, v in cols.items()}, timestamps=ts))

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int) -> Tuple[Optional[RecordBatch], int]:
        """(batch, next_offset) from ``offset``; (None, offset) when the
        log has nothing past it."""
        with self._lock:
            log = self._logs.get(topic)
            if log is None or partition >= len(log):
                return None, offset
            part = log[partition]
        picked: List[RecordBatch] = []
        n = 0
        next_off = offset
        for base, chunk in part:
            end = base + len(chunk)
            if end <= offset:
                continue
            lo = max(offset, base) - base
            hi = min(len(chunk), lo + (max_records - n))
            if hi <= lo:
                break
            picked.append(chunk.slice(lo, hi))
            n += hi - lo
            next_off = base + hi
            if n >= max_records:
                break
        if not picked:
            return None, offset
        return (picked[0] if len(picked) == 1
                else RecordBatch.concat(picked)), next_off

    def end_offset(self, topic: str, partition: int) -> int:
        with self._lock:
            log = self._logs.get(topic)
            if log is None or partition >= len(log):
                return 0
            part = log[partition]
            return (part[-1][0] + len(part[-1][1])) if part else 0


class KafkaClientBroker:
    """Adapter template for a REAL Kafka cluster behind the same
    four-method surface ``FakeBroker`` exposes — what the source/sink
    stack actually depends on (reference: the KafkaConsumer/KafkaProducer
    calls inside flink-connector-kafka's split reader and writer).

    Wire it with any client library (kafka-python, confluent-kafka):

    - ``partitions(topic)``      -> consumer.partitions_for_topic
    - ``fetch(topic, p, offset, max_records)``
                                 -> seek(TopicPartition(topic, p), offset)
                                    + poll(); return a columnar batch
                                    (apply the table's
                                    DeserializationSchema to the raw
                                    values) and the next offset
    - ``end_offset(topic, p)``   -> consumer.end_offsets
    - ``append(topic, p, batch)`` / ``append_raw`` -> producer.send per
                                    record (serialized values)

    Offsets stay in THIS framework's checkpoints (the split position),
    never in Kafka's consumer-group storage — the same
    exactly-once-ownership decision the reference makes. This class
    raises until a client is injected; it exists so the seam is explicit
    and testable, not discovered by reverse-engineering FakeBroker."""

    def __init__(self, client=None):
        if client is None:
            raise RuntimeError(
                "KafkaClientBroker needs a client object implementing "
                "partitions_for/seek/poll/end_offsets/send (no Kafka "
                "client library ships in this environment; FakeBroker "
                "provides the in-process surface)")
        self.client = client

    def create_topic(self, topic: str, partitions: int) -> None:
        raise NotImplementedError("topic administration is external")

    def partitions(self, topic: str) -> int:
        return len(self.client.partitions_for(topic))

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int):
        raise NotImplementedError(
            "implement against your client: seek + poll -> "
            "(RecordBatch, next_offset)")

    def end_offset(self, topic: str, partition: int) -> int:
        raise NotImplementedError(
            "implement against your client: end_offsets")

    def append(self, topic: str, partition: int, batch) -> int:
        raise NotImplementedError(
            "implement against your client: producer.send")

    def append_raw(self, topic: str, partition: int, records,
                   timestamps=None) -> int:
        raise NotImplementedError(
            "implement against your client: producer.send per raw "
            "serialized record (a sink with a value_format writes "
            "through THIS method)")


class KafkaPartitionReader(Source):
    """Reads ONE partition from an offset — the per-split reader. Its
    snapshot position is the committed offset (reference: KafkaSource
    stores per-split offsets in checkpoints, not in the broker)."""

    def __init__(self, broker: FakeBroker, topic: str, partition: int,
                 bounded: bool, start_offset: int = 0,
                 deserializer=None):
        self.broker = broker
        self.topic = topic
        self.partition = partition
        self.bounded = bounded
        #: DeserializationSchema applied to raw byte records (the
        #: format seam — flink_tpu_torch/connectors/formats.py)
        self.deserializer = deserializer
        self._offset = int(start_offset)
        self._stop_at: Optional[int] = None

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        if self.bounded:
            # bounded scan reads up to the end offset AT OPEN (the
            # reference's setBounded(latest) stopping condition)
            self._stop_at = self.broker.end_offset(self.topic,
                                                   self.partition)

    def poll_batch(self, max_records: int) -> Optional[RecordBatch]:
        limit = max_records
        if self._stop_at is not None:
            if self._offset >= self._stop_at:
                return None
            limit = min(limit, self._stop_at - self._offset)
        batch, next_off = self.broker.fetch(
            self.topic, self.partition, self._offset, limit)
        if batch is None:
            # unbounded: stay live (new appends show up on a later poll)
            return None if self._stop_at is not None else RecordBatch({})
        self._offset = next_off
        if self.deserializer is not None \
                and FakeBroker.RAW_FIELD in batch.columns:
            # offsets count RAW records (committed above); parse errors
            # the schema skips do not affect the committed position
            raw_ts = batch.timestamps if batch.has_timestamps else None
            batch = self.deserializer.deserialize_batch(
                list(batch[FakeBroker.RAW_FIELD]))
            if raw_ts is not None:
                # broker (log-append) timestamps survive the format
                # seam; the schema reports which raw records survived
                # so skipped (corrupt) records keep the rest aligned
                surviving = getattr(self.deserializer,
                                    "last_surviving", None)
                if surviving is not None:
                    raw_ts = raw_ts[np.asarray(surviving, dtype=np.int64)]
                if len(batch) == len(raw_ts):
                    batch = batch.with_timestamps(raw_ts)
        return batch

    def snapshot_position(self) -> Dict[str, Any]:
        return {"offset": self._offset}

    def restore_position(self, pos: Dict[str, Any]) -> None:
        self._offset = int(pos["offset"])


class KafkaPartitionEnumerator(SplitEnumerator):
    """One split per partition; unbounded mode re-discovers so partition
    expansion is picked up (reference: KafkaSourceEnumerator periodic
    partition discovery)."""

    def __init__(self, broker: FakeBroker, topic: str, bounded: bool):
        self.broker = broker
        self.topic = topic
        self.bounded = bounded
        self._known = 0

    def discover(self) -> List[SourceSplit]:
        total = self.broker.partitions(self.topic)
        new = [SourceSplit(split_id=f"{self.topic}-{p}", payload=p)
               for p in range(self._known, total)]
        self._known = total
        return new

    def reset(self) -> None:
        # a RE-opened source replays from scratch (see SplitSource.open)
        self._known = 0

    def snapshot_state(self):
        return {"known": self._known}

    def restore_state(self, state):
        self._known = int(state.get("known", 0))


class KafkaPartitionCoordinator(SourceCoordinator):
    """Deterministic partition -> subtask assignment
    (partition % parallelism): reopening at a different parallelism
    REBALANCES partitions with no sticky state to migrate — the split id
    encodes the partition, offsets travel with the split in checkpoints
    (reference: KafkaSourceEnumerator uses the same stateless modulo)."""

    def assign(self, splits) -> Dict[str, int]:
        for s in splits:
            if s.split_id not in self._assignment:
                self._assignment[s.split_id] = \
                    int(s.payload) % self.parallelism
        return dict(self._assignment)

    def restore_state(self, state):
        # recompute instead of trusting a snapshot taken at a different
        # parallelism; assignment is a pure function of (partition, P)
        pass


class KafkaSource(SplitSource):
    """Partitioned, offset-committing, rebalancing source.

    reference surface: KafkaSource builder (topic, bounded/unbounded,
    starting offsets); checkpoints carry per-partition offsets through
    SplitSource.snapshot_position.
    """

    def __init__(self, topic: str, broker: Optional[FakeBroker] = None,
                 broker_name: str = "default", bounded: bool = True,
                 timestamp_field: Optional[str] = None,
                 start_offsets: Optional[Dict[int, int]] = None,
                 value_format=None, **kwargs):
        broker = broker or FakeBroker.get(broker_name)
        self.topic = topic
        self.broker = broker
        start_offsets = start_offsets or {}

        def reader_factory(split: SourceSplit) -> KafkaPartitionReader:
            return KafkaPartitionReader(
                broker, topic, int(split.payload), bounded,
                start_offset=start_offsets.get(int(split.payload), 0),
                deserializer=value_format)

        super().__init__(
            KafkaPartitionEnumerator(broker, topic, bounded),
            reader_factory, timestamp_field=timestamp_field, **kwargs)

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        if self.coordinator is None:
            self.coordinator = KafkaPartitionCoordinator(parallelism)
        super().open(subtask_index, parallelism)


class KafkaSink:
    """Partitioned sink: rows route to partitions by a key field (hash)
    or round-robin (reference: KafkaSink with a key-hash partitioner).

    Delivery is AT-LEAST-ONCE: writes are not transactional, so batches
    appended after the last completed checkpoint are re-appended on
    crash-restore (the reference's KafkaSink defaults to the same
    guarantee; its EXACTLY_ONCE mode needs broker transactions, which
    the in-process FakeBroker does not model).

    ``upsert_keys`` switches the sink to UPSERT mode (reference:
    upsert-kafka): it accepts a changelog (rows keep their
    ``__rowkind__``), always partitions by the primary key so a key's
    updates stay ordered within one partition, and duplicates from
    at-least-once replay are idempotent after consumer-side last-wins
    compaction — the same effective-exactly-once argument upsert-kafka
    makes."""

    def __init__(self, topic: str, broker: Optional[FakeBroker] = None,
                 broker_name: str = "default",
                 partition_by: Optional[str] = None,
                 num_partitions: int = 1,
                 upsert_keys: Optional[list] = None,
                 value_format=None):
        self.broker = broker or FakeBroker.get(broker_name)
        self.topic = topic
        self.upsert_keys = list(upsert_keys) if upsert_keys else None
        if self.upsert_keys and not partition_by:
            # a key's upserts must stay ordered: route by the key
            partition_by = self.upsert_keys[0]
        self.partition_by = partition_by
        self.num_partitions = int(num_partitions)
        #: SerializationSchema — rows leave as raw encoded records
        self.value_format = value_format
        self._rr = 0

    @property
    def supports_changelog(self) -> bool:
        return self.upsert_keys is not None

    def open(self, subtask_index: int = 0) -> None:
        self.broker.create_topic(self.topic, self.num_partitions)

    def snapshot_state(self) -> dict:
        # round-robin rotation is deterministic across restore
        return {"rr": self._rr}

    def restore_state(self, state: dict) -> None:
        self._rr = int(state.get("rr", 0))

    def _append(self, partition: int, batch: RecordBatch) -> None:
        if self.value_format is not None:
            self.broker.append_raw(
                self.topic, partition,
                self.value_format.serialize_batch(batch),
                timestamps=batch.timestamps
                if batch.has_timestamps else None)
        else:
            self.broker.append(self.topic, partition, batch)

    def write(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        if self.partition_by and self.partition_by in batch.columns:
            from flink_tpu_torch.state.keygroups import hash_keys_to_i64

            parts = (hash_keys_to_i64(batch[self.partition_by])
                     % self.num_partitions).astype(np.int64)
            for p in range(self.num_partitions):
                mask = parts == p
                if mask.any():
                    self._append(p, batch.filter(mask))
        else:
            self._append(self._rr % self.num_partitions, batch)
            self._rr += 1

    def close(self) -> None:
        pass
