"""Sources (port of ``flink_tpu/connectors/sources.py``: the base class,
the in-memory ``CollectionSource``, the counter-based hash the synthetic
generators derive their records from, ``DataGenSource``, the line
socket ``SocketSource`` and ``BinaryFileSource``). Every source says
whether it is ``bounded``: batch mode (``execution.runtime-mode=batch``)
rejects an unbounded one."""

from __future__ import annotations

import socket as _socket
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.annotations import public
from flink_tpu_torch.core.records import RecordBatch


@public
class Source:
    """A bounded or unbounded batch source."""

    bounded: bool = True

    def estimate_records(self) -> Optional[int]:
        """Best-effort size for adaptive batch parallelism (the stage
        executor's fallback when a source cannot be metered). None =
        unknown."""
        return None

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        pass

    def poll_batch(self, max_records: int) -> Optional[RecordBatch]:
        """Next batch, or None when exhausted."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def snapshot_position(self) -> Dict[str, Any]:
        """The consumed prefix, for a checkpoint's manifest."""
        return {}

    def restore_position(self, pos: Dict[str, Any]) -> None:
        pass


class CollectionSource(Source):
    """In-memory batches (tests, examples), like the reference's
    fromCollection/fromData."""

    def __init__(self, batches: Sequence[RecordBatch]):
        self.batches = list(batches)
        self._i = 0

    def estimate_records(self) -> Optional[int]:
        return sum(len(b) for b in self.batches)

    @staticmethod
    def of_rows(rows: Iterable[dict],
                batch_size: int = 8192) -> "CollectionSource":
        rows = list(rows)
        return CollectionSource([RecordBatch.from_rows(rows[i:i + batch_size])
                                 for i in range(0, len(rows), batch_size)])

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        # each execution re-reads the collection from the start; a restore
        # positions it after open
        self._i = 0

    def poll_batch(self, max_records):
        if self._i >= len(self.batches):
            return None
        self._i += 1
        return self.batches[self._i - 1]

    def snapshot_position(self):
        return {"i": self._i}

    def restore_position(self, pos):
        self._i = pos["i"]


def _splitmix64(idx: np.ndarray, salt: int) -> np.ndarray:
    """Vectorized counter-based hash (splitmix64): record content derives
    from the GLOBAL record index, so a stream is identical under any batch
    size or source parallelism."""
    with np.errstate(over="ignore"):
        z = idx.astype(np.uint64) + np.uint64(
            (salt * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
        z = (z + np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


class DataGenSource(Source):
    """Deterministic synthetic events (keys, float32 values, event time),
    the reference's datagen generator: a record's content is a pure
    function of its GLOBAL index (counter-based hashing), so re-reads,
    re-batching and parallel splits observe the same stream — bit for bit
    the reference's, key skew included."""

    def __init__(self, total_records: int, num_keys: int,
                 events_per_second_of_eventtime: int = 10000,
                 key_field: str = "key", value_field: str = "value",
                 seed: int = 7, start_ts: int = 0, skew: float = 0.0):
        self.total = int(total_records)
        self.num_keys = int(num_keys)
        self.rate = int(events_per_second_of_eventtime)
        self.key_field = key_field
        self.value_field = value_field
        self.seed = seed
        self.start_ts = start_ts
        self.skew = skew
        self._emitted = 0  # within this subtask's range
        self._start = 0
        self._end = self.total

    def estimate_records(self) -> Optional[int]:
        return self.total

    def open(self, subtask_index=0, parallelism=1):
        # a contiguous split of the global index space; the position resets
        # so that a re-executed graph generates the same stream
        per = -(-self.total // max(parallelism, 1))
        self._start = min(subtask_index * per, self.total)
        self._end = min(self._start + per, self.total)
        self._emitted = 0

    def _generate(self, idx: np.ndarray) -> RecordBatch:
        u_key = _splitmix64(idx, self.seed * 2 + 1)
        if self.skew > 0.0:
            # zipf-ish skew by an inverse power transform of the uniform
            # hash
            u = (u_key >> np.uint64(11)).astype(np.float64) / (1 << 53)
            raw = np.maximum(
                1.0, np.power(np.maximum(u, 1e-12), -1.0 / self.skew))
            raw = np.minimum(raw, 1e18)
            keys = raw.astype(np.int64) % self.num_keys
        else:
            keys = (u_key % np.uint64(self.num_keys)).astype(np.int64)
        u_val = _splitmix64(idx, self.seed * 2 + 2)
        values = ((u_val >> np.uint64(11)).astype(np.float64)
                  / (1 << 53)).astype(np.float32)
        # event time advances with the GLOBAL index
        ts = self.start_ts + (idx * 1000) // max(self.rate, 1)
        return RecordBatch.from_pydict(
            {self.key_field: keys, self.value_field: values}, timestamps=ts)

    def poll_batch(self, max_records):
        own = self._end - self._start
        if self._emitted >= own:
            return None
        n = min(max_records, own - self._emitted)
        idx = np.arange(self._start + self._emitted,
                        self._start + self._emitted + n, dtype=np.int64)
        self._emitted += n
        return self._generate(idx)

    def snapshot_position(self):
        # the next record index: a replay regenerates the same records
        return {"emitted": self._emitted}

    def restore_position(self, pos):
        self._emitted = pos["emitted"]


class SocketSource(Source):
    """Line-oriented TCP socket source (the WordCount baseline's source).
    Each line becomes one record in column ``field``; timestamps are the
    arrival time unless a later operator assigns event time. A poll with
    no complete line returns an empty batch; the server's close ends the
    stream once every complete line has been returned."""

    bounded = False

    def __init__(self, host: str, port: int, field: str = "line",
                 connect_timeout: float = 10.0):
        self.host = host
        self.port = port
        self.field = field
        self.connect_timeout = connect_timeout
        self._sock: Optional[_socket.socket] = None
        self._buf = b""
        self._eof = False

    def open(self, subtask_index=0, parallelism=1):
        self._sock = _socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        self._sock.settimeout(0.05)

    def poll_batch(self, max_records):
        # after the server's close the buffered lines still drain (the
        # reference returns None at once and drops them: ROADMAP Queue C
        # R3)
        if self._eof and b"\n" not in self._buf:
            return None
        lines: List[str] = []
        if not self._eof:
            try:
                data = self._sock.recv(1 << 16)
                if not data:
                    self._eof = True
                self._buf += data
            except (TimeoutError, _socket.timeout):
                pass
        while b"\n" in self._buf and len(lines) < max_records:
            line, self._buf = self._buf.split(b"\n", 1)
            lines.append(line.decode("utf-8", errors="replace"))
        if not lines:
            return None if self._eof else RecordBatch({})
        now = int(time.time() * 1000)
        return RecordBatch.from_pydict(
            {self.field: np.array(lines, dtype=object)},
            timestamps=np.full(len(lines), now, dtype=np.int64))

    def close(self):
        if self._sock is not None:
            self._sock.close()


@public
class BinaryFileSource(Source):
    """Reads a file written by ``BinaryFileSink``. The serializer snapshot
    in its header restores the writer's row type; given a ``row_type``,
    compatibility is resolved first and batches are migrated when the
    schema evolved (an incompatible schema raises ``ValueError``)."""

    def __init__(self, path: str, row_type=None):
        self.path = path
        self.row_type = row_type
        self._fh = None
        self._ser = None
        self._snap = None
        self._migrating = False
        self._pos = 0

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        import json
        import struct

        from flink_tpu_torch.core.fs import get_filesystem
        from flink_tpu_torch.core.serializers import (
            Compatibility,
            SerializerSnapshot,
        )

        fs, local = get_filesystem(self.path)
        self._fh = fs.open(local, "rb")
        if self._fh.read(4) != b"FTFS":
            raise ValueError(f"{self.path}: not a binary batch file")
        (hlen,) = struct.unpack("<I", self._fh.read(4))
        self._snap = SerializerSnapshot.from_json(
            json.loads(self._fh.read(hlen).decode()))
        if self.row_type is not None:
            new_ser = self.row_type.create_serializer()
            compat = self._snap.resolve_compatibility(new_ser)
            if compat is Compatibility.INCOMPATIBLE:
                raise ValueError(
                    f"{self.path}: written schema is incompatible with the "
                    f"requested row type")
            self._ser = new_ser
            self._migrating = (
                compat is Compatibility.COMPATIBLE_AFTER_MIGRATION)
        else:
            self._ser = self._snap.restore_serializer()
        if self._pos:
            self._fh.seek(self._pos)

    def poll_batch(self, max_records):
        import struct

        head = self._fh.read(8)
        if len(head) < 8:
            return None
        (plen,) = struct.unpack("<Q", head)
        payload = self._fh.read(plen)
        self._pos = self._fh.tell()
        if self._migrating:
            return self._ser.migrate(payload, self._snap)
        return self._ser.deserialize(payload)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def snapshot_position(self):
        return {"pos": self._pos}

    def restore_position(self, pos):
        self._pos = pos["pos"]
        # restored after open: seek the live handle (position 0 means
        # never polled; the handle already sits past the header)
        if self._fh is not None and self._pos:
            self._fh.seek(self._pos)
