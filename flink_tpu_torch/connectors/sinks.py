"""Sinks (port of ``flink_tpu/connectors/sinks.py``: the base sink,
``DiscardingSink``, ``CollectSink``, ``PrintSink``, ``JsonLinesFileSink``
and ``BinaryFileSink``), over the filesystems of ``core/fs.py``."""

from __future__ import annotations

from typing import List, Optional

from flink_tpu_torch.core.annotations import public
from flink_tpu_torch.core.records import RecordBatch


@public
class Sink:
    def open(self, subtask_index: int = 0) -> None:
        pass

    def write(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


@public
class DiscardingSink(Sink):
    """Swallows output."""

    def write(self, batch: RecordBatch) -> None:
        pass


@public
class CollectSink(Sink):
    """Collects all batches in memory (tests / execute_and_collect)."""

    def __init__(self):
        self.batches: List[RecordBatch] = []

    def write(self, batch):
        self.batches.append(batch)

    def result(self) -> RecordBatch:
        return RecordBatch.concat(self.batches)

    def rows(self):
        return self.result().to_rows()


@public
class PrintSink(Sink):
    def __init__(self, label: str = "",
                 max_rows_per_batch: Optional[int] = 20):
        self.label = label
        self.max_rows = max_rows_per_batch

    def write(self, batch):
        rows = batch.to_rows()
        shown = rows if self.max_rows is None else rows[: self.max_rows]
        for r in shown:
            print(f"{self.label}> {r}")
        if self.max_rows is not None and len(rows) > self.max_rows:
            print(f"{self.label}> ... {len(rows) - self.max_rows} more")


@public
class JsonLinesFileSink(Sink):
    """Append rows as JSON lines to a local file (``file://`` or a bare
    path). Append mode survives job restarts: downstream consumers dedupe
    on key columns (at-least-once, no two-phase commit)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def open(self, subtask_index: int = 0) -> None:
        from flink_tpu_torch.core.fs import get_filesystem

        fs, local = get_filesystem(self.path)
        self._fh = fs.open(local, "ab")

    def write(self, batch: RecordBatch) -> None:
        import json

        for row in batch.to_rows():
            self._fh.write((json.dumps(row, default=str) + "\n").encode())
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @staticmethod
    def read_rows(path: str):
        import io
        import json

        from flink_tpu_torch.core.fs import get_filesystem

        fs, local = get_filesystem(path)
        if not fs.exists(local):
            return []
        with fs.open(local, "rb") as fh:
            text = io.TextIOWrapper(fh, encoding="utf-8")
            return [json.loads(line) for line in text if line.strip()]


@public
class BinaryFileSink(Sink):
    """Length-prefixed batches in the columnar wire format of
    ``core/serializers.py`` ``RowBatchSerializer``. The file starts with
    the magic ``FTFS`` and the serializer snapshot (JSON), so a reader
    restores the exact row type, and resolves compatibility, from the file
    alone. The bytes are the reference's."""

    MAGIC = b"FTFS"

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._ser = None

    def open(self, subtask_index: int = 0) -> None:
        from flink_tpu_torch.core.fs import get_filesystem

        fs, local = get_filesystem(self.path)
        self._fh = fs.open(local, "wb")

    def write(self, batch: RecordBatch) -> None:
        import json
        import struct

        if self._fh is None:
            self.open()
        if self._ser is None:
            from flink_tpu_torch.core.types import RowTypeInfo

            self._ser = RowTypeInfo.from_batch(batch).create_serializer()
            header = json.dumps(self._ser.snapshot().to_json()).encode()
            self._fh.write(self.MAGIC + struct.pack("<I", len(header))
                           + header)
        payload = self._ser.serialize(batch)
        self._fh.write(struct.pack("<Q", len(payload)) + payload)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
