"""FileSink — bucketed, rolling, exactly-once file output
(port of ``flink_tpu/connectors/filesystem.py``).

reference: flink-connectors/flink-connector-files — FileSink with
BucketAssigner (file/src/main/java/.../sink/filesystem/BucketAssigner.java,
DateTimeBucketAssigner), RollingPolicy (DefaultRollingPolicy: part size /
rollover interval), and the pending -> finished part-file lifecycle
committed through Sink V2's two-phase protocol (SupportsCommitter).

Columnar re-design: bucket assignment is VECTORIZED — one call maps a
whole RecordBatch to bucket ids and the batch splits into per-bucket
sub-batches with one lexsort, so a million rows crossing a day boundary
cost two gathers, not a per-record router. Row encoding goes through
the SerializationSchema seam (connectors/formats.py), so every
registered format — jsonl, csv, any binary format (``binary = True``,
length-prefixed) — writes files; 'avro' raises naming ROADMAP item 12d.

Lifecycle (exactly the reference's):
- rows append to a bucket's ``.inprogress`` part file;
- the rolling policy closes parts (size/records), making them PENDING;
- ``prepare_commit`` (checkpoint) seals all open parts -> pending, and
  the pending list rides the checkpoint as committables;
- ``commit`` atomically renames pending parts to their final names
  (idempotent: already-renamed parts are skipped);
- a crash discards unsealed ``.inprogress`` files on restore.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.records import TIMESTAMP_FIELD, RecordBatch
from flink_tpu_torch.connectors.two_phase import TwoPhaseCommitSink


class BucketAssigner:
    """batch -> one bucket id per row (vectorized; reference:
    sink/filesystem/BucketAssigner.java getBucketId per record)."""

    def bucket_ids(self, batch: RecordBatch) -> np.ndarray:
        raise NotImplementedError


class BasePathBucketAssigner(BucketAssigner):
    """Everything in one bucket (reference: BasePathBucketAssigner)."""

    def bucket_ids(self, batch: RecordBatch) -> np.ndarray:
        return np.full(len(batch), "", dtype=object)


class DateTimeBucketAssigner(BucketAssigner):
    """Buckets by the rows' EVENT TIME formatted with ``fmt``
    (reference: DateTimeBucketAssigner, default yyyy-MM-dd--HH) —
    vectorized through a per-batch unique on the truncated epoch."""

    def __init__(self, fmt: str = "%Y-%m-%d--%H"):
        self.fmt = fmt
        # truncation granularity: finest field present in the format
        self._step_ms = (1000 if "%S" in fmt else
                         60_000 if "%M" in fmt else
                         3_600_000 if "%H" in fmt else 86_400_000)

    def bucket_ids(self, batch: RecordBatch) -> np.ndarray:
        if not batch.has_timestamps:
            raise ValueError(
                "DateTimeBucketAssigner needs event-time rows (assign a "
                "watermark strategy)")
        ts = np.asarray(batch.timestamps, dtype=np.int64)
        trunc = ts // self._step_ms
        uniq, inverse = np.unique(trunc, return_inverse=True)
        names = np.array([
            time.strftime(self.fmt, time.gmtime(u * self._step_ms / 1000))
            for u in uniq.tolist()], dtype=object)
        return names[inverse]


class ColumnBucketAssigner(BucketAssigner):
    """Buckets by a column's value (partitioned output directories)."""

    def __init__(self, column: str):
        self.column = column

    def bucket_ids(self, batch: RecordBatch) -> np.ndarray:
        return np.asarray(
            [str(v) for v in batch[self.column].tolist()], dtype=object)


class RollingPolicy:
    """When does an in-progress part close? (reference:
    DefaultRollingPolicy: shouldRollOnEvent by size,
    shouldRollOnProcessingTime by interval; checkpoints always roll
    here — parts seal at prepare_commit like the bulk-format sink)."""

    def __init__(self, max_part_bytes: int = 128 << 20,
                 max_part_records: int = 0,
                 rollover_interval_ms: int = 0):
        self.max_part_bytes = int(max_part_bytes)
        self.max_part_records = int(max_part_records)
        self.rollover_interval_ms = int(rollover_interval_ms)

    def should_roll(self, part: "_Part", now_ms: int) -> bool:
        if self.max_part_bytes and part.bytes >= self.max_part_bytes:
            return True
        if self.max_part_records and part.records >= self.max_part_records:
            return True
        if self.rollover_interval_ms and \
                now_ms - part.opened_ms >= self.rollover_interval_ms:
            return True
        return False


class _Part:
    """``binary`` framing: text rows are newline-delimited (jsonl/csv
    files readable by anything); binary rows (a schema with
    ``binary = True``, as the reference's avro) are u32-length-
    prefixed — a record's payload may contain any byte, including
    0x0A (reference: the bulk formats' own container framing)."""

    def __init__(self, directory: str, name: str, binary: bool = False):
        self.final_path = os.path.join(directory, name)
        self.inprogress = self.final_path + ".inprogress"
        os.makedirs(directory, exist_ok=True)
        self.fh = open(self.inprogress, "wb")
        self.binary = binary
        self.bytes = 0
        self.records = 0
        self.opened_ms = int(time.time() * 1000)

    def append(self, rows: List[bytes]) -> None:
        import struct

        for r in rows:
            if self.binary:
                self.fh.write(struct.pack("<I", len(r)))
                self.bytes += 4
            elif b"\n" in r:
                # newline framing cannot represent this record — failing
                # loudly beats committing a file that splits mid-record
                # on read (csv quoting keeps raw 0x0A inside fields)
                raise ValueError(
                    "record contains a raw newline, which the text "
                    "framing cannot represent — use 'format'='json' "
                    "(escapes control characters) or a binary format "
                    "(length-prefixed)")
            self.fh.write(r)
            self.bytes += len(r)
            if not self.binary:
                self.fh.write(b"\n")
                self.bytes += 1
        self.records += len(rows)

    def seal(self) -> Dict[str, str]:
        self.fh.close()
        return {"inprogress": self.inprogress, "final": self.final_path}


class FileSink(TwoPhaseCommitSink):
    """Bucketed rolling exactly-once file sink (reference: FileSink).

    ``fmt`` is a format name resolved through the DDL format seam
    ('json', 'csv', ...; 'avro' raises naming ROADMAP item 12d) or a
    SerializationSchema instance.
    """

    def __init__(self, base_path: str, columns: Sequence[str],
                 fmt: Any = "json",
                 bucket_assigner: Optional[BucketAssigner] = None,
                 rolling_policy: Optional[RollingPolicy] = None,
                 types: Optional[Sequence[str]] = None,
                 format_options: Optional[dict] = None):
        self.base_path = base_path
        self.columns = list(columns)
        if isinstance(fmt, str):
            from flink_tpu_torch.connectors.formats import resolve_format

            _, self._ser = resolve_format(
                fmt, self.columns, list(types or [None] * len(columns)),
                format_options)
        else:
            self._ser = fmt
        self.assigner = bucket_assigner or BasePathBucketAssigner()
        self.policy = rolling_policy or RollingPolicy()
        self._subtask = 0
        self._open_parts: Dict[str, _Part] = {}
        self._pending: List[Dict[str, str]] = []
        self._seq = 0

    def open(self, subtask_index: int = 0) -> None:
        self._subtask = subtask_index
        self._ser.open()
        os.makedirs(self.base_path, exist_ok=True)

    # ------------------------------------------------------------- write

    def _part_for(self, bucket: str) -> _Part:
        part = self._open_parts.get(bucket)
        if part is None:
            directory = (os.path.join(self.base_path, bucket)
                         if bucket else self.base_path)
            name = (f"part-{self._subtask}-{self._seq}-"
                    f"{uuid.uuid4().hex[:8]}")
            self._seq += 1
            part = _Part(directory, name,
                         binary=getattr(self._ser, "binary", False))
            self._open_parts[bucket] = part
        return part

    def write(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        buckets = self.assigner.bucket_ids(batch)
        uniq, inverse = np.unique(buckets, return_inverse=True)
        now = int(time.time() * 1000)
        for i, bucket in enumerate(uniq.tolist()):
            sub = batch.filter(inverse == i) if len(uniq) > 1 else batch
            rows = self._ser.serialize_batch(sub)
            part = self._part_for(bucket)
            part.append(rows)
            if self.policy.should_roll(part, now):
                # rolled parts are PENDING: published at the NEXT
                # checkpoint (reference: rolling closes the part file
                # but visibility still waits for the committer)
                self._pending.append(part.seal())
                del self._open_parts[bucket]

    # -------------------------------------------------------- two-phase

    def prepare_commit(self) -> List[Any]:
        for bucket in list(self._open_parts):
            part = self._open_parts.pop(bucket)
            if part.records:
                self._pending.append(part.seal())
            else:
                part.fh.close()
                os.unlink(part.inprogress)
        out, self._pending = self._pending, []
        return out

    def commit(self, committables: List[Any]) -> None:
        for c in committables:
            if os.path.exists(c["inprogress"]):
                os.replace(c["inprogress"], c["final"])
            elif not os.path.exists(c["final"]):
                raise RuntimeError(
                    f"committable lost: neither {c['inprogress']} nor "
                    f"{c['final']} exists — data loss would be silent")

    def abort_current(self) -> None:
        for part in self._open_parts.values():
            part.fh.close()
            if os.path.exists(part.inprogress):
                os.unlink(part.inprogress)
        self._open_parts = {}
        self._pending = []

    def abort_uncommitted(self, exclude: List[Any]) -> None:
        # only THIS subtask's parts: parallel sinks share base_path, and
        # restore-time cleanup racing a peer's open/committable part
        # would delete live data (part names embed the subtask index)
        keep = {c["inprogress"] for c in exclude}
        own = f"part-{self._subtask}-"
        for root, _, files in os.walk(self.base_path):
            for f in files:
                p = os.path.join(root, f)
                if (f.startswith(own) and p.endswith(".inprogress")
                        and p not in keep):
                    os.unlink(p)

    def close(self) -> None:
        # seal + publish the tail transaction (end of input is a natural
        # commit point — reference: final checkpoint on finished sources)
        self.commit(self.prepare_commit())

    # committables travel inside checkpoints; file handles do not
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_open_parts"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)


from flink_tpu_torch.connectors.sources import Source


def _walk_committed(base_path: str) -> List[str]:
    """All committed part files under ``base_path``, in bucket/file
    order (readers must never see ``.inprogress`` data)."""
    out = []
    for root, _dirs, files in sorted(
            (r, d, f) for r, d, f in os.walk(base_path)):
        for f in sorted(files):
            if not f.endswith(".inprogress"):
                out.append(os.path.join(root, f))
    return out


def _decode_file_rows(path: str, binary: bool) -> List[bytes]:
    """One part file -> raw rows, undoing the framing _Part.append
    wrote (newline-delimited text / u32-length-prefixed binary). THE
    single copy of the read-side framing rule."""
    import struct

    with open(path, "rb") as fh:
        data = fh.read()
    if binary:
        rows, off = [], 0
        while off < len(data):
            (n,) = struct.unpack_from("<I", data, off)
            off += 4
            rows.append(data[off:off + n])
            off += n
        return rows
    return [line for line in data.split(b"\n") if line]


class FileSource(Source):
    """Bounded scan over COMMITTED part files (reference:
    flink-connector-files FileSource / the filesystem table source).
    Readers never observe ``.inprogress`` data — the other half of the
    FileSink's exactly-once contract. Rows decode through the
    DeserializationSchema seam in file order; buckets are directories,
    so a partitioned layout reads back transparently.

    Exactly-once on the reader side: the checkpoint carries the
    REMAINING FILE PATHS and the row offset inside the current file
    (reference: FileSource snapshots its splits) — never an index into
    a list re-discovered from a directory that may have changed."""

    def __init__(self, path: str, deserializer,
                 timestamp_field: Optional[str] = None):
        self.path = path
        self._deser = deserializer
        self.timestamp_field = timestamp_field
        self._files: List[str] = []
        self._next_file = 0
        self._row = 0            # rows of the CURRENT file already emitted
        self._cur_rows: Optional[List[bytes]] = None
        self._restored = False

    def estimate_records(self) -> Optional[int]:
        return None  # unknowable without reading; batch mode meters

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        self._deser.open()
        if self._restored:
            return  # the checkpointed file list IS the split
        files = _walk_committed(self.path)
        per = -(-len(files) // max(parallelism, 1))
        self._files = files[subtask_index * per:(subtask_index + 1) * per]
        self._next_file = 0
        self._row = 0

    def poll_batch(self, max_records: int):
        binary = getattr(self._deser, "binary", False)
        while self._next_file < len(self._files):
            if self._cur_rows is None:
                self._cur_rows = _decode_file_rows(
                    self._files[self._next_file], binary)
            if self._row >= len(self._cur_rows):
                self._cur_rows = None
                self._next_file += 1
                self._row = 0
                continue
            chunk = self._cur_rows[self._row:self._row + max_records]
            self._row += len(chunk)
            batch = self._deser.deserialize_batch(chunk)
            if self.timestamp_field and \
                    self.timestamp_field in batch.columns:
                batch = batch.with_column(
                    TIMESTAMP_FIELD,
                    np.asarray(batch[self.timestamp_field],
                               dtype=np.int64))
            return batch
        return None

    def close(self) -> None:
        pass

    def snapshot_position(self) -> Dict[str, Any]:
        return {"files": list(self._files[self._next_file:]),
                "row": self._row}

    def restore_position(self, pos) -> None:
        if "files" in pos:
            self._files = list(pos["files"])
            self._next_file = 0
            self._row = int(pos.get("row", 0))
            self._cur_rows = None
            self._restored = True


def read_committed_rows(base_path: str,
                        binary: bool = False) -> List[bytes]:
    """All rows of committed part files under ``base_path``, in
    bucket/file order (test/validation helper — readers must never see
    ``.inprogress`` data). ``binary`` selects the length-prefixed
    framing binary formats write."""
    rows: List[bytes] = []
    for path in _walk_committed(base_path):
        rows.extend(_decode_file_rows(path, binary))
    return rows
