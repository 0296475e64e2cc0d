"""State changelog: a write-ahead log of state changes for instant
checkpoints (port of ``flink_tpu/checkpoint/changelog.py``).

Every mutation is appended to a durable log; a checkpoint is the log
offset; a materialization writes a full snapshot so that replay stays
bounded, and truncation follows checkpoint subsumption. A log entry is a
columnar frame (key ids, namespaces, per-leaf value arrays) of one batch;
frees are namespace tombstones. Replay re-runs the scatters and frees in
log order against a fresh ``SlotTable`` on the backend's device, so its
float leaves fold through the ordered fold as the live run's did. The
log (pickled NumPy frames) and the materialization (``SlotTable``
snapshots as ``.npz``) are the reference's formats: either package
restores a directory the other wrote.
"""

from __future__ import annotations

import os
import pickle
import struct
import time
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

_MAGIC = b"FTCL"
_HEADER = struct.Struct("<4sQ")  # magic, payload length


class ChangelogWriter:
    """Append-only framed log of state changes for one task.

    Entry = (sequence_number, op_uid, kind, payload). Truncation rewrites
    the log keeping only entries after the materialized offset (the
    reference truncates uploaded segments the same way).
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        # recover: find the byte end of the last intact frame and TRIM any
        # torn tail before appending — otherwise every post-crash append
        # would sit behind unreadable bytes and be lost to read_entries
        self._next_seq = 0
        valid_end = 0
        if os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                while True:
                    header = f.read(_HEADER.size)
                    if len(header) < _HEADER.size:
                        break
                    magic, length = _HEADER.unpack(header)
                    if magic != _MAGIC or f.tell() + length > size:
                        break  # torn/garbage tail
                    blob = f.read(length)
                    try:
                        seq = pickle.loads(blob)[0]
                    except Exception:
                        break
                    self._next_seq = seq + 1
                    valid_end = f.tell()
            if size > valid_end:
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
        self._f = open(path, "ab")

    def append(self, op_uid: str, kind: str, payload: Dict[str, Any]) -> int:
        """Append one change entry; returns its sequence number."""
        seq = self._next_seq
        blob = pickle.dumps((seq, op_uid, kind, payload),
                            protocol=pickle.HIGHEST_PROTOCOL)
        self._f.write(_HEADER.pack(_MAGIC, len(blob)))
        self._f.write(blob)
        self._next_seq += 1
        return seq

    @property
    def next_sequence(self) -> int:
        """The offset a checkpoint records: everything below is durable
        once ``flush`` returns."""
        return self._next_seq

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def truncate(self, up_to_seq: int) -> None:
        """Drop entries with seq < up_to_seq (state below is materialized)."""
        self.flush()
        keep = [(s, u, k, p) for s, u, k, p in read_entries(self.path)
                if s >= up_to_seq]
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for entry in keep:
                blob = pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL)
                f.write(_HEADER.pack(_MAGIC, len(blob)))
                f.write(blob)
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    def close(self) -> None:
        try:
            self.flush()
        except (OSError, ValueError):
            pass
        self._f.close()


def read_entries(path: str
                 ) -> Iterator[Tuple[int, str, str, Dict[str, Any]]]:
    """Yield (seq, op_uid, kind, payload); tolerates a torn final frame
    (crash mid-append) by stopping at it, like the reference's recoverable
    stream handling."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                return
            magic, length = _HEADER.unpack(header)
            if magic != _MAGIC or f.tell() + length > size:
                return  # torn write: entry was not durable
            blob = f.read(length)
            try:
                yield pickle.loads(blob)
            except Exception:
                return


class TableChangelog:
    """Binds a ChangelogWriter to one operator's SlotTable: logs every
    logical mutation so the table can be reconstructed by replay."""

    def __init__(self, writer: ChangelogWriter, op_uid: str):
        self.writer = writer
        self.op_uid = op_uid

    def log_scatter(self, key_ids: np.ndarray, namespaces: np.ndarray,
                    values: Tuple[np.ndarray, ...]) -> None:
        self.writer.append(self.op_uid, "scatter", {
            "key_id": np.asarray(key_ids, dtype=np.int64),
            "namespace": np.asarray(namespaces, dtype=np.int64),
            "values": tuple(np.asarray(v) for v in values),
        })

    def log_free(self, namespaces: List[int]) -> None:
        self.writer.append(self.op_uid, "free",
                           {"namespaces": [int(n) for n in namespaces]})


class ChangelogKeyedBackend:
    """Changelog-wrapped keyed state: instant checkpoints, bounded replay.

    The wrapper owns a SlotTable (on ``device``: ``None`` is
    ``execution.device``, the card) plus the log bindings; ``checkpoint()``
    is an offset record, ``materialize()`` writes a full logical snapshot
    and truncates the log (reference: periodic materialization in the
    changelog backend), ``restore()`` loads the materialized part then
    replays the log tail.
    """

    def __init__(self, agg, log_dir: str, op_uid: str = "op",
                 capacity: int = 1 << 16, max_parallelism: int = 128,
                 device=None):
        from flink_tpu_torch.state.slot_table import SlotTable

        self.table = SlotTable(agg, capacity=capacity,
                               max_parallelism=max_parallelism,
                               device=device)
        self.log_dir = log_dir
        self.op_uid = op_uid
        self.writer = ChangelogWriter(os.path.join(log_dir, "changelog.bin"))
        self._changelog = TableChangelog(self.writer, op_uid)
        self._materialized_seq = 0

    # -- mutations (log + apply) --------------------------------------------

    def scatter(self, key_ids: np.ndarray, namespaces: np.ndarray,
                values: Tuple[np.ndarray, ...]) -> None:
        self._changelog.log_scatter(key_ids, namespaces, values)
        slots = self.table.lookup_or_insert(key_ids, namespaces)
        self.table.scatter(slots, values)

    def free_namespaces(self, namespaces: List[int]) -> None:
        self._changelog.log_free(namespaces)
        self.table.free_namespaces(namespaces)

    # -- checkpointing -------------------------------------------------------

    def checkpoint(self) -> Dict[str, Any]:
        """O(1): persist the log, record the offset. No state transfer."""
        self.writer.flush()
        return {"changelog_seq": self.writer.next_sequence,
                "materialized_seq": self._materialized_seq}

    def materialize(self) -> Dict[str, Any]:
        """Full snapshot at the current offset. Does NOT discard anything:
        older checkpoints stay restorable until their retention owner calls
        ``truncate_subsumed`` (reference: materialization never invalidates
        retained checkpoints; truncation follows checkpoint subsumption)."""
        self.writer.flush()
        snap = self.table.snapshot()
        seq = self.writer.next_sequence
        path = os.path.join(self.log_dir, f"materialized-{seq}.npz")
        # atomic-rename discipline (as write_snapshot_dir / truncate): a
        # crash mid-write must not leave a torn file restore() would pick
        # as its replay base
        # tmp name must end in .npz (np.savez appends it otherwise) and
        # must NOT match the "materialized-" scan prefix restore() uses
        for name in os.listdir(self.log_dir):
            if name.startswith(".tmp-materialized-"):  # torn earlier write
                try:
                    os.remove(os.path.join(self.log_dir, name))
                except OSError:
                    pass
        tmp = os.path.join(self.log_dir, f".tmp-materialized-{seq}.npz")
        np.savez(tmp, **snap)
        os.replace(tmp, path)
        self._materialized_seq = seq
        return {"changelog_seq": seq, "materialized_seq": seq}

    def truncate_subsumed(self, up_to_seq: int) -> None:
        """Discard log entries / materializations no checkpoint needs any
        more: call with the smallest ``changelog_seq`` among RETAINED
        checkpoints. Keeps the newest materialization at or below that
        point (the replay base) and drops everything older."""
        base = 0
        for name in os.listdir(self.log_dir):
            if name.startswith("materialized-") and name.endswith(".npz"):
                s = int(name[len("materialized-"):-4])
                if s <= up_to_seq:
                    base = max(base, s)
        self.writer.truncate(base)
        for name in os.listdir(self.log_dir):
            if name.startswith("materialized-") and name.endswith(".npz"):
                if int(name[len("materialized-"):-4]) < base:
                    os.remove(os.path.join(self.log_dir, name))

    def restore(self, checkpoint: Dict[str, Any]) -> None:
        """Materialized part + replay of the log tail up to the recorded
        offset — mutations logged after the checkpoint are NOT applied
        (exactly-once: the checkpoint cut is the log offset)."""
        t0 = time.perf_counter()
        target_seq = checkpoint["changelog_seq"]
        mat_seq = 0
        mat_path = None
        for name in os.listdir(self.log_dir):
            if name.startswith("materialized-") and name.endswith(".npz"):
                s = int(name[len("materialized-"):-4])
                if s <= target_seq and s >= mat_seq:
                    mat_seq, mat_path = s, os.path.join(self.log_dir, name)
        if mat_path is not None:
            with np.load(mat_path, allow_pickle=False) as z:
                self.table.restore({k: z[k] for k in z.files})
        self._materialized_seq = mat_seq
        t1 = time.perf_counter()
        log_path = os.path.join(self.log_dir, "changelog.bin")
        entries = [e for e in read_entries(log_path)]
        # the replay range [mat_seq, target_seq) must actually be present —
        # a checkpoint whose prefix was truncated away is NOT restorable
        # and must fail loudly, never return empty state
        if mat_path is None and target_seq > 0 and (
                not entries or entries[0][0] > 0):
            raise RuntimeError(
                f"checkpoint at changelog_seq={target_seq} is not "
                "restorable: no materialization at or below it and the log "
                "does not start at 0 (truncated past the checkpoint?)")
        if mat_seq < target_seq:
            have = {s for s, _, _, _ in entries}
            missing = [s for s in range(mat_seq, target_seq)
                       if s not in have]
            if missing:
                raise RuntimeError(
                    f"checkpoint at changelog_seq={target_seq} is not "
                    f"restorable: log entries {missing[:5]}... are gone "
                    "(truncated or lost past the checkpoint)")
        for seq, uid, kind, payload in entries:
            if seq < mat_seq or seq >= target_seq or uid != self.op_uid:
                continue
            if kind == "scatter":
                slots = self.table.lookup_or_insert(payload["key_id"],
                                                    payload["namespace"])
                self.table.scatter(slots, payload["values"])
            elif kind == "free":
                self.table.free_namespaces(payload["namespaces"])
        #: wall ms of the last restore: the materialized load, the replay
        self.restore_ms = {"materialized": (t1 - t0) * 1e3,
                           "replay": (time.perf_counter() - t1) * 1e3}

    def close(self) -> None:
        self.writer.close()
