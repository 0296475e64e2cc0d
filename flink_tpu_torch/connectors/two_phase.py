"""Two-phase-commit sinks: end-to-end exactly once
(port of ``flink_tpu/connectors/two_phase.py``).

reference: Sink V2 SupportsCommitter
(flink-core/.../api/connector/sink2/SupportsCommitter.java, Committer.java)
and the transactional file sink. Protocol (same as the reference):

1. writer.write(batch)          — records land in an uncommitted
                                  transaction (temp files)
2. checkpoint: prepare_commit() — the transaction is sealed; its
                                  committables travel INSIDE the checkpoint
3. checkpoint complete          — commit(committables): atomically publish
4. failover                     — restore re-commits the checkpoint's
                                  committables (idempotent), and anything
                                  written after the checkpoint was never
                                  sealed, so it is simply discarded

In the micro-batch engine "checkpoint complete" is the successful
atomic-rename of the snapshot directory, so commit follows immediately
after; the committables still ride in the checkpoint because a crash
BETWEEN write and commit must re-commit on restore.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, List, Optional

from flink_tpu_torch.core.records import RecordBatch


class TwoPhaseCommitSink:
    """SPI for exactly-once sinks (reference: SupportsCommitter)."""

    def open(self, subtask_index: int = 0) -> None:
        pass

    def write(self, batch: RecordBatch) -> None:
        """Write into the CURRENT (uncommitted) transaction."""
        raise NotImplementedError

    def prepare_commit(self) -> List[Any]:
        """Seal the current transaction; returns committables that will be
        stored in the checkpoint and later passed to ``commit``. Starts a
        fresh transaction."""
        raise NotImplementedError

    def commit(self, committables: List[Any]) -> None:
        """Publish sealed committables. MUST be idempotent: a failover
        between checkpoint-write and commit replays this call."""
        raise NotImplementedError

    def abort_uncommitted(self, exclude: List[Any]) -> None:
        """Discard transaction leftovers not reachable from ``exclude``
        (restore-time cleanup of post-checkpoint writes)."""

    def abort_current(self) -> None:
        """Abandon the CURRENT (uncommitted) transaction without publishing
        it. Called on failure-path dispose (reference:
        TwoPhaseCommitSinkFunction.close aborts the current transaction);
        the leftovers are cleaned by ``abort_uncommitted`` on restore."""

    def close(self) -> None:
        pass


class ExactlyOnceFileSink(TwoPhaseCommitSink):
    """Transactional jsonl file sink: each transaction is an
    ``.inprogress`` part file, committed by atomic rename to its final
    name (reference: FileSink's pending -> finished file lifecycle).

    Readers only ever see committed part files; a crash leaves
    ``.inprogress`` garbage that restore cleans up.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._current: Optional[str] = None  # inprogress path
        self._fh = None
        self._txn_seq = 0

    # -- lifecycle -----------------------------------------------------------

    def open(self, subtask_index: int = 0) -> None:
        os.makedirs(self.directory, exist_ok=True)

    def _ensure_txn(self) -> None:
        if self._fh is None:
            name = f"part-{uuid.uuid4().hex[:12]}-{self._txn_seq}"
            self._current = os.path.join(self.directory,
                                         name + ".inprogress")
            self._fh = open(self._current, "w", encoding="utf-8")

    def write(self, batch: RecordBatch) -> None:
        import json

        self._ensure_txn()
        for row in batch.to_rows():
            self._fh.write(json.dumps(row, default=str) + "\n")

    def prepare_commit(self) -> List[Any]:
        if self._fh is None:
            return []
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._fh = None
        pending = self._current
        self._current = None
        self._txn_seq += 1
        return [{"pending": pending,
                 "final": pending[: -len(".inprogress")]}]

    def commit(self, committables: List[Any]) -> None:
        for c in committables:
            pending, final = c["pending"], c["final"]
            if os.path.exists(pending):
                os.replace(pending, final)  # atomic publish
            elif not os.path.exists(final):
                raise IOError(
                    f"committable lost: neither {pending} nor {final} "
                    "exists")
            # else: already committed (idempotent re-commit after failover)

    def abort_current(self) -> None:
        # close the handle but do NOT seal or publish: the .inprogress file
        # stays on disk for restore-time abort_uncommitted cleanup
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
            self._current = None

    def abort_uncommitted(self, exclude: List[Any]) -> None:
        keep = {os.path.basename(c["pending"]) for c in exclude}
        for name in os.listdir(self.directory):
            if name.endswith(".inprogress") and name not in keep:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    def close(self) -> None:
        # seal + publish the tail transaction (end of input is a natural
        # commit point — reference: final checkpoint on finished sources)
        self.commit(self.prepare_commit())

    def __getstate__(self):
        return {"directory": self.directory, "_txn_seq": self._txn_seq}

    def __setstate__(self, state):
        self.directory = state["directory"]
        self._txn_seq = state["_txn_seq"]
        self._current = None
        self._fh = None

    @staticmethod
    def read_committed_rows(directory: str) -> List[dict]:
        import json

        rows: List[dict] = []
        if not os.path.isdir(directory):
            return rows
        for name in sorted(os.listdir(directory)):
            if name.endswith(".inprogress"):
                continue
            with open(os.path.join(directory, name), encoding="utf-8") as f:
                rows.extend(json.loads(line) for line in f if line.strip())
        return rows


from flink_tpu_torch.runtime.operators import Operator


class TwoPhaseSinkOperator(Operator):
    """Operator wrapper driving the 2PC protocol from the task loop
    (reference: SinkWriterOperator + CommitterOperator pair)."""

    name = "two_phase_sink"

    def __init__(self, sink: TwoPhaseCommitSink):
        self.sink = sink
        #: committables sealed at the last snapshot, awaiting
        #: checkpoint-complete
        self._pending_commit: List[Any] = []

    def open(self, ctx) -> None:
        self.sink.open(ctx.operator_index)

    def process_batch(self, batch, input_index: int = 0):
        self.sink.write(batch)
        return []

    def process_watermark(self, watermark, input_index: int = 0):
        return []

    def close(self):
        self.sink.close()
        return []

    def dispose(self) -> None:
        # failure path: NEVER commit here — windows fired after the last
        # checkpoint must not be published, or restore re-commits them and
        # produces duplicates. Abort the open transaction; restore's
        # abort_uncommitted cleans the leftovers.
        try:
            self.sink.abort_current()
        except Exception:
            pass

    # -- checkpoint protocol -------------------------------------------------

    def snapshot_state(self):
        # accumulate: a savepoint may seal a transaction without a
        # checkpoint-complete following it — those committables must stay
        # pending (and inside every later snapshot) until actually
        # committed, or their data would be stranded as .inprogress
        self._pending_commit.extend(self.sink.prepare_commit())
        return {"committables": list(self._pending_commit)}

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        if self._pending_commit:
            self.sink.commit(self._pending_commit)
            self._pending_commit = []

    def restore_state(self, state):
        committables = list(state.get("committables", []))
        # 2PC recovery: the checkpoint's sealed transactions are committed
        # (idempotent), everything newer was never sealed -> discard
        self.sink.commit(committables)
        self.sink.abort_uncommitted(exclude=[])
        self._pending_commit = []
