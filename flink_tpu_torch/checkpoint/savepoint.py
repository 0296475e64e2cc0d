"""Savepoints: user-triggered, user-owned, portable snapshots (port of
``flink_tpu/checkpoint/savepoint.py``).

Restore claim modes: NO_CLAIM never mutates the restored artifact and the
first new checkpoint is self-contained; CLAIM transfers ownership — the
job deletes the restored savepoint once a newer checkpoint subsumes it.

Every snapshot directory is canonical (logical keyed state, see
``SlotTable.snapshot``), so a savepoint restores at any parallelism; the
savepoint/checkpoint difference is a manifest flag.
"""

from __future__ import annotations

import enum
import os
import shutil
from typing import Any, Dict, Optional

from flink_tpu_torch.checkpoint.storage import (
    read_manifest,
    resolve_snapshot_dir,
    write_snapshot_dir,
)


class RestoreMode(enum.Enum):
    """Ownership semantics for the artifact a job restores from."""

    #: never touch the restored snapshot; it stays user-owned (default)
    NO_CLAIM = "no-claim"
    #: the job takes ownership: once a newer checkpoint completes, the
    #: restored artifact is deleted like any other subsumed checkpoint
    CLAIM = "claim"

    @staticmethod
    def of(value) -> "RestoreMode":
        if isinstance(value, RestoreMode):
            return value
        return RestoreMode(str(value).lower().replace("_", "-"))


def write_savepoint(path: str, job_name: str,
                    operator_states: Dict[str, Dict[str, Any]],
                    checkpoint_id: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a self-contained savepoint directory at ``path``.

    The target must not already hold data (the reference likewise refuses a
    non-empty savepoint target) — savepoints never overwrite anything.
    """
    if os.path.exists(path) and os.listdir(path):
        raise FileExistsError(
            f"savepoint target {path!r} already exists and is not empty")
    meta = {"savepoint": True}
    meta.update(extra or {})
    return write_snapshot_dir(path, checkpoint_id, job_name,
                              operator_states, extra=meta)


def check_savepoint_target(path: str) -> None:
    """Fail-fast validation of a savepoint target: existing data and
    unwritable parents are detected BEFORE any irreversible job action
    (e.g. the drain of stop-with-savepoint)."""
    if os.path.exists(path) and os.listdir(path):
        raise FileExistsError(
            f"savepoint target {path!r} already exists and is not empty")
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    if not os.access(parent, os.W_OK):
        raise PermissionError(f"cannot write savepoint under {parent!r}")


def is_savepoint(snapshot_dir: str) -> bool:
    try:
        return bool(read_manifest(snapshot_dir).get("extra", {})
                    .get("savepoint"))
    except (OSError, ValueError):
        return False


class ClaimedArtifact:
    """Tracks a restored snapshot under CLAIM mode: once the restored job
    completes a NEWER checkpoint, the claimed artifact is subsumed and
    deleted (reference: claim-mode ownership transfer)."""

    def __init__(self, restored_dir: str, mode: RestoreMode,
                 own_checkpoint_root: Optional[str]):
        self.restored_dir = os.path.abspath(restored_dir)
        self.mode = mode
        self._own_root = (os.path.abspath(own_checkpoint_root)
                          if own_checkpoint_root else None)
        self._disposed = False

    def on_checkpoint_complete(self, new_checkpoint_dir: str) -> None:
        if self._disposed or self.mode is not RestoreMode.CLAIM:
            return
        new_dir = os.path.abspath(new_checkpoint_dir)
        if new_dir == self.restored_dir:
            return
        # never delete a sibling of the job's own chain out from under the
        # retention policy — claim only applies to external artifacts
        if (self._own_root is not None
                and os.path.dirname(self.restored_dir) == self._own_root):
            self._disposed = True
            return
        shutil.rmtree(self.restored_dir, ignore_errors=True)
        self._disposed = True


def prepare_restore(path: str, mode=RestoreMode.NO_CLAIM,
                    own_checkpoint_root: Optional[str] = None):
    """Resolve a restore target and its ownership tracker.

    Returns (snapshot_dir, ClaimedArtifact).
    """
    snapshot_dir = resolve_snapshot_dir(path)
    return snapshot_dir, ClaimedArtifact(
        snapshot_dir, RestoreMode.of(mode), own_checkpoint_root)
