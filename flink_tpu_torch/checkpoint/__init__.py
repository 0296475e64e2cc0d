"""Checkpoints (port of ``flink_tpu/checkpoint``): storage with manifests
and CRCs, full and incremental checkpoints, savepoints and restore modes,
shard-granular units (``sharded.py``) and the changelog backend
(``changelog.py``)."""

from flink_tpu_torch.checkpoint.storage import (
    CheckpointMetadata,
    CheckpointStorage,
)

__all__ = ["CheckpointStorage", "CheckpointMetadata"]
