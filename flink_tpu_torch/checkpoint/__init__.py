"""Checkpoints (port of ``flink_tpu/checkpoint``): storage with manifests
and CRCs, full and incremental checkpoints, savepoints and restore modes.
Shard-granular checkpoints and the changelog are ROADMAP item 8b."""

from flink_tpu_torch.checkpoint.storage import (
    CheckpointMetadata,
    CheckpointStorage,
)

__all__ = ["CheckpointStorage", "CheckpointMetadata"]
