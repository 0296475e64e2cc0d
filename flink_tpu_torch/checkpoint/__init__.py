"""Checkpoints (port of ``flink_tpu/checkpoint``): storage with manifests
and CRCs, full and incremental checkpoints, savepoints and restore modes,
and shard-granular units (``sharded.py``). The changelog is ROADMAP item
8b."""

from flink_tpu_torch.checkpoint.storage import (
    CheckpointMetadata,
    CheckpointStorage,
)

__all__ = ["CheckpointStorage", "CheckpointMetadata"]
