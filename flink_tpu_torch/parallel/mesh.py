"""The key-group mesh (port of ``flink_tpu/parallel/mesh.py``).

The reference shards the key-group axis over a 1-D ``jax.sharding.Mesh``
of devices. Here the same P key-group shards are LOGICAL shards on one
device: state is a ``[P, capacity]`` plane whose leading axis is the shard,
and the ``all_to_all`` over the mesh axis becomes a local
``[P_src, P_dst, W] -> [P_dst, P_src, W]`` transpose
(``parallel/shuffle.py``). Spanning several cards (NCCL) is a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from flink_tpu_torch.core.device import DeviceLike, resolve_device

#: name of the key-group axis (kept from the reference for readability)
KEY_AXIS = "keygroups"


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """``size`` key-group shards laid out along dim 0 of every state plane
    on one ``device``."""

    size: int
    device: torch.device

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"mesh size must be >= 1, got {self.size}")


def make_mesh(num_shards: int, device: DeviceLike = None) -> LogicalMesh:
    """A P-shard logical mesh on ``device`` (default: ``execution.device``,
    i.e. the card; raises without one)."""
    return LogicalMesh(int(num_shards), resolve_device(device))
