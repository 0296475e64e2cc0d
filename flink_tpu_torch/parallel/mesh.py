"""The key-group mesh (port of ``flink_tpu/parallel/mesh.py``).

The reference shards the key-group axis over a 1-D ``jax.sharding.Mesh``
of devices. Here the same P key-group shards are LOGICAL shards on one
device: state is a ``[P, capacity]`` plane whose leading axis is the shard,
and the ``all_to_all`` over the mesh axis becomes a local
``[P_src, P_dst, W] -> [P_dst, P_src, W]`` transpose
(``parallel/shuffle.py``). Spanning several cards (NCCL) is a later slice.

Because the shards are logical, a live rescale's shard ceiling is a
choice, not a count of cards: :func:`logical_shard_ceiling`.
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


#: the default ceiling of a live rescale when none is configured
#: (``autoscale.max-shards``, a tenant quota's ``max_shards``): one card
#: holds any number of logical shards, so the ceiling is stated here —
#: the reference's CPU mesh size, 8 — and never read from the hardware
DEFAULT_MAX_LOGICAL_SHARDS = 8


def logical_shard_ceiling(engine, configured: int = 0) -> int:
    """The most logical shards ``engine`` may be rescaled to:
    ``configured`` when set, else the larger of
    :data:`DEFAULT_MAX_LOGICAL_SHARDS` and the engine's current P; in
    both cases bounded by ``max_parallelism`` and the engine's key-group
    range (a shard needs at least one key group)."""
    hi = (int(configured) if configured
          else max(DEFAULT_MAX_LOGICAL_SHARDS, int(engine.P)))
    hi = min(hi, int(engine.max_parallelism))
    kgr = getattr(engine, "key_group_range", None)
    if kgr is not None:
        hi = min(hi, int(kgr[1]) - int(kgr[0]) + 1)
    return max(hi, 1)


def make_mesh(num_shards: int, device: DeviceLike = None) -> LogicalMesh:
    """A P-shard logical mesh on ``device`` (default: ``execution.device``,
    i.e. the card; raises without one)."""
    return LogicalMesh(int(num_shards), resolve_device(device))
