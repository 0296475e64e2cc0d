"""The key-group mesh (port of ``flink_tpu/parallel/mesh.py``).

The reference shards the key-group axis over a 1-D ``jax.sharding.Mesh``
of devices. Here the same P key-group shards are LOGICAL shards on one
device: state is a ``[P, capacity]`` plane whose leading axis is the shard,
and the ``all_to_all`` over the mesh axis becomes a local
``[P_src, P_dst, W] -> [P_dst, P_src, W]`` transpose
(``parallel/shuffle.py``).

The pod: a :class:`HostTopology` ``(H, L)`` is a factorization P = H*L of
that axis, host-major. Inside one process the "hosts" axis is a second
transpose on the same device (``parallel/exchange2.py``); across
processes it is ``torch.distributed`` (:func:`initialize_distributed`,
gloo: each process stages its host buckets through host memory,
``parallel/pod.py``).

Because the shards are logical, a live rescale's shard ceiling is a
choice, not a count of cards: :func:`logical_shard_ceiling`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from flink_tpu_torch.core.device import DeviceLike, resolve_device

#: name of the key-group axis (kept from the reference for readability)
KEY_AXIS = "keygroups"
#: axis names of the (hosts, local) view the two-level exchange uses
HOST_AXIS = "hosts"
LOCAL_AXIS = "local"


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


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """The ``(hosts, local)`` factorization of the key-group axis.

    ``num_hosts`` is the process dimension, ``local_devices`` the shards
    of each host. The flat shard index is host-major: shard ``p`` lives on
    host ``p // local_devices`` at local index ``p % local_devices``. A
    one-process mesh may declare a virtual topology (2x4 over 8 logical
    shards); the exchange programs only see the factorization."""

    num_hosts: int
    local_devices: int

    def __post_init__(self):
        if self.num_hosts < 1 or self.local_devices < 1:
            raise ValueError(
                f"topology must be positive, got "
                f"{self.num_hosts}x{self.local_devices}")

    @property
    def num_shards(self) -> int:
        return self.num_hosts * self.local_devices

    def host_of_shard(self, shard: int) -> int:
        return int(shard) // self.local_devices

    def shards_of_host(self, host: int) -> range:
        h = int(host)
        if not (0 <= h < self.num_hosts):
            raise ValueError(
                f"no host {h} in a {self.num_hosts}-host topology")
        return range(h * self.local_devices,
                     (h + 1) * self.local_devices)

    def check_covers(self, num_shards: int) -> None:
        """Raise unless this factorization describes exactly
        ``num_shards`` shards (the one validation every consumer —
        engines, watchdog, pod plane — applies)."""
        if self.num_shards != int(num_shards):
            raise ValueError(
                f"host topology {self.num_hosts}x"
                f"{self.local_devices} does not cover a "
                f"{int(num_shards)}-shard mesh")


def process_topology(local_shards: int) -> HostTopology:
    """The process topology: one host per ``torch.distributed`` process
    (1 when no process group is up) with ``local_shards`` logical shards
    each. The shards are logical, so the local count is the caller's
    choice and never ``torch.cuda.device_count()``."""
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return HostTopology(int(world), int(local_shards))


def pod_mesh_view(mesh: LogicalMesh,
                  topology: HostTopology) -> Tuple[int, int]:
    """The ``(hosts, local)`` view of a flat logical mesh: the same
    shards, host-major, so a ``[P, ...]`` plane reshapes to
    ``[H, L, ...]`` without a copy."""
    topology.check_covers(mesh.size)
    return topology.num_hosts, topology.local_devices


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, backend: str = "gloo") -> None:
    """Join a ``num_processes`` pod as ``process_id``: a
    ``torch.distributed`` process group over ``backend`` at
    ``coordinator_address`` (``host:port``, or a full ``tcp://`` URL).
    Nothing on a machine announces a cluster, so the caller gives all
    three. Gloo is the transport on one card: NCCL refuses two ranks on
    one device."""
    import torch.distributed as dist

    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
