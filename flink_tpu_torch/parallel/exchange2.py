"""The two-level exchange (port of ``flink_tpu/parallel/exchange2.py``).

A :class:`~flink_tpu_torch.parallel.mesh.HostTopology` ``(H, L)`` factors
the logical mesh P = H*L, host-major. The keyBy exchange then runs in two
stages instead of one ``[P_src, P_dst]`` transpose:

- **Stage 1 (within a host)**: each source chunk ranks its records within
  their destination's LOCAL index (``exchange_rank_flat`` at D = L, the
  rank kernel on the card), scatters them into ``[L, W1]`` buckets, and
  the local axis is exchanged: ``[H, L_src, L_dst, W1] -> [H, L_dst,
  L_src, W1]``. Every record then sits on the shard of its source host
  whose local index is its destination's.
- **Stage 2 (across hosts)**: each shard ranks its received rows, in
  (source-local, rank) order, within their destination HOST (D = H),
  buckets them ``[H, W2]`` and the host axis is exchanged. The receive
  order (source host, rank) is global stream order, because chunks
  partition the stream host-major, so the fold that follows keeps every
  slot's records in stream order: float leaves fold through the ordered
  fold (``stateplane/fold.py``, its kernel on the card) and come out bit
  for bit equal to the flat exchange's; integer leaves keep
  ``scatter_add_``/``scatter_reduce_``, exact in any order.

Both stages are plain torch functions over the staged columns (one
process: the hosts axis is a second transpose on the same device; several
processes exchange host buckets over ``torch.distributed`` in
``parallel/pod.py``). Each level has its own bucket tier, ``W1`` the
densest (source chunk, destination local index) pair and ``W2`` the
densest (source host, destination shard) pair.

The chaos payload point ``exchange.dcn_send`` models a lossy link between
hosts: drop, duplicate or delay per (source host, destination host)
bucket, cross-host pairs only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.ops.segment_ops import (
    fold_slots,
    pad_bucket_size,
    scatter_fold,
    torch_dtype,
)
from flink_tpu_torch.parallel.mesh import (
    HostTopology,
    LogicalMesh,
    pod_mesh_view,
)
from flink_tpu_torch.stateplane.fold import ordered_fold_planes
from flink_tpu_torch.stateplane.rank import exchange_rank_flat, rank
from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE


class ExchangeTraffic:
    """Per-engine two-level traffic: records that stayed within their
    source host and records that crossed to another host. ``launches``:
    the kernel launches each stage made (the rank kernel in both, the
    ordered fold in stage 2), on the card only."""

    __slots__ = ("rows_intra_host", "rows_cross_host", "batches",
                 "launches")

    def __init__(self) -> None:
        self.rows_intra_host = 0
        self.rows_cross_host = 0
        self.batches = 0
        self.launches = {"stage1_rank": 0, "stage2_rank": 0,
                         "stage2_fold": 0}

    def count_launches(self, stage: int, fn, *args):
        """``fn(*args)``, adding the rank and fold launches it made to
        stage ``stage``'s counts."""
        r0, f0 = rank.launches, ordered_fold_planes.launches
        out = fn(*args)
        self.launches[f"stage{stage}_rank"] += rank.launches - r0
        if stage == 2:
            self.launches["stage2_fold"] += \
                ordered_fold_planes.launches - f0
        return out

    def as_dict(self) -> Dict[str, int]:
        return {"rows_intra_host": self.rows_intra_host,
                "rows_cross_host": self.rows_cross_host,
                "exchange2_batches": self.batches}

    @staticmethod
    def dict_of(traffic) -> Dict[str, int]:
        """``traffic.as_dict()``, or the zero dict of an engine on the
        flat exchange: one shape for every ``exchange2_traffic``."""
        if traffic is not None:
            return traffic.as_dict()
        return ExchangeTraffic().as_dict()


def two_level_active(topology, shuffle_mode: str) -> bool:
    """The activation rule every engine shares: a multi-host
    factorization under the device data plane."""
    return (topology is not None and topology.num_hosts > 1
            and shuffle_mode == "device")


def stage_two_level_exchange(
    shard_of_record: np.ndarray,
    topology: HostTopology,
    columns: Sequence[np.ndarray],
    fills: Sequence,
    min_bucket: int = 256,
    pool=None,
    traffic: Optional[ExchangeTraffic] = None,
) -> Tuple[np.ndarray, List[np.ndarray], int, int]:
    """Stage flat record columns for the two-level exchange: the staging
    contract of :func:`~flink_tpu_torch.parallel.shuffle.
    stage_device_exchange` (flat padded columns of length ``P * C``,
    padded lanes carry the destination ``P``) plus one bucket tier per
    level: ``(dst, staged_columns, w1, w2)``."""
    from flink_tpu_torch.parallel.shuffle import exchange_chunk_size

    H, L = topology.num_hosts, topology.local_devices
    num_shards = topology.num_shards
    shard_of_record = np.asarray(shard_of_record)
    n = len(shard_of_record)
    columns = [np.asarray(c) for c in columns]
    if chaos.armed():
        # link faults per CROSS-host (source, destination) pair; a
        # record's source host is its staging chunk's host, chunked from
        # the length before any mutation so the rule is deterministic
        C0 = exchange_chunk_size(n, num_shards, min_bucket)
        src_host = (np.arange(n, dtype=np.int64) // C0) // L
        dst_host = shard_of_record // L
        cross = src_host != dst_host
        if cross.any():
            pairs = np.unique(
                np.stack([src_host[cross], dst_host[cross]], axis=1),
                axis=0)
            drop_mask = np.zeros(n, dtype=bool)
            dup_mask = np.zeros(n, dtype=bool)
            for sh, dh in pairs.tolist():
                rule = chaos.payload_action(
                    "exchange.dcn_send",
                    kinds=("drop", "duplicate", "delay"),
                    src_host=int(sh), dst_host=int(dh))
                if rule is None:
                    continue
                sel = cross & (src_host == sh) & (dst_host == dh)
                if rule.kind == "drop":
                    drop_mask |= sel
                elif rule.kind == "duplicate":
                    dup_mask |= sel
            if drop_mask.any():
                # a lost bucket: its rows re-route to the padding
                # destination and vanish before stage 1
                shard_of_record = np.where(drop_mask, num_shards,
                                           shard_of_record)
            if dup_mask.any():
                shard_of_record = np.concatenate(
                    [shard_of_record, shard_of_record[dup_mask]])
                columns = [np.concatenate([c, c[dup_mask]])
                           for c in columns]
                n = len(shard_of_record)
    C = exchange_chunk_size(n, num_shards, min_bucket)
    N = num_shards * C
    dst = (pool.get((N,), np.int32, num_shards, tag=("xchg2", "dst"))
           if pool is not None
           else np.full(N, num_shards, dtype=np.int32))
    dst[:n] = shard_of_record
    staged: List[np.ndarray] = []
    for ci, (col, fill) in enumerate(zip(columns, fills)):
        shape = (N,) + col.shape[1:]
        if pool is not None:
            buf = pool.get(shape, col.dtype, fill, tag=("xchg2", ci))
        else:
            buf = np.full(shape, fill, dtype=col.dtype)
        buf[:n] = col
        staged.append(buf)
    w1_max = w2_max = 0
    if n:
        real = dst[:n]
        idx = np.nonzero(real < num_shards)[0]
        d_live = real[idx].astype(np.int64)
        chunk_of = idx // C
        sh = chunk_of // L
        if len(idx):
            # W1: records of chunk c bound for local index l (any host)
            w1_max = int(np.bincount(chunk_of * L + d_live % L,
                                     minlength=num_shards * L).max())
            # W2: records of source host h bound for shard d
            w2_max = int(np.bincount(sh * num_shards + d_live,
                                     minlength=H * num_shards).max())
        if traffic is not None:
            crossed = int((sh != d_live // L).sum())
            traffic.rows_cross_host += crossed
            traffic.rows_intra_host += int(len(idx)) - crossed
    if traffic is not None:
        traffic.batches += 1
    w1 = min(pad_bucket_size(w1_max, minimum=min_bucket), C)
    # stage 2's input is the [L, W1] receive block: one (host, shard)
    # pair fills it at most
    w2 = min(pad_bucket_size(w2_max, minimum=min_bucket), L * w1)
    return dst, staged, w1, w2


# ---------------------------------------------------------------------------
# the two stages
# ---------------------------------------------------------------------------


def _bucket(col: torch.Tensor, flat: torch.Tensor, D: int, W: int,
            fill) -> torch.Tensor:
    """``col [R, C]`` lanes -> ``[R, D, W]`` buckets at ``flat`` (the
    rank's offsets; the sentinel ``D*W`` lands in an extra column that is
    cut off)."""
    R = flat.shape[0]
    buf = torch.full((R, D * W + 1), fill, dtype=col.dtype,
                     device=col.device)
    buf.scatter_(1, flat, col.reshape(R, -1))
    return buf[:, :D * W].view(R, D, W)


def stage1_route(topology: HostTopology, dst: torch.Tensor,
                 columns: Sequence[torch.Tensor], fills: Sequence,
                 w1: int) -> Tuple[torch.Tensor, ...]:
    """Stage 1: route ``(dst, *columns)`` (flat, length ``P * C``) by the
    destination's local index over each host's local axis. Returns
    ``[P, L * W1]`` tensors, the destination shard first (empty lanes hold
    the padding destination ``P``), each shard's lanes in (source-local,
    rank) order."""
    H, L = topology.num_hosts, topology.local_devices
    P = H * L
    W1 = int(w1)
    d = dst.view(P, -1)
    dl = torch.where(d < P, torch.remainder(d, L),
                     torch.full_like(d, L)).contiguous()
    flat = exchange_rank_flat(dl, L, W1)

    def xc_local(col: torch.Tensor, fill) -> torch.Tensor:
        b = _bucket(col, flat, L, W1, fill).view(H, L, L, W1)
        return b.transpose(1, 2).reshape(P, L * W1)

    return (xc_local(dst, P),
            *[xc_local(c, f) for c, f in zip(columns, fills)])


def _stage2_rank(d2: torch.Tensor, topology: HostTopology, w2: int
                 ) -> torch.Tensor:
    """Stage 2's bucketing: rank within destination HOST over the stage-1
    receive order."""
    H, L = topology.num_hosts, topology.local_devices
    P = H * L
    dh = torch.where(d2 < P, torch.div(d2, L, rounding_mode="floor"),
                     torch.full_like(d2, H)).contiguous()
    return exchange_rank_flat(dh, H, int(w2))


def _xc_hosts(col: torch.Tensor, flat: torch.Tensor,
              topology: HostTopology, w2: int, fill) -> torch.Tensor:
    """Bucket by destination host and exchange the host axis:
    ``[H_src, L, H_dst, W2] -> [H_dst, L, H_src, W2]``, flat ``[P, H*W2]``
    in (source host, rank) order."""
    H, L = topology.num_hosts, topology.local_devices
    W2 = int(w2)
    b = _bucket(col, flat, H, W2, fill).view(H, L, H, W2)
    return b.permute(2, 1, 0, 3).reshape(H * L, H * W2)


def _exchanged_leaves(agg, valued: bool):
    """The leaves whose value columns ride the exchange: all of them in
    the valued (two-phase partial) form, else the const-free ones (const
    leaves derive at the fold)."""
    if valued:
        return list(agg.leaves)
    return [l for l in agg.leaves if l.const is None]


def build_exchange2_steps(mesh: LogicalMesh, topology: HostTopology, agg,
                          valued: bool = False):
    """The two-level exchange+fold pair over the ``[P, capacity]``
    planes: ``(stage1, stage2)``. ``stage1(dst, slots, values, w1)``
    returns the intermediate columns; ``stage2(accs, dst2, slots2,
    values2, w2)`` folds them into the planes in place, with the flat
    exchange's per-slot stream order. Shared through ``PROGRAM_CACHE``
    per (device, topology, aggregate layout, valued)."""
    key = (str(mesh.device), topology.num_hosts, topology.local_devices,
           agg.cache_key(), bool(valued))
    return (
        PROGRAM_CACHE.get_or_build(
            "exchange2-stage1", key,
            lambda: _build_fold_stage1(mesh, topology, agg, valued)),
        PROGRAM_CACHE.get_or_build(
            "exchange2-stage2", key,
            lambda: _build_fold_stage2(mesh, topology, agg, valued)),
    )


def _build_fold_stage1(mesh: LogicalMesh, topology: HostTopology, agg,
                       valued: bool):
    pod_mesh_view(mesh, topology)
    fills = tuple(np.asarray(l.identity).item()
                  for l in _exchanged_leaves(agg, valued))

    def stage1(dst, slots, values, w1):
        return stage1_route(topology, dst, (slots, *values),
                            (0, *fills), w1)

    return stage1


def _build_fold_stage2(mesh: LogicalMesh, topology: HostTopology, agg,
                       valued: bool):
    pod_mesh_view(mesh, topology)
    leaves = agg.leaves
    tdtypes = tuple(torch_dtype(l.dtype) for l in leaves)
    methods = tuple(scatter_fold(l.reduce, td)
                    for l, td in zip(leaves, tdtypes))
    idents = tuple(np.asarray(l.identity).item() for l in leaves)

    def stage2(accs, dst2, slots2, values2, w2):
        flat = _stage2_rank(dst2, topology, w2)
        recv_s = _xc_hosts(slots2, flat, topology, w2, 0)
        vals = iter(values2)
        for a, m, idx, l, td, ident in zip(accs, methods,
                                           fold_slots(recv_s, tdtypes),
                                           leaves, tdtypes, idents):
            if not valued and l.const is not None:
                # empty lanes hold slot 0 (the reserved identity slot)
                v = torch.full(recv_s.shape, l.const, dtype=td,
                               device=recv_s.device)
                v.masked_fill_(recv_s == 0, ident)
            else:
                v = _xc_hosts(next(vals), flat, topology, w2, ident)
            m(a, idx, v)
        return accs

    return stage2


def build_join_exchange2_steps(mesh: LogicalMesh, topology: HostTopology,
                               dtypes: Tuple[str, ...]):
    """The two-level form of the joins' exchange-put: stage 1 routes the
    (slot, value...) rows by destination local index, stage 2 crosses the
    host axis and writes the received rows into the side's planes (real
    rows never share a slot within one put; empty lanes write 0 into the
    scratch slot 0)."""
    key = (str(mesh.device), topology.num_hosts, topology.local_devices,
           tuple(dtypes))
    return (
        PROGRAM_CACHE.get_or_build(
            "join-exchange2-stage1", key,
            lambda: _build_join_stage1(mesh, topology, dtypes)),
        PROGRAM_CACHE.get_or_build(
            "join-exchange2-stage2", key,
            lambda: _build_join_stage2(mesh, topology)),
    )


def _build_join_stage1(mesh: LogicalMesh, topology: HostTopology, dtypes):
    pod_mesh_view(mesh, topology)
    n_vals = len(dtypes)

    def stage1(dst, slots, values, w1):
        return stage1_route(topology, dst, (slots, *values),
                            (0,) * (1 + n_vals), w1)

    return stage1


def _build_join_stage2(mesh: LogicalMesh, topology: HostTopology):
    pod_mesh_view(mesh, topology)

    def stage2(planes, dst2, slots2, values2, w2):
        flat = _stage2_rank(dst2, topology, w2)
        recv_s = _xc_hosts(slots2, flat, topology, w2, 0).long()
        for pl, v in zip(planes, values2):
            pl.scatter_(1, recv_s, _xc_hosts(v, flat, topology, w2, 0))
        return planes

    return stage2
