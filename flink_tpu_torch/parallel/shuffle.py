"""The keyed exchange on the logical mesh (port of
``flink_tpu/parallel/shuffle.py``, device mode).

A batch goes host->device ONCE as flat padded columns
(:func:`stage_device_exchange`); :func:`build_exchange_scatter` then ranks
each source shard's chunk within its destinations (the exchange-rank
kernel), scatters the chunk into per-destination buckets, exchanges the
buckets — on one device the reference's ``all_to_all`` is a
``[P_src, P_dst, W] -> [P_dst, P_src, W]`` transpose — and folds the
received rows into the ``[P, capacity]`` accumulator planes, in place.

Received lanes are ordered (source shard, rank); chunks partition the
stream contiguously, so this is stream order per destination — the order
the reference folds in. Float leaves fold in that order on the card too
(the ordered-fold kernel, ``stateplane/fold.py``); integer leaves keep
``scatter_add_``, exact in any order.

Not in this slice: the host-bucketing data plane (``shuffle.mode=host``),
the repartition/combine collectives, and chaos injection.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops.segment_ops import (
    fold_slots,
    pad_bucket_size,
    scatter_fold,
    torch_dtype,
)
from flink_tpu_torch.parallel.mesh import LogicalMesh
from flink_tpu_torch.state.keygroups import (
    assign_key_groups,
    key_group_to_operator_index,
)
from flink_tpu_torch.stateplane.rank import exchange_rank_flat


class ShuffleBufferPool:
    """Reused host staging buffers. Buffers rotate through ``generations``
    slots and a caller ``flip()``s once per batch, so with dispatch-ahead
    <= generations a buffer is only rewritten after the dispatch that read
    it has completed (the engines fence their dispatch depth)."""

    def __init__(self, generations: int = 2) -> None:
        self.generations = max(int(generations), 1)
        self._gen = 0
        self._bufs: Dict[tuple, np.ndarray] = {}

    def flip(self) -> None:
        """Advance to the next buffer generation (call once per batch)."""
        self._gen = (self._gen + 1) % self.generations

    def get(self, shape: tuple, dtype, fill, tag=None) -> np.ndarray:
        """A [shape] buffer pre-filled with ``fill``; ``tag``
        disambiguates same-shaped buffers used within one generation."""
        dtype = np.dtype(dtype)
        key = (self._gen, shape, dtype.str, tag)
        buf = self._bufs.get(key)
        if buf is None:
            buf = np.empty(shape, dtype=dtype)
            self._bufs[key] = buf
        buf.fill(fill)
        return buf


def shard_records(key_ids: np.ndarray, num_shards: int,
                  max_parallelism: int, key_group_range=None) -> np.ndarray:
    """key id -> owning shard (the keyBy routing decision). With
    ``key_group_range`` = (first, last) the formula applies to the local
    group space of that range."""
    groups = assign_key_groups(key_ids, max_parallelism)
    if key_group_range is not None:
        first, last = key_group_range
        local = np.asarray(groups, dtype=np.int64) - int(first)
        local_max = int(last) - int(first) + 1
        return ((local * num_shards) // local_max).astype(np.int64)
    return key_group_to_operator_index(groups, max_parallelism, num_shards)


def exchange_chunk_size(n: int, num_shards: int,
                        min_bucket: int = 256) -> int:
    """Per-shard flat-column chunk length for ``n`` records: the
    ``pad_bucket_size`` tier of ``ceil(n / num_shards)``."""
    per = -(-max(int(n), 1) // num_shards)
    return pad_bucket_size(per, minimum=min_bucket)


def stage_device_exchange(
    shard_of_record: np.ndarray,
    num_shards: int,
    columns: Sequence[np.ndarray],
    fills: Sequence,
    min_bucket: int = 256,
    pool: Optional[ShuffleBufferPool] = None,
) -> Tuple[np.ndarray, List[np.ndarray], int]:
    """Stage flat record columns for the exchange: every column copied once
    into a padded buffer of length ``num_shards * C``; padded lanes carry
    the out-of-range destination ``num_shards``.

    Returns ``(dst, staged_columns, bucket_width)``; ``bucket_width`` is
    the ``pad_bucket_size`` tier of the batch's densest (source chunk,
    destination) pair count, capped at ``C``."""
    shard_of_record = np.asarray(shard_of_record)
    n = len(shard_of_record)
    columns = [np.asarray(c) for c in columns]
    C = exchange_chunk_size(n, num_shards, min_bucket)
    N = num_shards * C
    dst = (pool.get((N,), np.int32, num_shards, tag=("xchg", "dst"))
           if pool is not None
           else np.full(N, num_shards, dtype=np.int32))
    dst[:n] = shard_of_record
    staged: List[np.ndarray] = []
    for ci, (col, fill) in enumerate(zip(columns, fills)):
        shape = (N,) + col.shape[1:]
        if pool is not None:
            buf = pool.get(shape, col.dtype, fill, tag=("xchg", ci))
        else:
            buf = np.full(shape, fill, dtype=col.dtype)
        buf[:n] = col
        staged.append(buf)
    if n:
        chunk_of = np.arange(n, dtype=np.int64) // C
        pair_max = int(np.bincount(
            chunk_of * (num_shards + 1)
            + np.minimum(dst[:n], num_shards),
            minlength=num_shards * (num_shards + 1))
            .reshape(num_shards, num_shards + 1)[:, :num_shards].max())
    else:
        pair_max = 0
    bucket_width = min(pad_bucket_size(pair_max, minimum=min_bucket), C)
    return dst, staged, bucket_width


def build_exchange_scatter(mesh: LogicalMesh, agg, valued: bool = False):
    """The fused exchange+scatter step over the ``[P, capacity]`` planes:
    ``(accs, dst, slots, values, bucket_width) -> accs``.

    ``dst``/``slots``/``values`` are the flat staged columns (length
    ``P * C``) on the planes' device. ``valued=False`` folds raw
    input-leaf values (const leaves derive on the device); ``valued=True``
    folds one explicit value column per accumulator leaf. The planes are
    updated IN PLACE — where the reference donated them to its jitted
    program — and returned."""
    leaves = agg.leaves
    tdtypes = tuple(torch_dtype(l.dtype) for l in leaves)
    methods = tuple(scatter_fold(l.reduce, td)
                    for l, td in zip(leaves, tdtypes))
    idents = tuple(np.asarray(l.identity).item() for l in leaves)
    P = int(mesh.size)

    def exchange_scatter(accs, dst, slots, values, bucket_width):
        W = int(bucket_width)
        C = dst.numel() // P
        # rank within destination per source row -> int64 flat bucket
        # offset in [0, P*W], P*W being the sentinel of padded/overflow
        # lanes (one kernel launch on the card)
        flat = exchange_rank_flat(dst.view(P, C), P, W)

        def exchange(col: torch.Tensor, fill) -> torch.Tensor:
            # [P_src, C] lanes -> buckets [P_src, P_dst * W] (+1 sentinel
            # column that collects the dropped lanes and is cut off) ->
            # the all_to_all as a transpose -> [P_dst, P_src * W]
            buf = torch.full((P, P * W + 1), fill, dtype=col.dtype,
                             device=col.device)
            buf.scatter_(1, flat, col.view(P, C))
            return (buf[:, :P * W].reshape(P, P, W).transpose(0, 1)
                    .reshape(P, P * W))

        # [P_dst, P_src * W] int32 slots: shard p folds row p into plane
        # p, as the reference's per-shard a.at[0, recv_s]
        recv_s = exchange(slots, 0)
        vals = iter(values)
        for a, m, idx, l, td, ident in zip(accs, methods,
                                           fold_slots(recv_s, tdtypes),
                                           leaves, tdtypes, idents):
            if not valued and l.const is not None:
                # lanes that received no record hold slot 0 (the
                # reserved identity slot) — keep it pure
                v = torch.full(recv_s.shape, l.const, dtype=td,
                               device=recv_s.device)
                v.masked_fill_(recv_s == 0, ident)
            else:
                v = exchange(next(vals), ident)
            m(a, idx, v)
        return accs

    return exchange_scatter
