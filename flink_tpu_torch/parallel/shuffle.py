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

The chaos payload point ``shuffle.device_exchange`` (drop or duplicate one
shard's records) sits in :func:`stage_device_exchange`, as in the
reference.

The host-bucketing data plane (``shuffle.mode=host``):
:func:`bucket_by_shard` groups the records into a dense ``[P, B]`` block
per column on the host (its chaos points ``shuffle.bucket_prep`` and
``shuffle.bucket_send``), and the engines fold the blocks with their
``[P, B]`` scatter step. :func:`make_all_to_all_repartition` and
:func:`make_global_combine` are the reference's collectives on the
logical mesh: a transpose and a reduction over the leading shard axis.
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
from flink_tpu_torch.parallel.mesh import LogicalMesh
from flink_tpu_torch.state.keygroups import (
    assign_key_groups,
    key_group_to_operator_index,
)
from flink_tpu_torch.stateplane.rank import exchange_rank_flat
from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE


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


def bucket_by_shard(
    shard_of_record: np.ndarray,
    num_shards: int,
    columns: Sequence[np.ndarray],
    fills: Sequence,
    min_bucket: int = 256,
    pool: Optional[ShuffleBufferPool] = None,
    want_order: bool = False,
):
    """Group records into a dense ``[num_shards, B]`` block per column on
    the host: ``(counts[num_shards], blocks)``, the records of shard p at
    ``block[p, :counts[p]]`` in stream order (with ``want_order`` the
    applied permutation too). One stable argsort, then one fancy scatter
    per column through a flat index.

    Chaos (armed only): ``shuffle.bucket_prep`` fires once; per non-empty
    shard ``shuffle.bucket_send`` may drop its bucket (its rows refill
    with the fills, so they fold identities into slot 0 and vanish) or
    duplicate it (``B`` is padded to hold the copy)."""
    shard_of_record = np.asarray(shard_of_record)
    n = len(shard_of_record)
    counts = np.bincount(shard_of_record, minlength=num_shards)
    mutations: Dict[int, str] = {}
    if chaos.armed():
        chaos.fault_point("shuffle.bucket_prep", num_shards=num_shards)
        for p in np.nonzero(counts)[0].tolist():
            rule = chaos.payload_action("shuffle.bucket_send", shard=p)
            if rule is not None and rule.kind in ("drop", "duplicate"):
                mutations[p] = rule.kind
    eff_counts = counts
    if mutations:
        eff_counts = counts.copy()
        for p, kind in mutations.items():
            if kind == "duplicate":
                eff_counts[p] = counts[p] * 2
    B = pad_bucket_size(int(eff_counts.max()) if n else 0,
                        minimum=min_bucket)
    order = np.argsort(shard_of_record, kind="stable")
    offsets = np.zeros(num_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    sorted_shard = shard_of_record[order]
    # sorted record j lands at its shard's row, column j - offsets[shard]
    flat_dst = (sorted_shard * B
                + np.arange(n, dtype=np.int64) - offsets[sorted_shard])
    blocked = []
    for ci, (col, fill) in enumerate(zip(columns, fills)):
        col = np.asarray(col)
        shape = (num_shards, B) + col.shape[1:]
        if pool is not None:
            block = pool.get(shape, col.dtype, fill, tag=("bucket", ci))
        else:
            block = np.full(shape, fill, dtype=col.dtype)
        block.reshape((num_shards * B,) + col.shape[1:])[flat_dst] = \
            col[order]
        blocked.append(block)
    if mutations:
        for p, kind in mutations.items():
            c = int(counts[p])
            for block, fill in zip(blocked, fills):
                if kind == "drop":
                    block[p, :c] = fill
                else:  # duplicate: replay the bucket's rows
                    block[p, c:2 * c] = block[p, :c]
            eff_counts[p] = 0 if kind == "drop" else 2 * c
        counts = eff_counts
    if want_order:
        return counts, blocked, order
    return counts, blocked


def shard_records(key_ids: np.ndarray, num_shards: int,
                  max_parallelism: int, key_group_range=None,
                  assignment=None) -> np.ndarray:
    """key id -> owning shard (the keyBy routing decision). With
    ``key_group_range`` = (first, last) the formula applies to the local
    group space of that range; an ``assignment``
    (``state.keygroups.KeyGroupAssignment``, a rebalanced plane's table)
    replaces the formula and carries its own range."""
    return shard_of_key_groups(assign_key_groups(key_ids, max_parallelism),
                               num_shards, max_parallelism, key_group_range,
                               assignment)


def shard_of_key_groups(groups: np.ndarray, num_shards: int,
                        max_parallelism: int, key_group_range=None,
                        assignment=None) -> np.ndarray:
    """key group -> owning shard: :func:`shard_records` after the hash."""
    if assignment is not None:
        return assignment.shard_of_groups(groups).astype(np.int64)
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
    destination) pair count, capped at ``C``.

    The chaos payload point ``shuffle.device_exchange`` models a lossy
    exchange: drop re-routes one shard's records to the padding
    destination (they vanish before the exchange), duplicate replays
    them. Raise and delay fire at the engines' post-dispatch site."""
    shard_of_record = np.asarray(shard_of_record)
    n = len(shard_of_record)
    columns = [np.asarray(c) for c in columns]
    if chaos.armed():
        mutations: Dict[int, str] = {}
        present = np.unique(shard_of_record) if n else ()
        for p in present:
            rule = chaos.payload_action(
                "shuffle.device_exchange",
                kinds=("drop", "duplicate", "delay"), shard=int(p))
            if rule is not None and rule.kind in ("drop", "duplicate"):
                mutations[int(p)] = rule.kind
        for p, kind in mutations.items():
            sel = shard_of_record == p
            if kind == "drop":
                shard_of_record = np.where(sel, num_shards,
                                           shard_of_record)
            else:  # duplicate: replay the shard's records
                shard_of_record = np.concatenate(
                    [shard_of_record, shard_of_record[sel]])
                columns = [np.concatenate([c, c[sel]]) for c in columns]
                n = len(shard_of_record)
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
    """Shared through ``PROGRAM_CACHE`` (kind ``exchange-scatter``) per
    (device, shards, aggregate layout, valued): jobs and rebuilt
    engines reuse one family of steps (see ``_build_exchange_scatter``)."""
    key = (str(mesh.device), int(mesh.size), agg.cache_key(), bool(valued))
    return PROGRAM_CACHE.get_or_build(
        "exchange-scatter", key,
        lambda: _build_exchange_scatter(mesh, agg, valued))


def _build_exchange_scatter(mesh: LogicalMesh, agg, valued: bool = False):
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


# ---------------------------------------------------------------------------
# collectives over the leading shard axis
# ---------------------------------------------------------------------------


def make_all_to_all_repartition(mesh: LogicalMesh):
    """``[P, P, B, ...]`` (dim 0 the source shard, dim 1 the destination)
    -> each shard's rows destined to it, dim 1 then indexed by SOURCE
    shard: the reference's ``all_to_all`` between two keyed stages, on one
    device a transpose of the two shard axes."""
    P = int(mesh.size)

    def repartition(block: torch.Tensor) -> torch.Tensor:
        if block.shape[0] != P or block.shape[1] != P:
            raise ValueError(
                f"repartition: a [{P}, {P}, ...] block, got "
                f"{tuple(block.shape)}")
        return block.transpose(0, 1).contiguous()

    return repartition


def make_global_combine(mesh: LogicalMesh, reduce: str = "sum"):
    """Two-phase aggregation: per-shard partials ``[P, ...]`` -> their
    reduction over the shard axis (the reference's ``psum``/``pmax``/
    ``pmin``, replicated on every shard; here one tensor)."""
    fn = {"sum": lambda x: x.sum(dim=0),
          "max": lambda x: x.amax(dim=0),
          "min": lambda x: x.amin(dim=0)}[reduce]
    P = int(mesh.size)

    def combine(partials: torch.Tensor) -> torch.Tensor:
        if partials.shape[0] != P:
            raise ValueError(
                f"combine: {P} shard partials, got {partials.shape[0]}")
        return fn(partials)

    return combine
