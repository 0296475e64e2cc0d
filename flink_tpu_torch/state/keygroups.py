"""Key groups — the unit of state partitioning (port of
``flink_tpu/state/keygroups.py``; the formulas must stay bit-exact, since
they decide which shard owns a key).

- ``key_group(key) = murmur(fold64to32(key_id)) % max_parallelism``
- owning shard of a group: ``group * parallelism // max_parallelism``,
  or an explicit :class:`KeyGroupAssignment` table once a live rebalance
  moved groups off that layout
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def murmur_fmix32(h: np.ndarray) -> np.ndarray:
    """Vectorized MurmurHash3 32-bit finalizer."""
    h = np.asarray(h, dtype=np.uint32).copy()
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — the stable 64-bit mixer of the hot-key
    salts (bit for bit the reference's, so a replay salts the same)."""
    x = np.asarray(x, dtype=np.uint64).copy()
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _fnv1a_64_bytes(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def hash_keys_to_i64(values: np.ndarray) -> np.ndarray:
    """Stable int64 identity for a key column: integers pass through,
    floats are bit-cast, strings/objects get FNV-1a over their UTF-8
    bytes."""
    values = np.asarray(values)
    if values.dtype.kind in "iu":
        return values.astype(np.int64, copy=False)
    if values.dtype.kind == "f":
        return values.view(np.int64) if values.dtype == np.float64 else \
            values.astype(np.float64).view(np.int64)
    if values.dtype.kind in "US":
        values = values.astype(object)
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        data = v.encode("utf-8") if isinstance(v, str) else (
            v if isinstance(v, bytes) else repr(v).encode("utf-8"))
        out[i] = np.int64(np.uint64(_fnv1a_64_bytes(data)))
    return out


def assign_key_groups(key_ids: np.ndarray, max_parallelism: int) -> np.ndarray:
    """key id -> key group: fold 64->32 bit, murmur-finalize, modulo."""
    k = np.asarray(key_ids, dtype=np.int64)
    folded = (k ^ (k >> np.int64(32))).astype(np.uint32)
    spread = murmur_fmix32(folded)
    return (spread % np.uint32(max_parallelism)).astype(np.int32)


def key_group_to_operator_index(
    key_groups: np.ndarray, max_parallelism: int, parallelism: int
) -> np.ndarray:
    """group -> owning shard: ``group * parallelism // max_parallelism``."""
    g = np.asarray(key_groups, dtype=np.int64)
    return (g * parallelism // max_parallelism).astype(np.int32)


def shard_key_group_ranges(parallelism: int, max_parallelism: int,
                           key_group_range=None) -> List[Tuple[int, int]]:
    """GLOBAL ``(first, last)`` inclusive key groups owned by each of the
    ``parallelism`` mesh shards — the exact inverse of
    ``parallel.shuffle.shard_records``' routing (with the local-space remap
    of a sub-range engine): the split shard-granular checkpoints key their
    units by. Shard p owns ``[ceil(p*span/P), ((p+1)*span - 1) // P]``."""
    if key_group_range is None:
        first, span = 0, int(max_parallelism)
    else:
        first = int(key_group_range[0])
        span = int(key_group_range[1]) - first + 1
    P = int(parallelism)
    return [(first + (p * span + P - 1) // P,
             first + ((p + 1) * span - 1) // P) for p in range(P)]


@dataclasses.dataclass(frozen=True)
class KeyGroupRange:
    """Inclusive [start, end] range of key groups owned by one subtask
    (flink-runtime's KeyGroupRange)."""

    start: int
    end: int  # inclusive

    @property
    def num_key_groups(self) -> int:
        return self.end - self.start + 1

    def __contains__(self, group: int) -> bool:
        return self.start <= group <= self.end

    def intersect(self, other: "KeyGroupRange") -> "KeyGroupRange":
        return KeyGroupRange(max(self.start, other.start),
                             min(self.end, other.end))

    @property
    def empty(self) -> bool:
        return self.end < self.start


def compute_key_group_range(max_parallelism: int, parallelism: int,
                            operator_index: int) -> KeyGroupRange:
    """The contiguous group range owned by subtask ``operator_index``
    (KeyGroupRangeAssignment.computeKeyGroupRangeForOperatorIndex)."""
    start = (operator_index * max_parallelism + parallelism - 1) \
        // parallelism
    end = ((operator_index + 1) * max_parallelism - 1) // parallelism
    return KeyGroupRange(start, end)


def all_ranges(max_parallelism: int, parallelism: int
               ) -> List[KeyGroupRange]:
    """Every subtask's range, in operator-index order."""
    return [compute_key_group_range(max_parallelism, parallelism, i)
            for i in range(parallelism)]


def host_key_group_ranges(num_hosts: int, local_devices: int,
                          max_parallelism: int,
                          key_group_range=None) -> List[tuple]:
    """GLOBAL ``(first, last)`` inclusive key groups owned by each host
    of a ``num_hosts x local_devices`` mesh: the stable host ->
    key-group-range map. Host ``h`` owns the union of its local shards'
    ranges, contiguous because shard ranges are contiguous and
    host-major adjacent, so a lost host is "lose ``local_devices`` shard
    units, restore them, replay one contiguous range"."""
    shard_ranges = shard_key_group_ranges(
        int(num_hosts) * int(local_devices), max_parallelism,
        key_group_range)
    L = int(local_devices)
    return [(shard_ranges[h * L][0], shard_ranges[h * L + L - 1][1])
            for h in range(int(num_hosts))]


def host_of_key_group(key_groups: np.ndarray, num_hosts: int,
                      local_devices: int, max_parallelism: int,
                      assignment: "KeyGroupAssignment" = None
                      ) -> np.ndarray:
    """key group -> owning host: the shard formula (or a live
    ``assignment``'s table, which serving-side routing must follow after
    a rebalance) composed with the host-major shard layout
    (``shard // local_devices``)."""
    if assignment is not None:
        shard = assignment.shard_of_groups(key_groups)
    else:
        shard = key_group_to_operator_index(
            key_groups, max_parallelism,
            int(num_hosts) * int(local_devices))
    return (np.asarray(shard, dtype=np.int64)
            // int(local_devices)).astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class KeyGroupAssignment:
    """Explicit (possibly non-contiguous) key-group -> shard table:
    ``table[local_group]`` owns global group ``first + local_group``. A
    live rebalance installs one to move hot groups between shards
    without changing the shard count. :meth:`contiguous` reproduces
    ``shard_records``' formula bit for bit. Frozen and compared by
    identity; mutators return new instances."""

    first: int
    num_shards: int
    table: np.ndarray  # int32 [span]: local group -> shard

    def __post_init__(self):
        t = np.ascontiguousarray(self.table, dtype=np.int32)
        if t.ndim != 1 or len(t) == 0:
            raise ValueError("assignment table must be a non-empty 1-D array")
        if int(self.num_shards) <= 0:
            raise ValueError(
                f"num_shards must be positive, got {self.num_shards}")
        if t.min() < 0 or t.max() >= int(self.num_shards):
            raise ValueError(
                f"assignment table values must be in [0, {self.num_shards}), "
                f"got range [{t.min()}, {t.max()}]")
        object.__setattr__(self, "table", t)
        object.__setattr__(self, "first", int(self.first))
        object.__setattr__(self, "num_shards", int(self.num_shards))

    @classmethod
    def contiguous(cls, parallelism: int, max_parallelism: int,
                   key_group_range=None) -> "KeyGroupAssignment":
        """The default layout (with a sub-range engine's local remap)."""
        if key_group_range is None:
            first, span = 0, int(max_parallelism)
        else:
            first = int(key_group_range[0])
            span = int(key_group_range[1]) - first + 1
        local = np.arange(span, dtype=np.int64)
        table = (local * int(parallelism) // span).astype(np.int32)
        return cls(first=first, num_shards=int(parallelism), table=table)

    def move(self, groups: Sequence, dst_shard: int) -> "KeyGroupAssignment":
        """A new assignment with GLOBAL ``groups`` on ``dst_shard``."""
        g = np.asarray(groups, dtype=np.int64) - self.first
        if len(g) and (g.min() < 0 or g.max() >= len(self.table)):
            raise ValueError(f"groups out of range [{self.first}, "
                             f"{self.first + len(self.table) - 1}]")
        table = self.table.copy()
        table[g] = np.int32(dst_shard)
        return KeyGroupAssignment(self.first, self.num_shards, table)

    def shard_of_groups(self, key_groups: np.ndarray) -> np.ndarray:
        """GLOBAL key group -> owning shard."""
        return self.table[np.asarray(key_groups, dtype=np.int64) - self.first]

    def shard_of_keys(self, key_ids: np.ndarray,
                      max_parallelism: int) -> np.ndarray:
        """key id -> owning shard (the group spread, then the table)."""
        return self.shard_of_groups(
            assign_key_groups(key_ids, max_parallelism))

    def groups_of_shard(self, shard: int) -> np.ndarray:
        """GLOBAL key groups owned by ``shard``, ascending."""
        return (np.nonzero(self.table == np.int32(shard))[0]
                + self.first).astype(np.int64)

    @property
    def span(self) -> int:
        return len(self.table)

    @property
    def is_contiguous(self) -> bool:
        """True iff the table equals the default contiguous layout."""
        local = np.arange(len(self.table), dtype=np.int64)
        expect = (local * self.num_shards // len(self.table)).astype(np.int32)
        return bool(np.array_equal(self.table, expect))

    def runs(self) -> List[tuple]:
        """Maximal GLOBAL ``(first, last, shard)`` same-shard runs in
        group order: the checkpoint-unit granularity under a
        non-contiguous layout."""
        t = self.table
        cuts = np.nonzero(t[1:] != t[:-1])[0] + 1
        starts = np.concatenate(([0], cuts))
        ends = np.concatenate((cuts - 1, [len(t) - 1]))
        return [(int(s) + self.first, int(e) + self.first, int(t[s]))
                for s, e in zip(starts, ends)]


def validate_max_parallelism(max_parallelism: int) -> None:
    if not (1 <= max_parallelism <= (1 << 15)):
        raise ValueError(
            f"max_parallelism must be in [1, 32768], got {max_parallelism}")
