"""Key groups — the unit of state partitioning (port of
``flink_tpu/state/keygroups.py``; the formulas must stay bit-exact, since
they decide which shard owns a key).

- ``key_group(key) = murmur(fold64to32(key_id)) % max_parallelism``
- owning shard of a group: ``group * parallelism // max_parallelism``
"""

from __future__ import annotations

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
