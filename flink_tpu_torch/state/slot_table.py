"""Host half of the keyed state table: ``(key_id, namespace) -> slot``
(port of the slot-index part of ``flink_tpu/state/slot_table.py``).

The accumulators themselves live on the device in the engines' ``[P,
capacity]`` planes; each shard keeps one index here. Slot 0 is reserved as
the identity slot (padding target). Capacity grows by doubling and is
signalled through ``on_grow(old, new)`` so the owner widens its planes in
lockstep. The namespace doubles as the slice end, and a namespace ->
slots registry makes slice expiry O(freed).

Not in this slice: ``SlotTable`` (the single-device engine's table) and
``SpillTier`` — see ROADMAP.md, Queue A.
"""

from __future__ import annotations

import ctypes as _ct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def unique_pairs(
    key_ids: np.ndarray, namespaces: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized grouping of (key, namespace) pairs: returns
    (unique_keys, unique_namespaces, inverse)."""
    n = len(key_ids)
    if n == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0, dtype=np.int64)
    order = np.lexsort((key_ids, namespaces))
    ks, ns = key_ids[order], namespaces[order]
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = (ks[1:] != ks[:-1]) | (ns[1:] != ns[:-1])
    group_of_sorted = np.cumsum(new_group) - 1
    inverse = np.empty(n, dtype=np.int64)
    inverse[order] = group_of_sorted
    first_pos = order[new_group]
    return key_ids[first_pos], namespaces[first_pos], inverse


class SlotTableFullError(RuntimeError):
    """Slot budget exhausted."""


class _NamespaceRegistry:
    """namespace -> slots registry shared by both index implementations."""

    def _init_registry(self) -> None:
        self._ns_slots: Dict[int, List[np.ndarray]] = {}

    @property
    def namespaces(self) -> List[int]:
        return list(self._ns_slots.keys())

    def slots_for_namespace(self, ns: int) -> np.ndarray:
        chunks = self._ns_slots.get(ns)
        if not chunks:
            return np.empty(0, dtype=np.int32)
        if len(chunks) > 1:
            merged = np.concatenate(chunks)
            self._ns_slots[ns] = [merged]
            return merged
        return chunks[0]

    def _registry_drain(self, namespaces: List[int]) -> Optional[np.ndarray]:
        """Remove and return all slots registered under ``namespaces``."""
        freed: List[np.ndarray] = []
        for ns in namespaces:
            chunks = self._ns_slots.pop(ns, None)
            if chunks:
                freed.extend(chunks)
        if not freed:
            return None
        return np.concatenate(freed)


class HostSlotIndex(_NamespaceRegistry):
    """Pure-Python index: a dict probe per distinct pair of a batch."""

    def __init__(self, capacity: int,
                 on_grow: Optional[Callable[[int, int], None]] = None,
                 growable: bool = True,
                 full_hint: str = "raise state.slot-table.capacity",
                 max_capacity: int = 0) -> None:
        self.capacity = max(int(capacity), 1024)
        self.on_grow = on_grow
        self.growable = growable
        self.full_hint = full_hint
        self.max_capacity = int(max_capacity or 0)
        self._index: Dict[Tuple[int, int], int] = {}
        self.slot_key = np.zeros(self.capacity, dtype=np.int64)
        self.slot_ns = np.zeros(self.capacity, dtype=np.int64)
        self.slot_used = np.zeros(self.capacity, dtype=bool)
        self._free: List[int] = list(range(self.capacity - 1, 0, -1))
        self._init_registry()

    @property
    def num_used(self) -> int:
        return int(self.slot_used.sum())

    def lookup_or_insert(self, key_ids: np.ndarray,
                         namespaces: np.ndarray) -> np.ndarray:
        """(key, ns) -> slot per record; allocates missing slots."""
        uk, un, inverse = unique_pairs(
            np.asarray(key_ids, dtype=np.int64),
            np.asarray(namespaces, dtype=np.int64))
        uslots = np.empty(len(uk), dtype=np.int32)
        index = self._index
        new_by_ns: Dict[int, List[int]] = {}
        for j in range(len(uk)):
            pair = (int(uk[j]), int(un[j]))
            slot = index.get(pair)
            if slot is None:
                slot = self._allocate()
                index[pair] = slot
                self.slot_key[slot] = pair[0]
                self.slot_ns[slot] = pair[1]
                self.slot_used[slot] = True
                new_by_ns.setdefault(pair[1], []).append(slot)
            uslots[j] = slot
        for ns, slots in new_by_ns.items():
            self._ns_slots.setdefault(ns, []).append(
                np.asarray(slots, dtype=np.int32))
        return uslots[inverse]

    def lookup(self, key_ids: np.ndarray,
               namespaces: np.ndarray) -> np.ndarray:
        """Read-only probe: slot per pair, -1 where absent."""
        keys = np.asarray(key_ids, dtype=np.int64)
        nss = np.asarray(namespaces, dtype=np.int64)
        return np.asarray([self._index.get((int(k), int(v)), -1)
                           for k, v in zip(keys, nss)], dtype=np.int32)

    def _allocate(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def _grow(self) -> None:
        if not self.growable or (
                self.max_capacity and self.capacity >= self.max_capacity):
            raise SlotTableFullError(
                f"slot table full (capacity={self.capacity}) and not "
                f"growable; {self.full_hint}")
        old = self.capacity
        new_capacity = old * 2
        if self.max_capacity:
            new_capacity = min(new_capacity, self.max_capacity)
        extra = new_capacity - old
        self.slot_key = np.concatenate(
            [self.slot_key, np.zeros(extra, dtype=np.int64)])
        self.slot_ns = np.concatenate(
            [self.slot_ns, np.zeros(extra, dtype=np.int64)])
        self.slot_used = np.concatenate(
            [self.slot_used, np.zeros(extra, dtype=bool)])
        self._free.extend(range(new_capacity - 1, old - 1, -1))
        self.capacity = new_capacity
        if self.on_grow is not None:
            self.on_grow(old, new_capacity)

    def free_namespaces(self, namespaces: List[int]) -> Optional[np.ndarray]:
        """Release all slots of the given namespaces. Returns freed slots."""
        slots = self._registry_drain(namespaces)
        if slots is None:
            return None
        sk, sn = self.slot_key, self.slot_ns
        for s in slots.tolist():
            self._index.pop((int(sk[s]), int(sn[s])), None)
        self.slot_used[slots] = False
        self._free.extend(slots.tolist())
        return slots



_I64P = _ct.POINTER(_ct.c_int64)
_I32P = _ct.POINTER(_ct.c_int32)
_U8P = _ct.POINTER(_ct.c_uint8)


class NativeSlotIndex(_NamespaceRegistry):
    """C++-backed drop-in for HostSlotIndex (native/slotmap.cpp): the batch
    probe runs in native code, the slot metadata is exposed zero-copy."""

    def __init__(self, capacity: int,
                 on_grow: Optional[Callable[[int, int], None]] = None,
                 growable: bool = True,
                 full_hint: str = "raise state.slot-table.capacity",
                 max_capacity: int = 0) -> None:
        from flink_tpu_torch.native import load_slotmap

        self._lib = load_slotmap()
        if self._lib is None:
            raise RuntimeError("native slotmap library unavailable")
        self.capacity = max(int(capacity), 1024)
        self.on_grow = on_grow
        self.growable = growable
        self.full_hint = full_hint
        self.max_capacity = int(max_capacity or 0)
        max_cap = (self.max_capacity or (1 << 28)) if growable \
            else self.capacity
        self._h = self._lib.sm_create(self.capacity, max_cap)
        self._wrap_views()
        self._init_registry()

    def _wrap_views(self) -> None:
        cap = int(self._lib.sm_capacity(self._h))
        self.capacity = cap
        self.slot_key = np.ctypeslib.as_array(
            self._lib.sm_slot_keys(self._h), shape=(cap,))
        self.slot_ns = np.ctypeslib.as_array(
            self._lib.sm_slot_namespaces(self._h), shape=(cap,))
        self.slot_used = np.ctypeslib.as_array(
            self._lib.sm_slot_used(self._h), shape=(cap,)).view(bool)

    def __del__(self):  # pragma: no cover - finalizer
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.sm_destroy(h)
            self._h = None

    @property
    def num_used(self) -> int:
        return int(self._lib.sm_used(self._h))

    def lookup_or_insert(self, key_ids: np.ndarray,
                         namespaces: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(key_ids, dtype=np.int64)
        nss = np.ascontiguousarray(namespaces, dtype=np.int64)
        n = len(keys)
        out = np.empty(n, dtype=np.int32)
        is_new = np.empty(n, dtype=np.uint8)
        old_cap = self.capacity
        rc = self._lib.sm_lookup_or_insert(
            self._h, n,
            keys.ctypes.data_as(_I64P), nss.ctypes.data_as(_I64P),
            out.ctypes.data_as(_I32P), is_new.ctypes.data_as(_U8P))
        if rc < 0:
            raise SlotTableFullError(
                f"slot table full (capacity={self.capacity}) and not "
                f"growable; {self.full_hint}")
        if rc > 0:
            self._wrap_views()
            if self.on_grow is not None:
                self.on_grow(old_cap, self.capacity)
        new_mask = is_new.view(bool)
        if new_mask.any():
            new_slots = out[new_mask]
            new_ns = nss[new_mask]
            order = np.argsort(new_ns, kind="stable")
            sorted_ns = new_ns[order]
            sorted_slots = new_slots[order]
            boundaries = np.nonzero(np.diff(sorted_ns))[0] + 1
            chunks = np.split(sorted_slots, boundaries)
            firsts = np.concatenate(([0], boundaries))
            reg = self._ns_slots
            for ns, chunk in zip(sorted_ns[firsts].tolist(), chunks):
                reg.setdefault(ns, []).append(chunk)
        return out

    def lookup(self, key_ids: np.ndarray,
               namespaces: np.ndarray) -> np.ndarray:
        """Read-only probe via the native table: -1 where absent."""
        keys = np.ascontiguousarray(key_ids, dtype=np.int64)
        nss = np.ascontiguousarray(namespaces, dtype=np.int64)
        out = np.empty(len(keys), dtype=np.int32)
        self._lib.sm_lookup(self._h, len(keys),
                            keys.ctypes.data_as(_I64P),
                            nss.ctypes.data_as(_I64P),
                            out.ctypes.data_as(_I32P))
        return out

    def free_namespaces(self, namespaces: List[int]) -> Optional[np.ndarray]:
        drained = self._registry_drain(namespaces)
        if drained is None:
            return None
        slots = np.ascontiguousarray(drained, dtype=np.int32)
        keys = np.ascontiguousarray(self.slot_key[slots])
        nss = np.ascontiguousarray(self.slot_ns[slots])
        out = np.empty(len(slots), dtype=np.int32)
        n = self._lib.sm_erase(
            self._h, len(slots),
            keys.ctypes.data_as(_I64P), nss.ctypes.data_as(_I64P),
            out.ctypes.data_as(_I32P))
        return out[:n]


def make_slot_index(capacity: int, on_grow=None, growable: bool = True,
                    full_hint: str = "raise state.slot-table.capacity",
                    max_capacity: int = 0):
    """Native index when the C++ library builds, else pure Python."""
    from flink_tpu_torch.native import load_slotmap

    cls = NativeSlotIndex if load_slotmap() is not None else HostSlotIndex
    return cls(capacity, on_grow=on_grow, growable=growable,
               full_hint=full_hint, max_capacity=max_capacity)
