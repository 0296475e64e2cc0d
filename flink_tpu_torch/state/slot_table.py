"""Keyed state tables (port of ``flink_tpu/state/slot_table.py``).

- The index, ``(key_id, namespace) -> slot``, lives on the host
  (``HostSlotIndex``, or ``NativeSlotIndex`` over ``native/slotmap.cpp``).
  Slot 0 is reserved as the identity slot (padding target). Capacity grows
  by doubling and is signalled through ``on_grow(old, new)`` so the owner
  widens its accumulators in lockstep. The namespace doubles as the slice
  end, and a namespace -> slots registry makes slice expiry O(freed). The
  mesh engine keeps one index per shard beside its ``[P, capacity]``
  planes.
- ``SlotTable`` is the single-device engine's table: one index plus flat
  ``[capacity]`` accumulators on the device, one per aggregate leaf,
  updated by the programs of ``stateplane/families.py``. With
  ``max_device_slots`` the device table is a bounded cache over a host
  (then local-filesystem) ``SpillTier``. In the namespace layout the
  least recently touched namespaces are evicted wholesale (one gather +
  one reset) and reload on the next access (one put). In the paged layout
  (``spill_layout="pages"``, the session tables: one row per namespace)
  the coldest rows move as one page per eviction and reload row by row
  (``state/paged_spill.py``).

Snapshots are logical (key_id, namespace, key_group, leaf columns, device
rows and spilled rows alike), so a restore re-shards by key group; a delta
snapshot carries the rows dirtied since the last snapshot plus tombstones
of the freed namespaces and pairs (the reference's format).

Point queries (``query``, ``query_batch_pairs``, ``query_windows``) read
the table without changing it: resident pairs through one gather and one
device-to-host copy, spilled pairs from the host tiers.
``memory=(manager, owner)`` reserves the device footprint from the job's
managed pool (``core/memory.py``).
"""

from __future__ import annotations

import ctypes as _ct
import io
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.core.fs import get_filesystem
from flink_tpu_torch.native import group_matrix
from flink_tpu_torch.ops.segment_ops import (
    HOST_COMBINE,
    pad_bucket_size,
    pad_i32,
    pad_values,
    sticky_bucket,
)
from flink_tpu_torch.runtime.pending import (
    Fence,
    PendingFire,
    harvest_to_host,
)
from flink_tpu_torch.state.keygroups import assign_key_groups
from flink_tpu_torch.state.paged_spill import (
    PagedSpillMap,
    drop_spilled_sessions,
    read_spilled_rows,
    reload_rows_for,
    restore_into_pages,
    spill_page,
    spilled_rows,
)
from flink_tpu_torch.stateplane.families import flat_fence
from flink_tpu_torch.windowing.aggregates import AggregateFunction


def _coerce_snapshot_leaf(
        arr: np.ndarray, want: np.dtype) -> Optional[np.ndarray]:
    """Cast a snapshot leaf to the aggregate's dtype iff value-preserving;
    None when the cast would lose values (integer targets get an exact
    range and integrality check, float targets a NaN-tolerant
    roundtrip)."""
    if np.issubdtype(want, np.integer):
        info = np.iinfo(want)
        if np.issubdtype(arr.dtype, np.floating):
            if not np.all(np.isfinite(arr)):
                return None
            if not np.all(np.trunc(arr) == arr):
                return None
            # +-2**(bits-1) are exact in float64: `arr <= info.max` would
            # round the bound up and let 2**63 wrap
            lo, hi = float(info.min), float(info.max + 1)
            if not np.all((arr >= lo) & (arr < hi)):
                return None
        else:
            if int(arr.min()) < info.min or int(arr.max()) > info.max:
                return None
        return arr.astype(want)
    with np.errstate(over="ignore", invalid="ignore"):
        cast = arr.astype(want)
        equal_nan = np.issubdtype(arr.dtype, np.inexact)
        back = cast.astype(arr.dtype)
        ok = (np.array_equal(back, arr, equal_nan=True) if equal_nan
              else np.array_equal(back, arr))
        return cast if ok else None


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


def verify_slot_hints(index, key_ids: np.ndarray, namespaces: np.ndarray,
                      hints: np.ndarray) -> np.ndarray:
    """Resolve folded device-slot hints against the index's OWN metadata
    views: a hint is taken iff the index maps exactly that (key, ns) pair
    at that slot now. Returns int32 slots, -1 where the hint is absent or
    stale (callers probe those). A stale fold costs a probe, never a wrong
    row: the views are the table's contents."""
    native = getattr(index, "verify_hints", None)
    if native is not None:
        return native(key_ids, namespaces, hints)
    hints = np.asarray(hints, dtype=np.int32)
    out = np.full(len(hints), -1, dtype=np.int32)
    hv = hints >= 0
    if not hv.any():
        return out
    hs = hints[hv]
    cap = index.capacity
    safe = np.minimum(hs, cap - 1)
    ok = ((hs < cap)
          & index.slot_used[safe]
          & (index.slot_key[safe]
             == np.asarray(key_ids, dtype=np.int64)[hv])
          & (index.slot_ns[safe]
             == np.asarray(namespaces, dtype=np.int64)[hv]))
    out[hv] = np.where(ok, hs, np.int32(-1))
    return out


def resolve_slot_hints(index, key_ids: np.ndarray, namespaces: np.ndarray,
                       hints: np.ndarray, skip=None) -> np.ndarray:
    """Verify the hints, hash-probe the rest: -1 where the index does not
    hold the pair. ``skip``: rows the caller KNOWS are absent (fresh
    session ids) keep -1 without the probe."""
    pre = verify_slot_hints(index, key_ids, namespaces, hints)
    probe = pre < 0
    if skip is not None:
        probe &= ~skip
    if probe.any():
        pre[probe] = index.lookup(
            np.asarray(key_ids)[probe], np.asarray(namespaces)[probe])
    return pre


class _NamespaceRegistry:
    """namespace -> slots registry shared by both index implementations.
    ``track=False``: the owner frees by SLOT and never asks for a
    namespace's slots (the session table: one row per namespace, millions
    of them), so the registry is not kept."""

    def _init_registry(self, track: bool = True) -> None:
        self._ns_slots: Dict[int, List[np.ndarray]] = {}
        self._track_ns = track

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

    def _registry_remove_slots(self, slots: np.ndarray,
                               namespaces: np.ndarray) -> None:
        """Remove individual slots from their namespaces' chunk lists
        (frees by slot, not by whole namespace)."""
        if not self._track_ns:
            return
        uniq, counts = np.unique(namespaces, return_counts=True)
        for ns, freed_here in zip(uniq.tolist(), counts.tolist()):
            chunks = self._ns_slots.get(int(ns))
            if not chunks:
                continue
            merged = np.concatenate(chunks) if len(chunks) > 1 \
                else chunks[0]
            if len(merged) <= freed_here:
                self._ns_slots.pop(int(ns), None)
                continue
            kept = merged[~np.isin(merged, slots)]
            if len(kept):
                self._ns_slots[int(ns)] = [kept]
            else:
                self._ns_slots.pop(int(ns), None)

    def used_slots(self) -> np.ndarray:
        return np.nonzero(self.slot_used)[0]


class HostSlotIndex(_NamespaceRegistry):
    """Pure-Python index: a dict probe per distinct pair of a batch."""

    def __init__(self, capacity: int,
                 on_grow: Optional[Callable[[int, int], None]] = None,
                 growable: bool = True,
                 full_hint: str = "raise state.slot-table.capacity",
                 max_capacity: int = 0,
                 track_namespaces: bool = True) -> None:
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
        self._init_registry(track_namespaces)

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
        for ns, slots in (new_by_ns.items() if self._track_ns else ()):
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

    def free_slots(self, slots: np.ndarray, keys=None, nss=None) -> None:
        """Release individual slots (by (key, ns) entry); ``keys``/``nss``:
        the slots' pairs where the caller holds them."""
        slots = np.asarray(slots, dtype=np.int32)
        if not len(slots):
            return
        if nss is None:
            nss = self.slot_ns[slots]
        self._registry_remove_slots(slots, nss)
        if keys is None:
            keys = self.slot_key[slots]
        for k, v in zip(np.asarray(keys).tolist(), np.asarray(nss).tolist()):
            self._index.pop((int(k), int(v)), None)
        self.slot_used[slots] = False
        self._free.extend(slots.tolist())

    def free_headroom(self) -> int:
        """Slots still allocatable (incl. future growth). Slot 0 reserved."""
        if self.growable:
            limit = self.max_capacity if self.max_capacity else (1 << 60)
        else:
            limit = self.capacity
        return limit - 1 - self.num_used


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
                 max_capacity: int = 0,
                 track_namespaces: bool = True) -> None:
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
        self._init_registry(track_namespaces)

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
        if new_mask.any() and self._track_ns:
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

    def pane_ingest(self, key_ids: np.ndarray, timestamps: np.ndarray,
                    offset: int, width: int, max_uniq: int = 4096):
        """The pane table's fused ingest (``sm_pane_ingest``): one native
        sweep gives each record's slice end (by its timestamp), its key's
        column (namespace 0: a pane column is keyed by key alone) and the
        batch's distinct slice ends in FIRST-SEEN order with the inverse.
        Returns ``(cols, sinv, uniq, max_col)``, or None when the batch has
        more than ``max_uniq`` distinct slice ends (the caller takes the
        NumPy path)."""
        keys = np.ascontiguousarray(key_ids, dtype=np.int64)
        ts = np.ascontiguousarray(timestamps, dtype=np.int64)
        n = len(keys)
        cols = np.empty(n, dtype=np.int32)
        is_new = np.empty(n, dtype=np.uint8)
        sinv = np.empty(n, dtype=np.int32)
        uniq = np.empty(max_uniq, dtype=np.int64)
        out_k = _ct.c_int64()
        out_max_col = _ct.c_int64()
        old_cap = self.capacity
        rc = self._lib.sm_pane_ingest(
            self._h, n, keys.ctypes.data_as(_I64P), ts.ctypes.data_as(_I64P),
            int(offset), int(width), int(max_uniq),
            cols.ctypes.data_as(_I32P), is_new.ctypes.data_as(_U8P),
            sinv.ctypes.data_as(_I32P), uniq.ctypes.data_as(_I64P),
            _ct.byref(out_k), _ct.byref(out_max_col))
        if rc == -2:
            return None
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
            # every pane-table entry lives in namespace 0
            self._ns_slots.setdefault(0, []).append(cols[new_mask])
        return cols, sinv, uniq[:out_k.value], int(out_max_col.value)

    def flat_fuse(self, cols: np.ndarray, sinv: np.ndarray,
                  rowmap: np.ndarray, capacity: int) -> np.ndarray:
        """``flat[i] = rowmap[sinv[i]] * capacity + cols[i]`` as int32, in
        one native pass (``sm_flat_fuse``)."""
        n = len(cols)
        out = np.empty(n, dtype=np.int32)
        rowmap = np.ascontiguousarray(rowmap, dtype=np.int64)
        self._lib.sm_flat_fuse(
            n, cols.ctypes.data_as(_I32P), sinv.ctypes.data_as(_I32P),
            rowmap.ctypes.data_as(_I64P), int(capacity),
            out.ctypes.data_as(_I32P))
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

    def verify_hints(self, key_ids: np.ndarray, namespaces: np.ndarray,
                     hints: np.ndarray) -> np.ndarray:
        """Native :func:`verify_slot_hints` (``sm_verify``): one pass over
        the table's own metadata."""
        keys = np.ascontiguousarray(key_ids, dtype=np.int64)
        nss = np.ascontiguousarray(namespaces, dtype=np.int64)
        hints = np.ascontiguousarray(hints, dtype=np.int32)
        out = np.empty(len(keys), dtype=np.int32)
        self._lib.sm_verify(self._h, len(keys),
                            keys.ctypes.data_as(_I64P),
                            nss.ctypes.data_as(_I64P),
                            hints.ctypes.data_as(_I32P),
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

    def free_slots(self, slots: np.ndarray, keys=None, nss=None) -> None:
        """Release individual slots (by (key, ns) entry) via the native
        erase; ``keys``/``nss``: the slots' pairs where the caller holds
        them."""
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        if not len(slots):
            return
        if nss is None:
            nss = self.slot_ns[slots]
        nss = np.ascontiguousarray(nss, dtype=np.int64)
        self._registry_remove_slots(slots, nss)
        if keys is None:
            keys = self.slot_key[slots]
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(len(slots), dtype=np.int32)
        self._lib.sm_erase(
            self._h, len(slots),
            keys.ctypes.data_as(_I64P), nss.ctypes.data_as(_I64P),
            out.ctypes.data_as(_I32P))

    def free_headroom(self) -> int:
        """Slots still allocatable (incl. future growth). Slot 0 reserved."""
        if self.growable:
            limit = self.max_capacity if self.max_capacity else (1 << 28)
        else:
            limit = self.capacity
        return limit - 1 - self.num_used


def make_slot_index(capacity: int, on_grow=None, growable: bool = True,
                    full_hint: str = "raise state.slot-table.capacity",
                    max_capacity: int = 0, track_namespaces: bool = True):
    """Native index when the C++ library builds, else pure Python."""
    from flink_tpu_torch.native import load_slotmap

    cls = NativeSlotIndex if load_slotmap() is not None else HostSlotIndex
    return cls(capacity, on_grow=on_grow, growable=growable,
               full_hint=full_hint, max_capacity=max_capacity,
               track_namespaces=track_namespaces)


def _not_ported(feature: str, item) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to flink_tpu_torch yet (ROADMAP.md, "
        f"Queue A item {item})")


class SpillTier:
    """State beyond the device: whole namespaces evicted from the device
    table, in host memory and, once ``host_max_bytes`` is exceeded, as
    ``.npz`` files under ``spill_dir`` (any ``core/fs.py`` scheme). The
    unit of movement is a namespace (a window slice), so a reload is one
    batched put."""

    def __init__(self, spill_dir: Optional[str] = None,
                 host_max_bytes: int = 0):
        self.spill_dir = spill_dir
        self.host_max_bytes = host_max_bytes
        self._host: Dict[int, Dict[str, np.ndarray]] = {}
        self._host_bytes = 0
        self._fs: Dict[int, str] = {}  # ns -> file path
        #: spilled namespaces whose rows were dirty when they left the
        #: device (restored to the dirty bitmap on reload)
        self._dirty: set = set()
        #: rows of each spilled namespace (a read that never loads a file)
        self._rows: Dict[int, int] = {}
        self._seq = 0

    def __len__(self) -> int:
        return len(self._host) + len(self._fs)

    def __contains__(self, ns: int) -> bool:
        return ns in self._host or ns in self._fs

    @property
    def namespaces(self) -> List[int]:
        return list(self._host) + list(self._fs)

    @staticmethod
    def _entry_bytes(entry: Dict[str, np.ndarray]) -> int:
        return sum(a.nbytes for a in entry.values())

    def put(self, ns: int, entry: Dict[str, np.ndarray],
            dirty: bool) -> None:
        assert ns not in self, f"namespace {ns} spilled twice"
        self._host[ns] = entry
        self._host_bytes += self._entry_bytes(entry)
        self._rows[ns] = len(entry["key_id"])
        if dirty:
            self._dirty.add(ns)
        self._maybe_overflow_to_fs()

    def rows(self, ns: int) -> int:
        """Row count of a spilled namespace (0 if absent)."""
        return self._rows.get(ns, 0)

    def _maybe_overflow_to_fs(self) -> None:
        if not self.spill_dir or self.host_max_bytes <= 0:
            return
        fs, local = get_filesystem(self.spill_dir)
        fs.mkdirs(local)
        prefix = (self.spill_dir.split("://", 1)[0] + "://"
                  if "://" in self.spill_dir else "")
        while self._host_bytes > self.host_max_bytes and self._host:
            ns, entry = next(iter(self._host.items()))
            buf = io.BytesIO()
            np.savez(buf, **entry)
            self._seq += 1
            path = f"{local.rstrip('/')}/ns-{ns}-{self._seq}.npz"
            with fs.open(path, "wb") as f:
                f.write(buf.getvalue())
            self._fs[ns] = prefix + path
            self._host_bytes -= self._entry_bytes(entry)
            del self._host[ns]

    @staticmethod
    def _load(path: str) -> Dict[str, np.ndarray]:
        fs, local = get_filesystem(path)
        with fs.open(local, "rb") as f, np.load(f) as loaded:
            return {k: loaded[k] for k in loaded.files}

    @staticmethod
    def _delete(path: str) -> None:
        fs, local = get_filesystem(path)
        fs.delete(local)

    def pop(self, ns: int) -> Optional[Dict[str, np.ndarray]]:
        """Remove and return a spilled namespace (reload or free)."""
        entry = self._host.pop(ns, None)
        if entry is not None:
            self._host_bytes -= self._entry_bytes(entry)
        elif ns in self._fs:
            path = self._fs.pop(ns)
            entry = self._load(path)
            self._delete(path)
        was_dirty = ns in self._dirty
        self._dirty.discard(ns)
        self._rows.pop(ns, None)
        if entry is not None:
            entry["__was_dirty__"] = np.asarray(was_dirty)
        return entry

    def peek(self, ns: int) -> Optional[Dict[str, np.ndarray]]:
        """Read a spilled namespace without removing it."""
        entry = self._host.get(ns)
        if entry is not None:
            return entry
        if ns in self._fs:
            return self._load(self._fs[ns])
        return None

    def drop(self, ns: int) -> None:
        """Discard a spilled namespace (its windows fired)."""
        self.pop(ns)

    def discard(self, ns: int) -> None:
        """Delete a spilled entry WITHOUT loading it: a file of the
        filesystem tier is unlinked, never read (the reap of dead
        pages)."""
        entry = self._host.pop(ns, None)
        if entry is not None:
            self._host_bytes -= self._entry_bytes(entry)
        elif ns in self._fs:
            self._delete(self._fs.pop(ns))
        self._dirty.discard(ns)
        self._rows.pop(ns, None)

    def dirty_namespaces(self) -> List[int]:
        return list(self._dirty)

    def clear_dirty(self) -> None:
        self._dirty.clear()


class SlotTable:
    """Single-device keyed windowed state: a host index plus flat device
    accumulators on ``device`` (``None``: ``execution.device``'s default,
    the card, raising without one).

    ``spill_layout`` with a ``max_device_slots`` budget: ``"namespaces"``
    moves whole namespaces (window slices: few and large); ``"pages"``
    moves eviction cohorts of rows (sessions: one row per namespace,
    millions of them) and REQUIRES single-row namespaces, since a cohort
    would otherwise split a namespace across the device/page boundary.
    ``track_namespaces=False`` drops the namespace -> slots registry for an
    owner that frees by slot (``free_rows``, ``free_index_only_slots``)."""

    def __init__(
        self,
        agg: AggregateFunction,
        capacity: int = 1 << 16,
        max_parallelism: int = 128,
        device=None,
        max_device_slots: int = 0,
        spill_dir: Optional[str] = None,
        spill_host_max_bytes: int = 0,
        spill_layout: str = "namespaces",
        track_namespaces: bool = True,
        memory=None,
    ) -> None:
        if spill_layout not in ("namespaces", "pages"):
            raise ValueError(
                f"spill_layout must be 'namespaces' or 'pages', got "
                f"{spill_layout!r}")
        self.agg = agg
        self.max_parallelism = max_parallelism
        self.device = resolve_device(device)
        self.max_device_slots = int(max_device_slots or 0)
        if self.max_device_slots:
            capacity = min(capacity, self.max_device_slots)
        self.spill = SpillTier(spill_dir, spill_host_max_bytes)
        self._ns_touch: Dict[int, int] = {}
        self._touch_clock = 0
        self.spill_layout = spill_layout
        self._paged = spill_layout == "pages" and self.max_device_slots > 0
        #: membership map, tombstones and counters of the paged layout
        self._pmap = PagedSpillMap() if self._paged else None
        self.index = make_slot_index(
            capacity, on_grow=self._grow_device,
            max_capacity=self.max_device_slots,
            track_namespaces=track_namespaces,
            full_hint=("state spills to host beyond "
                       "state.slot-table.max-device-slots"
                       if self.max_device_slots
                       else "raise state.slot-table.capacity"))
        #: (MemoryManager, owner): the device footprint reserves from the
        #: job's pool (core/memory.py); None = unmanaged
        self._memory = memory
        self._reserve_rows(self.index.capacity)
        if self._paged:
            # sized after the index, which clamps capacity up (>= 1024):
            # the touch clock covers every slot
            self._slot_touch = np.zeros(self.index.capacity, dtype=np.int64)
        self.accs: Tuple[torch.Tensor, ...] = agg.init_accumulators(
            self.index.capacity, self.device)
        # sticky buckets: nearby smaller batches reuse a padded size
        # (padded lanes hit identity slot 0; at most 4x padding)
        self._fire_bucket = 0
        self._scatter_bucket = 0
        self._reset_bucket = 0
        self._gather_bucket = 0
        #: slots touched since the last snapshot (the incremental-snapshot
        #: record) and the tombstones of what was freed since: whole
        #: namespaces, and (key, ns) pairs freed one by one
        self._dirty = np.zeros(self.index.capacity, dtype=bool)
        self._freed_ns: List[int] = []
        self._freed_pairs: List[Tuple[np.ndarray, np.ndarray]] = []

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        # from pageable memory the copy has staged `host` when it returns
        return torch.from_numpy(np.ascontiguousarray(host)).to(
            self.device, non_blocking=True)

    # ------------------------------------------------------------------ info

    @property
    def capacity(self) -> int:
        return self.index.capacity

    @property
    def num_used(self) -> int:
        return self.index.num_used

    @property
    def namespaces(self) -> List[int]:
        """All live namespaces — device-resident AND spilled."""
        if self.index._track_ns:
            resident = self.index.namespaces
        else:  # registry-free: from the used slots' metadata
            used = self.index.used_slots()
            resident = np.unique(self.index.slot_ns[used]).tolist()
        if self._paged:
            return resident + self._pmap.live_ns().tolist()
        return resident + self.spill.namespaces

    def spill_counters(self) -> Dict[str, int]:
        """Paged spill traffic counters (zeros when not paged)."""
        if self._paged:
            return self._pmap.counters()
        return PagedSpillMap.zero_counters()

    # ------------------------------------------------------------- main path

    def lookup_or_insert(self, key_ids: np.ndarray, namespaces: np.ndarray,
                         _pairs=None, hints=None) -> np.ndarray:
        """(key, ns) -> slot, allocating missing slots; with a budget,
        spilled state reloads first and cold state makes room. ``hints``
        (paged layout): folded device slots from the session-metadata
        plane, aligned with ``key_ids``, which must then be unique pairs."""
        if self._paged:
            return self._lookup_or_insert_paged(key_ids, namespaces,
                                                _pairs, hints)
        if self.max_device_slots:
            # ``_pairs``: upsert()'s unique (key, ns) pairs, not recomputed
            if _pairs is None:
                uk, un, _ = unique_pairs(
                    np.asarray(key_ids, dtype=np.int64),
                    np.asarray(namespaces, dtype=np.int64))
            else:
                uk, un = _pairs
            touched = np.unique(un)
            self.ensure_resident(touched.tolist())
            self._touch(touched.tolist())
            # lookup_or_insert allocates as it goes, so running out MID
            # batch would leave the index and the registry inconsistent:
            # make room up front for the pairs that are really new (a
            # read-only probe, only when len(uk) might not fit)
            if self.index.free_headroom() < len(uk):
                needed = int((self.index.lookup(uk, un) < 0).sum())
                if needed:
                    self._make_headroom(needed,
                                        protect=set(touched.tolist()))
        return self.index.lookup_or_insert(key_ids, namespaces)

    def _make_headroom(self, needed: int, protect: set) -> None:
        while self.index.free_headroom() < needed:
            self._evict_cold(protect=protect)

    # --------------------------------------------------- paged spill layout

    def _lookup_or_insert_paged(self, key_ids, namespaces,
                                _pairs=None, hints=None) -> np.ndarray:
        """The slot-clock lookup: this batch's resident rows take a fresh
        clock (protecting them from the eviction the batch itself
        triggers), missing pairs reload from their pages, then the index
        inserts. Verified ``hints`` skip the hash probe; only the misses
        insert, which leaves the index as the full lookup_or_insert
        would (hits never allocate)."""
        key_ids = np.asarray(key_ids, dtype=np.int64)
        namespaces = np.asarray(namespaces, dtype=np.int64)
        self._touch_clock += 1
        clock = self._touch_clock
        if hints is not None:
            uk, un = key_ids, namespaces
            pre = resolve_slot_hints(self.index, uk, un, hints)
        else:
            if _pairs is None:
                uk, un, _ = unique_pairs(key_ids, namespaces)
            else:
                uk, un = _pairs
            pre = self.index.lookup(uk, un)
        hit = pre >= 0
        self._slot_touch[pre[hit]] = clock
        missing = ~hit
        if missing.any() and len(self._pmap.sp_ns):
            self._reload_pages_for(un[missing], clock)
            # re-probe: reloaded rows are resident now (fresh sessions
            # stay missing)
            pre = self.index.lookup(uk, un)
            missing = pre < 0
        needed = int(missing.sum())
        if needed and self.index.free_headroom() < needed:
            self._make_headroom_paged(needed)
        if hints is not None:
            slots = pre.astype(np.int32, copy=True)
            if missing.any():
                slots[missing] = self.index.lookup_or_insert(
                    uk[missing], un[missing])
        else:
            slots = self.index.lookup_or_insert(key_ids, namespaces)
        self._slot_touch[slots] = clock
        return slots

    def _reload_pages_for(self, nss: np.ndarray, clock: int) -> None:
        """Reload the requested rows from their pages (one put); the
        pages' other rows stay as lazy tombstones."""
        rl = reload_rows_for(self.spill, self._pmap, nss,
                             [l.dtype for l in self.agg.leaves])
        if rl is None:
            return
        keys, rns, dirty, vals = rl
        n = len(keys)
        if self.index.free_headroom() < n:
            self._make_headroom_paged(n)
        slots = self.index.lookup_or_insert(keys, rns)
        self._put(slots, vals)
        # reloaded rows keep their dirtiness and take the current clock
        self._dirty[slots] = dirty
        self._slot_touch[slots] = clock

    def _make_headroom_paged(self, needed: int) -> None:
        while self.index.free_headroom() < needed:
            self._evict_cold_paged()

    def _drop_spilled_sessions(self, nss: np.ndarray) -> None:
        """Tombstone freed sessions that were spilled; dead pages are
        reaped, mostly dead ones compacted."""
        if self._paged:
            drop_spilled_sessions(self.spill, self._pmap,
                                  np.asarray(nss, dtype=np.int64))

    def _evict_cold_paged(self) -> None:
        """Evict the coldest slots (touched before the current clock) as
        ONE page: one gather, one reset and one spill entry, however many
        sessions the cohort spans."""
        used = self.index.used_slots()
        evictable = used[self._slot_touch[used] < self._touch_clock]
        if len(evictable) == 0:
            raise SlotTableFullError(
                "device slot budget exhausted and every resident row was "
                "touched by the current batch — raise "
                "state.slot-table.max-device-slots or reduce batch size")
        target = min(max(self.index.capacity // 8, 1024), len(evictable))
        if target < len(evictable):
            sel = np.argpartition(self._slot_touch[evictable],
                                  target - 1)[:target]
            chosen = evictable[sel]
        else:
            chosen = evictable
        chosen = np.asarray(chosen, dtype=np.int32)
        n = len(chosen)
        size = sticky_bucket(n, self._gather_bucket)
        self._gather_bucket = size
        gathered = self.agg._gather_jit(
            self.accs, self._to_device(pad_i32(chosen, size, fill=0)))
        entry = {
            "key_id": np.asarray(self.index.slot_key[chosen]),
            "ns": np.asarray(self.index.slot_ns[chosen]),
            "dirty": self._dirty[chosen].copy(),
            **{f"leaf_{i}": g[:n].cpu().numpy()
               for i, g in enumerate(gathered)},
        }
        spill_page(self.spill, self._pmap, entry)
        self.index.free_slots(chosen)
        self._reset(chosen)

    def upsert(self, key_ids: np.ndarray, namespaces: np.ndarray,
               values: Tuple[np.ndarray, ...],
               valued: bool = False) -> None:
        """Spill-safe accumulate: when one batch's (key, ns) pairs exceed
        half the device budget, it is folded in namespace groups so that
        only one group must be resident at a time (one namespace whose
        keys alone exceed the budget fails loudly). ``valued``: locally
        pre-aggregated input, one value per leaf per row."""
        emit = self.scatter_valued if valued else self.scatter
        namespaces = np.asarray(namespaces, dtype=np.int64)
        if self.max_device_slots:
            pair_k, pair_ns, _ = unique_pairs(
                np.asarray(key_ids, dtype=np.int64), namespaces)
            uniq_ns, counts = np.unique(pair_ns, return_counts=True)
            budget = max(self.max_device_slots // 2, 1024)
            if len(uniq_ns) > 1 and len(pair_ns) > budget:
                groups: List[List[int]] = []
                cur: List[int] = []
                cur_n = 0
                for ns, c in zip(uniq_ns.tolist(), counts.tolist()):
                    if cur and cur_n + c > budget:
                        groups.append(cur)
                        cur, cur_n = [], 0
                    cur.append(ns)
                    cur_n += c
                groups.append(cur)
                for g in groups:
                    mask = np.isin(namespaces, g)
                    pmask = np.isin(pair_ns, g)
                    slots = self.lookup_or_insert(
                        key_ids[mask], namespaces[mask],
                        _pairs=(pair_k[pmask], pair_ns[pmask]))
                    emit(slots, tuple(np.asarray(v)[mask] for v in values))
                return
            slots = self.lookup_or_insert(key_ids, namespaces,
                                          _pairs=(pair_k, pair_ns))
            emit(slots, values)
            return
        emit(self.lookup_or_insert(key_ids, namespaces), values)

    def upsert_valued(self, key_ids: np.ndarray, namespaces: np.ndarray,
                      values: Tuple[np.ndarray, ...]) -> None:
        """upsert() of locally pre-aggregated rows (the valued fold)."""
        self.upsert(key_ids, namespaces, values, valued=True)

    # ------------------------------------------------------------ spill tier

    def _touch(self, namespaces: List[int]) -> None:
        self._touch_clock += 1
        clock = self._touch_clock
        for ns in namespaces:
            self._ns_touch[int(ns)] = clock

    def ensure_resident(self, namespaces: List[int]) -> None:
        """Reload the spilled namespaces among ``namespaces`` — all of them
        in one insert and one put."""
        if not self.max_device_slots or len(self.spill) == 0:
            return
        todo = [int(ns) for ns in namespaces if int(ns) in self.spill]
        if not todo:
            return
        protect = set(int(n) for n in namespaces)
        key_chunks: List[np.ndarray] = []
        ns_chunks: List[np.ndarray] = []
        dirty_chunks: List[np.ndarray] = []
        leaf_chunks: List[List[np.ndarray]] = [[] for _ in self.agg.leaves]
        for ns in todo:
            entry = self.spill.pop(ns)
            m = len(entry["key_id"])
            if m == 0:
                continue
            key_chunks.append(np.asarray(entry["key_id"], dtype=np.int64))
            ns_chunks.append(np.full(m, ns, dtype=np.int64))
            dirty_chunks.append(np.full(
                m, bool(entry.get("__was_dirty__", False)), dtype=bool))
            for i, l in enumerate(self.agg.leaves):
                leaf_chunks[i].append(
                    np.asarray(entry[f"leaf_{i}"], dtype=l.dtype))
        if not key_chunks:
            return
        key_ids = np.concatenate(key_chunks)
        nss = np.concatenate(ns_chunks)
        was_dirty = np.concatenate(dirty_chunks)
        self._make_headroom(len(key_ids), protect=protect)
        slots = self.index.lookup_or_insert(key_ids, nss)
        self._put(slots, [np.concatenate(c) for c in leaf_chunks])
        # reloaded rows keep their dirtiness: rows dirty at spill time
        # have not been in a snapshot since
        self._dirty[slots] = was_dirty
        self._touch(todo)

    def _put(self, slots: np.ndarray, values) -> None:
        """Place reloaded rows back on the device: one ``flat_put``."""
        size = sticky_bucket(len(slots), self._scatter_bucket)
        self._scatter_bucket = size
        vals = tuple(
            self._to_device(pad_values(np.asarray(v, dtype=l.dtype), size,
                                       l.identity))
            for v, l in zip(values, self.agg.leaves))
        self.accs = self.agg._put_jit(
            self.accs, self._to_device(pad_i32(slots, size, fill=0)), vals)

    def _evict_cold(self, protect: set) -> None:
        """Evict the least recently touched namespaces to the spill tier
        until an eighth of the device table (at least 1024 slots) is free —
        one gather and one reset for the whole cohort."""
        target_free = max(self.index.capacity // 8, 1024)
        candidates = sorted(
            (ns for ns in self.index.namespaces if int(ns) not in protect),
            key=lambda ns: self._ns_touch.get(int(ns), 0))
        if not candidates:
            raise SlotTableFullError(
                "device slot budget exhausted and every namespace in the "
                "current batch is protected — raise "
                "state.slot-table.max-device-slots or reduce batch size")
        chosen: List[Tuple[int, np.ndarray]] = []
        freed = 0
        for ns in candidates:
            if freed >= target_free:
                break
            slots = self.index.slots_for_namespace(int(ns))
            chosen.append((int(ns), slots))
            freed += len(slots)
        empty = [ns for ns, s in chosen if len(s) == 0]
        if empty:
            self.index.free_namespaces(empty)
        chosen = [(ns, s) for ns, s in chosen if len(s) > 0]
        if not chosen:
            return
        all_slots = np.concatenate([s for _, s in chosen])
        n = len(all_slots)
        size = sticky_bucket(n, self._gather_bucket)
        self._gather_bucket = size
        gathered = self.agg._gather_jit(
            self.accs, self._to_device(pad_i32(all_slots, size, fill=0)))
        leaves_host = [g[:n].cpu().numpy() for g in gathered]
        off = 0
        for ns, slots in chosen:
            m = len(slots)
            entry = {
                "key_id": np.asarray(self.index.slot_key[slots]),
                **{f"leaf_{i}": leaves_host[i][off:off + m]
                   for i in range(len(leaves_host))},
            }
            self.spill.put(ns, entry, dirty=bool(self._dirty[slots].any()))
            off += m
            self._ns_touch.pop(ns, None)
        # the device slots go (index entries, values back to identity);
        # not a logical free: the rows live on in the spill tier
        self.index.free_namespaces([ns for ns, _ in chosen])
        self._dirty[all_slots] = False
        rsize = sticky_bucket(n, self._reset_bucket)
        self._reset_bucket = rsize
        self.accs = self.agg._reset_jit(
            self.accs, self._to_device(pad_i32(all_slots, rsize, fill=0)))

    def _row_bytes(self) -> int:
        return sum(np.dtype(leaf.dtype).itemsize
                   for leaf in self.agg.leaves)

    def _reserve_rows(self, rows: int) -> None:
        if self._memory is not None:
            manager, owner = self._memory
            manager.reserve(owner, rows * self._row_bytes())

    def release_memory(self) -> None:
        """Return this table's reservation to the pool (dispose path)."""
        if self._memory is not None:
            manager, owner = self._memory
            manager.release(owner, self.index.capacity * self._row_bytes())

    def _grow_device(self, old: int, new: int) -> None:
        self._reserve_rows(new - old)
        self.accs = tuple(
            torch.cat([a, torch.full((new - old,),
                                     np.asarray(leaf.identity).item(),
                                     dtype=a.dtype, device=a.device)])
            for a, leaf in zip(self.accs, self.agg.leaves))
        self._dirty = np.concatenate(
            [self._dirty, np.zeros(new - old, dtype=bool)])
        if self._paged:
            self._slot_touch = np.concatenate(
                [self._slot_touch, np.zeros(new - old, dtype=np.int64)])

    # ----------------------------------------------------------------- ingest

    def scatter(self, slots: np.ndarray,
                values: Tuple[np.ndarray, ...]) -> None:
        """Fold a batch: one value array per input leaf."""
        n = len(slots)
        if n == 0:
            return
        self._dirty[slots] = True
        size = sticky_bucket(n, self._scatter_bucket)
        self._scatter_bucket = size
        padded = self.agg.pad_input_values(values, size)
        self.accs = self.agg._scatter_jit(
            self.accs, self._to_device(pad_i32(slots, size, fill=0)),
            tuple(self._to_device(v) for v in padded))

    def scatter_valued(self, slots: np.ndarray,
                       values: Tuple[np.ndarray, ...]) -> None:
        """Merge pre-aggregated partials: every leaf valued, each folded
        by its own reduce; pad lanes carry the identity into slot 0."""
        self._scatter_every_leaf(slots, values, self.agg._scatter_valued_jit)

    def scatter_signed(self, slots: np.ndarray,
                       values: Tuple[np.ndarray, ...]) -> None:
        """Changelog fold: values carry their sign (+accumulate /
        -retract), every leaf valued (``AggregateFunction.map_input_signed``);
        pad lanes add the sum identity 0 into slot 0."""
        self._scatter_every_leaf(slots, values, self.agg._scatter_signed_jit)

    def _scatter_every_leaf(self, slots, values, program) -> None:
        n = len(slots)
        if n == 0:
            return
        self._dirty[slots] = True
        size = sticky_bucket(n, self._scatter_bucket)
        self._scatter_bucket = size
        padded = tuple(
            self._to_device(pad_values(np.asarray(v, dtype=l.dtype), size,
                                       l.identity))
            for v, l in zip(values, self.agg.leaves))
        self.accs = program(
            self.accs, self._to_device(pad_i32(slots, size, fill=0)), padded)

    def make_fence(self) -> Fence:
        """A completion marker enqueued after everything dispatched so far
        (the task loop's bound on how far it runs ahead of the device)."""
        return flat_fence(self.agg.leaves[0].dtype.str)(self.accs[0])

    # ------------------------------------------------------------- fire path

    def slots_for_namespace(self, ns: int) -> np.ndarray:
        return self.index.slots_for_namespace(ns)

    def keys_of_slots(self, slots: np.ndarray) -> np.ndarray:
        return self.index.slot_key[slots]

    def _pad_fire_matrix(self, slot_matrix: np.ndarray) -> torch.Tensor:
        """Sticky-bucket zero padding of a fire's slot matrix, on the
        device."""
        w, k = slot_matrix.shape
        wp = sticky_bucket(w, self._fire_bucket, minimum=64)
        self._fire_bucket = wp
        padded = np.zeros((wp, k), dtype=np.int32)
        padded[:w] = slot_matrix
        return self._to_device(padded)

    def fire(self, slot_matrix: np.ndarray) -> Dict[str, np.ndarray]:
        """Merge and finish a ``[w, k]`` matrix of slice slots (missing
        slices at slot 0): host result columns."""
        w, _ = slot_matrix.shape
        if w == 0:
            return {name: np.empty(0) for name in self.agg.output_names}
        out = self.agg._fire_jit(self.accs,
                                 self._pad_fire_matrix(slot_matrix))
        return {name: col[:w].cpu().numpy() for name, col in out.items()}

    def fire_projected(self, slot_matrix: np.ndarray, keys: np.ndarray,
                       projector) -> Tuple[np.ndarray,
                                           Dict[str, np.ndarray]]:
        """Fire with the projector on the device: merge, finish and
        project in one program; only its rows reach the host."""
        w, _ = slot_matrix.shape
        if w == 0:
            return np.empty(0, dtype=np.int64), {
                name: np.empty(0) for name in self.agg.output_names}
        pidx, pcols, pvalid = self.agg._fire_project_jit(projector)(
            self.accs, self._pad_fire_matrix(slot_matrix), w)
        sel = pvalid.cpu().numpy()
        return (keys[pidx.cpu().numpy()[sel]],
                {name: c.cpu().numpy()[sel] for name, c in pcols.items()})

    def fire_async(self, slot_matrix: np.ndarray, keys: np.ndarray):
        """Dispatch a fire; the PendingFire's harvest yields (keys, result
        columns)."""
        w, _ = slot_matrix.shape
        if w == 0:
            return None
        out = self.agg._fire_jit(self.accs,
                                 self._pad_fire_matrix(slot_matrix))
        names = list(out.keys())

        def build(host: List[np.ndarray]):
            return keys, {name: col[:w] for name, col in zip(names, host)}

        return PendingFire([out[n] for n in names], build)

    def fire_projected_async(self, slot_matrix: np.ndarray,
                             keys: np.ndarray, projector):
        """fire_projected() with the host read deferred to the harvest."""
        w, _ = slot_matrix.shape
        if w == 0:
            return None
        pidx, pcols, pvalid = self.agg._fire_project_jit(projector)(
            self.accs, self._pad_fire_matrix(slot_matrix), w)
        names = list(pcols.keys())

        def build(host: List[np.ndarray]):
            sel = host[1]
            return (keys[host[0][sel]],
                    {name: col[sel] for name, col in zip(names, host[2:])})

        return PendingFire([pidx, pvalid] + [pcols[n] for n in names], build)

    def build_slice_matrix(self, slice_ends: List[int]
                           ) -> Tuple[Optional[np.ndarray],
                                      Optional[np.ndarray]]:
        """(keys, ``[num_keys, k]`` slot matrix) for the resident slices of
        a window, keys in first-seen order (missing cells at slot 0)."""
        per_slice = [(i, self.index.slots_for_namespace(se))
                     for i, se in enumerate(slice_ends)]
        per_slice = [(i, s) for i, s in per_slice if len(s) > 0]
        if not per_slice:
            return None, None
        all_slots = np.concatenate([s for _, s in per_slice])
        all_sidx = np.concatenate(
            [np.full(len(s), i, dtype=np.int32) for i, s in per_slice])
        return group_matrix(self.index.slot_key[all_slots],
                            all_slots.astype(np.int32), all_sidx,
                            len(slice_ends))

    def fire_hybrid(self, slice_ends: List[int]
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """A window fire over spilled slices: resident slices merge on the
        device, spilled ones on the host, and finish runs on the host over
        the union (keys ascending). The device budget does not depend on
        the window's slice count."""
        resident = [se for se in slice_ends if int(se) not in self.spill]
        spilled = [se for se in slice_ends if int(se) in self.spill]
        key_chunks: List[np.ndarray] = []
        leaf_chunks: List[List[np.ndarray]] = [[] for _ in self.agg.leaves]
        keys, matrix = self.build_slice_matrix(resident)
        if keys is not None:
            wp = sticky_bucket(len(keys), self._fire_bucket, minimum=64)
            self._fire_bucket = wp
            padded = np.zeros((wp, matrix.shape[1]), dtype=np.int32)
            padded[:len(keys)] = matrix
            merged = self.agg._merge_jit(self.accs, self._to_device(padded))
            key_chunks.append(keys)
            for i, m in enumerate(merged):
                leaf_chunks[i].append(m[:len(keys)].cpu().numpy())
        for se in spilled:
            entry = self.spill.peek(int(se))
            if entry is None or len(entry["key_id"]) == 0:
                continue
            key_chunks.append(np.asarray(entry["key_id"], dtype=np.int64))
            for i, l in enumerate(self.agg.leaves):
                leaf_chunks[i].append(
                    np.asarray(entry[f"leaf_{i}"], dtype=l.dtype))
        if not key_chunks:
            return np.empty(0, dtype=np.int64), {}
        uniq, inv = np.unique(np.concatenate(key_chunks), return_inverse=True)
        out_leaves = []
        for i, l in enumerate(self.agg.leaves):
            acc = np.full(len(uniq), l.identity, dtype=l.dtype)
            with np.errstate(invalid="ignore", over="ignore"):
                HOST_COMBINE[l.reduce].at(acc, inv,
                                          np.concatenate(leaf_chunks[i]))
            out_leaves.append(torch.from_numpy(acc))
        finished = self.agg.finish(tuple(out_leaves))
        return uniq, {name: col.numpy() for name, col in finished.items()}

    # ------------------------------------------------------------------ frees

    def mark_dirty(self, slots: np.ndarray) -> None:
        """For programs that change ``accs`` outside the table (session
        merges): the rows changed since the last snapshot."""
        self._dirty[slots] = True

    def free_index_only_slots(self, slots: np.ndarray, namespaces) -> None:
        """Release the index entries of rows whose device values the
        caller's program already reset (the sources of a session merge),
        recording their namespaces as tombstones for incremental
        snapshots."""
        slots = np.asarray(slots, dtype=np.int32)
        self._freed_ns.extend(np.asarray(namespaces,
                                         dtype=np.int64).tolist())
        self.index.free_slots(slots)
        self._dirty[slots] = False

    def free_rows(self, slots: np.ndarray, namespaces) -> None:
        """Free fired sessions by slot (the caller resolved the rows this
        batch, so no registry walk): namespace tombstones, index entries,
        spilled copies, and the device values reset — queued behind the
        fire on the same stream."""
        slots = np.asarray(slots, dtype=np.int32)
        if not len(slots):
            return
        nss = np.asarray(namespaces, dtype=np.int64)
        self._freed_ns.extend(nss.tolist())
        self._drop_spilled_sessions(nss)
        self.index.free_slots(slots)
        self._reset(slots)

    def free_slots(self, slots: np.ndarray) -> None:
        """Release individual (key, ns) entries, recording entry-granular
        tombstones so an incremental chain does not resurrect them."""
        slots = np.asarray(slots, dtype=np.int32)
        if not len(slots):
            return
        self._freed_pairs.append((self.index.slot_key[slots].copy(),
                                  self.index.slot_ns[slots].copy()))
        self.index.free_slots(slots)
        self._reset(slots)

    def free_namespaces(self, namespaces: List[int]) -> None:
        """Release all slots of the given namespaces (windows fired)."""
        slots = self.index.free_namespaces(namespaces)
        self._freed_ns.extend(int(n) for n in namespaces)
        if self._paged:
            self._drop_spilled_sessions(namespaces)
        else:
            for ns in namespaces:
                if int(ns) in self.spill:
                    self.spill.drop(int(ns))
                self._ns_touch.pop(int(ns), None)
        if slots is not None:
            self._reset(slots)

    def _reset(self, slots: np.ndarray) -> None:
        self._dirty[slots] = False
        size = sticky_bucket(len(slots), self._reset_bucket)
        self._reset_bucket = size
        self.accs = self.agg._reset_jit(
            self.accs, self._to_device(pad_i32(slots, size, fill=0)))

    # ------------------------------------------------------ snapshot/restore

    def snapshot(self, reset_dirty: bool = True) -> Dict[str, np.ndarray]:
        """State as host arrays, filtered to used slots, plus every spilled
        row. Logical (key, ns, key_group, leaf values): slot numbers are not
        part of the format, so a restore re-shards by key group. With
        ``reset_dirty`` the snapshot establishes a new incremental base;
        savepoints pass False so the next delta keeps its contents."""
        used = self.index.used_slots()
        # ONE synchronous copy, queued behind every dispatched program
        accs_host = harvest_to_host(self.accs)
        # spilled namespaces are part of the logical state (chunks first,
        # ONE concatenate)
        keys, nss, leaves = spilled_rows(self.spill, self._pmap,
                                         self.agg.leaves)
        out = {"key_id": np.concatenate([self.index.slot_key[used], *keys]),
               "namespace": np.concatenate([self.index.slot_ns[used], *nss])}
        for i, a in enumerate(accs_host):
            out[f"leaf_{i}"] = np.concatenate([a[used], *leaves[i]])
        out["key_group"] = assign_key_groups(out["key_id"],
                                             self.max_parallelism)
        if reset_dirty:
            self._clear_tracking()
        return out

    def _clear_tracking(self) -> None:
        self._dirty[:] = False
        self._freed_ns.clear()
        self._freed_pairs.clear()
        self.spill.clear_dirty()

    def snapshot_delta(self) -> Dict[str, np.ndarray]:
        """Incremental snapshot: only the rows dirtied since the last
        snapshot (one gather off the device) plus the tombstones of what
        was freed since. A restore applies it on top of the last full
        snapshot."""
        dirty_used = np.nonzero(self._dirty & self.index.slot_used)[0] \
            .astype(np.int32)
        freed = np.asarray(sorted(set(self._freed_ns)), dtype=np.int64)
        n = len(dirty_used)
        if n:
            size = sticky_bucket(n, self._gather_bucket)
            self._gather_bucket = size
            gathered = self.agg._gather_jit(
                self.accs,
                self._to_device(pad_i32(dirty_used, size, fill=0)))
            leaves = [g[:n] for g in harvest_to_host(gathered)]
        else:
            leaves = [np.empty(0, dtype=l.dtype) for l in self.agg.leaves]
        # spilled-but-dirty namespaces travel too (paged layout: only the
        # dirty ROWS of a dirty page — pages are immutable once spilled,
        # so the per-row dirty column captured at eviction stays right)
        keys, nss, sleaves = spilled_rows(self.spill, self._pmap,
                                          self.agg.leaves, dirty_only=True)
        key_ids = np.concatenate([self.index.slot_key[dirty_used], *keys])
        namespaces = np.concatenate([self.index.slot_ns[dirty_used], *nss])
        leaves = [np.concatenate([leaves[i], *sleaves[i]])
                  for i in range(len(leaves))]
        if self._freed_pairs:
            tomb_k = np.concatenate([p[0] for p in self._freed_pairs])
            tomb_n = np.concatenate([p[1] for p in self._freed_pairs])
        else:
            tomb_k = np.empty(0, dtype=np.int64)
            tomb_n = np.empty(0, dtype=np.int64)
        out = {
            "__delta__": np.asarray(True),
            "key_id": key_ids,
            "namespace": namespaces,
            "key_group": assign_key_groups(key_ids, self.max_parallelism),
            "freed_namespaces": freed,
            "tombstone_key_id": tomb_k,
            "tombstone_namespace": tomb_n,
            **{f"leaf_{i}": leaves[i] for i in range(len(leaves))},
        }
        self._clear_tracking()
        return out

    def restore(self, snap: Dict[str, np.ndarray],
                key_group_filter=None) -> None:
        """Load a logical snapshot, optionally keeping only the key groups
        in ``key_group_filter``. With a device budget the rows land in the
        spill tier (pages, or one entry per namespace) and reload lazily;
        otherwise they are put on the device in one ``flat_put`` — never
        at slot 0."""
        key_ids = np.asarray(snap["key_id"], dtype=np.int64)
        namespaces = np.asarray(snap["namespace"], dtype=np.int64)
        groups = np.asarray(snap["key_group"], dtype=np.int32)
        # arrays read from an .npz are read-only: copies, in the
        # aggregate's dtypes (a value-preserving cast counts as
        # compatible; anything lossy fails precisely)
        leaves = [np.array(snap[f"leaf_{i}"])
                  for i in range(len(self.agg.leaves))]
        for i, (arr, leaf) in enumerate(zip(leaves, self.agg.leaves)):
            want = np.dtype(leaf.dtype)
            if len(arr) and arr.dtype != want:
                cast = _coerce_snapshot_leaf(arr, want)
                if cast is None:
                    raise RuntimeError(
                        f"state schema incompatible: snapshot leaf_{i} has "
                        f"dtype {arr.dtype}, the aggregate expects {want} "
                        "and the values do not survive the cast — migrate "
                        "the snapshot (checkpoint.storage."
                        "register_migration) or restore with the original "
                        "aggregate types")
                leaves[i] = cast
        if key_group_filter is not None:
            mask = np.isin(groups, np.asarray(sorted(key_group_filter)))
            key_ids, namespaces = key_ids[mask], namespaces[mask]
            leaves = [l[mask] for l in leaves]
        if self.max_device_slots and self._paged and len(key_ids):
            # rows land in page-sized entries (ns column per row) and
            # reload lazily by page
            restore_into_pages(
                self.spill, self._pmap, key_ids, namespaces, leaves,
                page_rows=max(self.index.capacity // 8, 1024))
        elif self.max_device_slots and len(key_ids):
            # namespace layout: one spill entry per namespace, reloaded on
            # first access
            order = np.argsort(namespaces, kind="stable")
            s_ns = namespaces[order]
            s_keys = key_ids[order]
            s_leaves = [l[order] for l in leaves]
            bounds = np.nonzero(np.diff(s_ns))[0] + 1
            starts = np.concatenate(([0], bounds))
            ends = np.concatenate((bounds, [len(s_ns)]))
            for a, b in zip(starts.tolist(), ends.tolist()):
                ns = int(s_ns[a])
                entry = {"key_id": s_keys[a:b],
                         **{f"leaf_{i}": s_leaves[i][a:b]
                            for i in range(len(s_leaves))}}
                if ns in self.spill:
                    self.spill.drop(ns)
                self.spill.put(ns, entry, dirty=False)
        elif len(key_ids):
            # the index allocates from slot 1: slot 0 is never written
            slots = self.lookup_or_insert(key_ids, namespaces)
            self._put(slots, leaves)
        # restored state IS the new incremental base
        self._clear_tracking()

    # ------------------------------------------------------------ point query

    def query(self, key_id: int, namespace: Optional[int] = None
              ) -> Dict[int, Dict[str, float]]:
        """Point lookup for queryable state (reference
        ``flink_tpu/state/slot_table.py:1617``): finished result columns
        for the key, per namespace (every live one, or ``namespace``), as
        Python scalars, through ``query_batch_pairs``. Read-only — no key
        is inserted, no residency changes, and no sticky bucket moves
        (the fire's bucket belongs to the hot path)."""
        nss, found, leaves = self._key_pairs(key_id, namespace)
        if not found.any():
            return {}
        finished = self.agg.finish(tuple(torch.from_numpy(l[found])
                                         for l in leaves))
        cols = [(name, col.tolist()) for name, col in finished.items()]
        return {int(ns): {name: vals[j] for name, vals in cols}
                for j, ns in enumerate(nss[found].tolist())}

    def _key_pairs(self, key_id: int, namespace: Optional[int] = None):
        """(namespaces, found, leaves) of one key over every live
        namespace (or ``namespace``): ``query_batch_pairs`` of the key."""
        nss = np.asarray([int(namespace)] if namespace is not None
                         else [int(n) for n in self.namespaces],
                         dtype=np.int64)
        found, leaves = self.query_batch_pairs(
            np.full(len(nss), int(key_id), dtype=np.int64), nss)
        return nss, found, leaves

    def _gather_rows(self, slots: np.ndarray) -> List[np.ndarray]:
        """The query's device read: one ``flat_gather`` of ``slots``
        (padded to ``pad_bucket_size(n, minimum=64)`` with slot 0, not the
        sticky gather bucket) and ONE device-to-host copy of every leaf."""
        n = len(slots)
        size = pad_bucket_size(n, minimum=64)
        gathered = self.agg._gather_jit(
            self.accs,
            self._to_device(pad_i32(slots.astype(np.int32), size, fill=0)))
        return [g[:n] for g in harvest_to_host(gathered)]

    def query_batch_pairs(
            self, key_ids: np.ndarray, namespaces: np.ndarray
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Raw accumulator leaves for N ``(key, namespace)`` pairs, the
        serving plane's primitive (reference ``:1692``): resident pairs
        through ONE gather and ONE device-to-host copy for the whole
        batch, spilled pairs from the host tiers
        (``paged_spill.read_spilled_rows``, both layouts). Returns
        ``(found, leaves)``: the per-pair hit mask and ``[N]`` leaf arrays
        (identity where not found). Read-only."""
        key_ids = np.asarray(key_ids, dtype=np.int64)
        namespaces = np.asarray(namespaces, dtype=np.int64)
        n = len(key_ids)
        leaves_out = [np.full(n, l.identity, dtype=l.dtype)
                      for l in self.agg.leaves]
        found = np.zeros(n, dtype=bool)
        if n == 0:
            return found, leaves_out
        slots = self.index.lookup(key_ids, namespaces)
        hit = slots >= 0
        if hit.any():
            for i, g in enumerate(self._gather_rows(slots[hit])):
                leaves_out[i][hit] = g
            found |= hit
        miss = np.nonzero(~hit)[0]
        if len(miss) and (self._paged or len(self.spill)):
            def _take_row(j, entry, src):
                for i, l in enumerate(self.agg.leaves):
                    leaves_out[i][j] = np.asarray(
                        entry[f"leaf_{i}"], dtype=l.dtype)[src]
                found[j] = True

            read_spilled_rows(
                self.spill, self._pmap if self._paged else None,
                self._paged,
                [(j, int(key_ids[j]), int(namespaces[j]))
                 for j in miss.tolist()],
                _take_row)
        return found, leaves_out

    def query_windows(self, key_id: int, assigner
                      ) -> Dict[int, Dict[str, float]]:
        """{window_end -> finished result columns} for the key, each
        window the left fold of its live slices in the assigner's
        ``slice_ends_for_window`` order (reference ``:1748``). Read-only."""
        from flink_tpu_torch.windowing.windower import compose_windows_pairs

        nss, found, leaves = self._key_pairs(key_id)
        return compose_windows_pairs(
            assigner, self.agg, np.zeros(int(found.sum()), dtype=np.int64),
            nss[found], [l[found] for l in leaves], 1)[0]
