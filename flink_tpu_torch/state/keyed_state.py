"""Keyed state for process functions (port of
``flink_tpu/state/keyed_state.py``).

The states are vectorized handles: every read and write takes an int64
array of key ids. Fixed-dtype values (Value, Reducing) live in dense NumPy
arrays indexed by slot of one key -> slot index per operator
(``make_slot_index``, the index the ``SlotTable`` uses); variable-size
values (List, Map) live in host dicts. Snapshots carry the keys and their
slots, and a restore re-inserts the keys and remaps the dense rows, so it
re-shards freely. ``DeviceValueStateDescriptor``
(``state/async_state.py``) puts a value state's array on the store's
device instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.annotations import public
from flink_tpu_torch.state.slot_table import make_slot_index
from flink_tpu_torch.state.ttl import (
    ON_READ_AND_WRITE,
    RETURN_EXPIRED_IF_NOT_CLEANED_UP,
    StateTtlConfig,
    TtlStamps,
    default_clock,
)

_NS = 0  # process-function state has no window namespace


@public
@dataclasses.dataclass(frozen=True)
class ValueStateDescriptor:
    name: str
    dtype: Any = np.float64
    default: Any = 0
    #: reference: StateDescriptor.enableTimeToLive(StateTtlConfig)
    ttl: Optional[StateTtlConfig] = None


@public
@dataclasses.dataclass(frozen=True)
class ReducingStateDescriptor:
    """``reduce`` must be a binary NumPy ufunc-like (np.add, np.maximum, ...)
    so batch folds stay vectorized (``ufunc.at`` scatter)."""

    name: str
    reduce: Any = None
    dtype: Any = np.float64
    default: Any = 0
    ttl: Optional[StateTtlConfig] = None


@public
@dataclasses.dataclass(frozen=True)
class ListStateDescriptor:
    name: str
    ttl: Optional[StateTtlConfig] = None


@public
@dataclasses.dataclass(frozen=True)
class MapStateDescriptor:
    name: str
    ttl: Optional[StateTtlConfig] = None


class ValueState:
    """Dense vectorized value-per-key state."""

    def __init__(self, store: "KeyedStateStore", desc: ValueStateDescriptor):
        self._store = store
        self.desc = desc
        self._values = np.full(store.capacity, desc.default,
                               dtype=np.dtype(desc.dtype))
        self._ttl = (TtlStamps(store.capacity, desc.ttl)
                     if getattr(desc, "ttl", None) is not None else None)

    def _on_grow(self, old: int, new: int) -> None:
        grown = np.full(new, self.desc.default, dtype=self._values.dtype)
        grown[:old] = self._values
        self._values = grown
        if self._ttl is not None:
            self._ttl.grow(old, new)

    def get(self, key_ids: np.ndarray) -> np.ndarray:
        slots = self._store.slots(key_ids)
        if self._ttl is None:
            return self._values[slots]
        now = self._store.now_ms()
        out = self._values[slots]
        hidden = self._ttl.hidden_mask(slots, now)
        if hidden.any():
            out = out.copy()
            out[hidden] = self.desc.default
        self._ttl.touch_on_read(slots, now)
        return out

    def put(self, key_ids: np.ndarray, values) -> None:
        slots = self._store.slots(key_ids)
        self._values[slots] = values
        if self._ttl is not None:
            self._ttl.touch(slots, self._store.now_ms())

    def clear(self, key_ids: np.ndarray) -> None:
        slots = self._store.slots(key_ids)
        self._values[slots] = self.desc.default
        if self._ttl is not None:
            self._ttl.clear(slots)

    def sweep_expired(self, now_ms: int) -> int:
        """Vectorized expiry sweep (reference: TtlStateFactory cleanup
        strategies collapsed into one masked reset)."""
        if self._ttl is None:
            return 0
        expired = self._ttl.sweep(now_ms)
        self._values[expired] = self.desc.default
        return len(expired)

    def snapshot(self) -> Dict[str, Any]:
        snap = {"values": self._values.copy()}
        if self._ttl is not None:
            snap["ttl_stamps"] = self._ttl.snapshot()
        return snap

    def restore(self, snap: Dict[str, Any], slot_remap=None) -> None:
        vals = snap["values"]
        if slot_remap is not None:
            self._values[slot_remap[1]] = vals[slot_remap[0]]
        else:
            self._values[: len(vals)] = vals
        if self._ttl is not None and "ttl_stamps" in snap:
            # stamps restore as-is: remaining lifetime continues from
            # the original access time (reference restore semantics)
            self._ttl.restore(snap["ttl_stamps"], slot_remap=slot_remap)


class ReducingState(ValueState):
    def __init__(self, store, desc: ReducingStateDescriptor):
        super().__init__(store, ValueStateDescriptor(
            desc.name, desc.dtype, desc.default,
            ttl=getattr(desc, "ttl", None)))
        self.reduce = desc.reduce if desc.reduce is not None else np.add

    def add(self, key_ids: np.ndarray, values) -> None:
        """Fold a batch in with one scatter (``ufunc.at`` handles duplicate
        keys within the batch in order)."""
        slots = self._store.slots(key_ids)
        if self._ttl is not None:
            now = self._store.now_ms()
            # folding into an expired entry restarts from the default —
            # the stale accumulator must not leak into the new lifetime
            expired = self._ttl.expired_mask(slots, now)
            if expired.any():
                self._values[slots[expired]] = self.desc.default
            self.reduce.at(self._values, slots, values)
            self._ttl.touch(slots, now)
            return
        self.reduce.at(self._values, slots, values)


class _HostTtl:
    """Per-key last-access stamps for the host-dict states (List/Map) —
    the dict analog of TtlStamps. ``now_ms`` is passed in so hot loops
    fetch the clock once per batch, not per element."""

    def __init__(self, store: "KeyedStateStore", cfg: StateTtlConfig):
        self._store = store
        self.cfg = cfg
        self.stamps: Dict[int, int] = {}

    def touch(self, k: int, now_ms: int) -> None:
        self.stamps[k] = now_ms

    def touch_on_read(self, k: int, now_ms: int) -> None:
        if self.cfg.update_type == ON_READ_AND_WRITE \
                and not self.is_expired(k, now_ms):
            self.stamps[k] = now_ms

    def is_expired(self, k: int, now_ms: int) -> bool:
        s = self.stamps.get(k)
        return s is not None and now_ms - s > self.cfg.ttl_ms

    def is_hidden(self, k: int, now_ms: int) -> bool:
        if self.cfg.visibility == RETURN_EXPIRED_IF_NOT_CLEANED_UP:
            return False
        return self.is_expired(k, now_ms)

    def sweep(self, now_ms: int) -> List[int]:
        dead = [k for k, s in self.stamps.items()
                if now_ms - s > self.cfg.ttl_ms]
        for k in dead:
            del self.stamps[k]
        return dead


class ListState:
    """Append-log per key; host-resident (variable size never hits HBM)."""

    def __init__(self, store: "KeyedStateStore", desc: ListStateDescriptor):
        self.desc = desc
        self._lists: Dict[int, list] = {}
        self._ttl = (_HostTtl(store, desc.ttl)
                     if getattr(desc, "ttl", None) is not None else None)

    def _now(self) -> int:
        return self._ttl._store.now_ms()

    def add(self, key_ids: np.ndarray, values) -> None:
        lists = self._lists
        vals = np.asarray(values)
        ttl = self._ttl
        now = self._now() if ttl is not None else 0
        for k, v in zip(np.asarray(key_ids).tolist(), vals.tolist()):
            if ttl is not None:
                if ttl.is_expired(k, now):
                    lists.pop(k, None)
                ttl.touch(k, now)
            lists.setdefault(k, []).append(v)

    def get(self, key_id: int) -> list:
        k = int(key_id)
        if self._ttl is not None:
            now = self._now()
            if self._ttl.is_hidden(k, now):
                return []
            self._ttl.touch_on_read(k, now)
        return self._lists.get(k, [])

    def clear(self, key_ids) -> None:
        for k in np.atleast_1d(np.asarray(key_ids)).tolist():
            self._lists.pop(int(k), None)
            if self._ttl is not None:
                self._ttl.stamps.pop(int(k), None)

    def keys(self) -> List[int]:
        if self._ttl is None:
            return list(self._lists)
        # iteration must agree with get(): expired-but-unswept keys are
        # invisible, not phantom entries with empty state
        now = self._now()
        return [k for k in self._lists
                if not self._ttl.is_hidden(k, now)]

    def sweep_expired(self, now_ms: int) -> int:
        if self._ttl is None:
            return 0
        dead = self._ttl.sweep(now_ms)
        for k in dead:
            self._lists.pop(k, None)
        return len(dead)

    def snapshot(self):
        snap = {"lists": {k: list(v) for k, v in self._lists.items()}}
        if self._ttl is not None:
            snap["ttl_stamps"] = dict(self._ttl.stamps)
        return snap

    def restore(self, snap, slot_remap=None):
        self._lists = {int(k): list(v) for k, v in snap["lists"].items()}
        if self._ttl is not None:
            self._ttl.stamps = {
                int(k): int(v)
                for k, v in snap.get("ttl_stamps", {}).items()}


class MapState:
    """Per-key hash map; host-resident.

    TTL granularity is the KEY (whole map), not the map entry — the
    coarser unit fits the columnar engine's per-slot stamps; the
    reference stamps per map ENTRY (TtlMapState), which this trades
    away for not touching a dict per access."""

    def __init__(self, store: "KeyedStateStore", desc: MapStateDescriptor):
        self.desc = desc
        self._maps: Dict[int, dict] = {}
        self._ttl = (_HostTtl(store, desc.ttl)
                     if getattr(desc, "ttl", None) is not None else None)

    def _now(self) -> int:
        return self._ttl._store.now_ms()

    def _live(self, k: int, now: int) -> dict:
        if self._ttl is not None and self._ttl.is_hidden(k, now):
            return {}
        return self._maps.get(k, {})

    def put(self, key_id: int, map_key, value) -> None:
        k = int(key_id)
        if self._ttl is not None:
            now = self._now()
            if self._ttl.is_expired(k, now):
                self._maps.pop(k, None)
            self._ttl.touch(k, now)
        self._maps.setdefault(k, {})[map_key] = value

    def get(self, key_id: int, map_key, default=None):
        k = int(key_id)
        now = self._now() if self._ttl is not None else 0
        out = self._live(k, now).get(map_key, default)
        if self._ttl is not None:
            self._ttl.touch_on_read(k, now)
        return out

    def contains(self, key_id: int, map_key) -> bool:
        now = self._now() if self._ttl is not None else 0
        return map_key in self._live(int(key_id), now)

    def remove(self, key_id: int, map_key) -> None:
        self._maps.get(int(key_id), {}).pop(map_key, None)

    def entries(self, key_id: int) -> dict:
        k = int(key_id)
        now = self._now() if self._ttl is not None else 0
        out = self._live(k, now)
        if self._ttl is not None:
            self._ttl.touch_on_read(k, now)
        return out

    def clear(self, key_ids) -> None:
        for k in np.atleast_1d(np.asarray(key_ids)).tolist():
            self._maps.pop(int(k), None)
            if self._ttl is not None:
                self._ttl.stamps.pop(int(k), None)

    def sweep_expired(self, now_ms: int) -> int:
        if self._ttl is None:
            return 0
        dead = self._ttl.sweep(now_ms)
        for k in dead:
            self._maps.pop(k, None)
        return len(dead)

    def snapshot(self):
        snap = {"maps": {k: dict(v) for k, v in self._maps.items()}}
        if self._ttl is not None:
            snap["ttl_stamps"] = dict(self._ttl.stamps)
        return snap

    def restore(self, snap, slot_remap=None):
        self._maps = {int(k): dict(v) for k, v in snap["maps"].items()}
        if self._ttl is not None:
            self._ttl.stamps = {
                int(k): int(v)
                for k, v in snap.get("ttl_stamps", {}).items()}


_STATE_TYPES = {
    ValueStateDescriptor: ValueState,
    ReducingStateDescriptor: ReducingState,
    ListStateDescriptor: ListState,
    MapStateDescriptor: MapState,
}


class KeyedStateStore:
    """All keyed states of one operator, sharing one key -> slot index.

    reference: AbstractKeyedStateBackend.java keeps a map of registered
    states per name; state is addressed (key, namespace, name).
    """

    def __init__(self, capacity: int = 1 << 12,
                 clock: Optional[Callable[[], int]] = None, device=None):
        self._states: Dict[str, Any] = {}
        #: where device-resident states (DeviceValueState) keep their
        #: values: None is execution.device's default, the card
        self.device = device
        self._index = make_slot_index(capacity, on_grow=self._on_grow)
        self.capacity = self._index.capacity
        # states are registered lazily (first ctx.state(desc) call), which
        # can happen after restore — park unclaimed snapshots until then
        self._pending: Dict[str, Any] = {}
        self._pending_remap = None
        #: processing-time source for TTL (injectable for tests)
        self.clock = clock or default_clock

    def now_ms(self) -> int:
        return self.clock()

    def sweep_expired(self, now_ms: Optional[int] = None) -> int:
        """Run the vectorized TTL sweep over every TTL'd state; returns
        entries expired. The runtime calls this on watermark advance
        (the cleanup analog of the reference's background strategies)."""
        now = self.now_ms() if now_ms is None else now_ms
        total = 0
        for st in self._states.values():
            sweep = getattr(st, "sweep_expired", None)
            if sweep is not None:
                total += sweep(now)
        return total

    def _on_grow(self, old: int, new: int) -> None:
        self.capacity = new
        for st in self._states.values():
            if isinstance(st, ValueState):
                st._on_grow(old, new)

    def slots(self, key_ids: np.ndarray) -> np.ndarray:
        kid = np.asarray(key_ids, dtype=np.int64)
        return self._index.lookup_or_insert(
            kid, np.full(len(kid), _NS, dtype=np.int64))

    def get_state(self, desc):
        st = self._states.get(desc.name)
        if st is None:
            st = _STATE_TYPES[type(desc)](self, desc)
            self._states[desc.name] = st
            if desc.name in self._pending:
                st.restore(self._pending.pop(desc.name),
                           slot_remap=self._pending_remap)
        return st

    def known_key_ids(self) -> np.ndarray:
        """All key ids with a slot (dense states) — for full-table scans."""
        used = self._index.used_slots()
        return self._index.slot_key[used]

    def snapshot(self) -> Dict[str, Any]:
        used = self._index.used_slots()
        states = {n: s.snapshot() for n, s in self._states.items()}
        # restored states never re-accessed since restore are still parked in
        # _pending — carry them forward so a restore -> checkpoint -> restore
        # cycle keeps them. Dense ("values") snapshots are indexed by the OLD
        # slot layout; re-home them onto the current layout first.
        for n, s in self._pending.items():
            if "values" in s and self._pending_remap is not None:
                old_slots, new_slots = self._pending_remap
                vals = s["values"]
                # a tensor from convert.from_jax_keyed_state: read it back
                vals = (vals.cpu().numpy() if hasattr(vals, "cpu")
                        else np.asarray(vals))
                rehomed = np.zeros(self.capacity, dtype=vals.dtype)
                rehomed[new_slots] = vals[old_slots]
                s = {"values": rehomed}
            states.setdefault(n, s)
        return {
            "keys": self._index.slot_key[used].copy(),
            "slots": used.copy(),
            "states": states,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        keys = np.asarray(snap["keys"], dtype=np.int64)
        old_slots = np.asarray(snap["slots"])
        # re-insert keys (fresh slot assignment — rescale-safe), then remap
        # dense state rows old slot -> new slot
        new_slots = self.slots(keys)
        remap = (old_slots, new_slots)
        self._pending_remap = remap
        for name, s in snap["states"].items():
            st = self._states.get(name)
            if st is not None:
                st.restore(s, slot_remap=remap)
            else:
                self._pending[name] = s
