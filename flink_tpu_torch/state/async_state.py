"""Async keyed state: StateFuture-returning views for process functions
(port of ``flink_tpu/state/async_state.py``).

An async op carries a whole key vector. The ``AsyncExecutionController``
queues ops into waves: an op joins the open wave unless one of its keys
conflicts with an earlier op in that wave (read after write, write after
read, or a write of another kind); a conflict seals the wave. At a drain
each wave runs one vectorized call per (state, op kind), so N same-kind
ops on disjoint keys cost one gather or one scatter. Drains happen at
the end of every operator invocation, before every snapshot, and at any
``StateFuture.value()``.

``DeviceValueState`` keeps a value state's array as a 1-D tensor on the
store's device (the operator's ``execution.device``). Its gather clamps
slots into range and returns the device tensor without a sync; only
``StateFuture.value()`` copies to the host. Its put is stream-ordered:
where a slot appears more than once, the lane that comes last in array
order wins, bit for bit on the CPU and on the card (``put_last_wins``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

import torch

from flink_tpu_torch.core.annotations import public
from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.state.keyed_state import (
    MapState,
    ReducingState,
    ValueState,
    ValueStateDescriptor,
)

# op kinds
_GET, _PUT, _ADD, _CLEAR = "get", "put", "add", "clear"
_READS = (_GET,)
_WRITES = (_PUT, _ADD, _CLEAR)


@public
class StateFuture:
    """Result of one async state op.

    reference: api/common/state/v2/StateFuture.java — thenAccept /
    thenApply composition; completion happens on the task thread at
    drain, never concurrently with user code.
    """

    __slots__ = ("_controller", "_done", "_value", "_callbacks")

    def __init__(self, controller: "AsyncExecutionController"):
        self._controller = controller
        self._done = False
        self._value = None
        self._callbacks: List[Tuple[Callable, "StateFuture"]] = []

    @property
    def done(self) -> bool:
        return self._done

    def value(self):
        """Force: drains the controller if this op has not executed yet.
        A device gather's result is copied to host NumPy here, once (the
        one place a device transfer blocks)."""
        if not self._done:
            self._controller.drain()
        v = self._value
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()  # the one copy of a device gather
            self._value = v
        return v

    def then(self, fn: Callable[[Any], Any]) -> "StateFuture":
        """Chain ``fn(result)``; returns a future for fn's return value.
        Runs at completion on the task thread (reference: thenApply —
        callbacks re-enqueued as mail on the mailbox thread)."""
        out = StateFuture(self._controller)
        if self._done:
            out._complete(fn(self.value()))
        else:
            self._callbacks.append((fn, out))
        return out

    def _complete(self, value) -> None:
        self._done = True
        self._value = value
        cbs, self._callbacks = self._callbacks, []
        for fn, out in cbs:
            out._complete(fn(self.value()))


@dataclasses.dataclass
class _Op:
    state: Any          # executor adapter (async handle)
    kind: str
    key_ids: np.ndarray
    payload: Any        # values (put/add) / map_keys tuple (map ops) / None
    future: StateFuture


class _Wave:
    """One conflict-free group of ops: executes as one kernel per
    (state, kind) group."""

    def __init__(self):
        self.ops: List[_Op] = []
        # per-state key footprints for conflict checks
        self._reads: Dict[int, set] = {}
        self._writes: Dict[int, set] = {}       # keys written, any kind
        self._write_kind: Dict[int, str] = {}   # state id -> sole write kind

    def admits(self, op: _Op, keys: set) -> bool:
        sid = id(op.state)
        if op.kind in _READS:
            # read-after-write in the same wave would see stale values
            return not (self._writes.get(sid) and
                        keys & self._writes[sid])
        # writes: conflict with earlier reads (order would flip) and with
        # earlier writes of a DIFFERENT kind (put vs add don't commute);
        # same-kind writes merge — concatenation preserves submission
        # order (NumPy scatter is last-wins in array order, ufunc.at
        # accumulates), so duplicates stay correct.
        if self._reads.get(sid) and keys & self._reads[sid]:
            return False
        if self._writes.get(sid) and self._write_kind.get(sid) != op.kind \
                and keys & self._writes[sid]:
            return False
        return True

    def add(self, op: _Op, keys: set) -> None:
        sid = id(op.state)
        if op.kind in _READS:
            self._reads.setdefault(sid, set()).update(keys)
        else:
            self._writes.setdefault(sid, set()).update(keys)
            self._write_kind[sid] = op.kind \
                if self._write_kind.get(sid, op.kind) == op.kind else "mixed"
        self.ops.append(op)


class AsyncExecutionController:
    """Buffers async state ops and executes them in coalesced waves.

    reference: runtime/asyncprocessing/AsyncExecutionController.java:57
    (StateRequestBuffer + KeyAccountingUnit + StateExecutor). ``stats``
    counts ops/waves/kernel calls so tests can assert the coalescing
    contract instead of trusting it.
    """

    def __init__(self):
        self._waves: List[_Wave] = []
        self.stats = {"ops": 0, "waves": 0, "kernel_calls": 0}

    # -- submission ----------------------------------------------------------

    def submit(self, state, kind: str, key_ids, payload=None) -> StateFuture:
        op = _Op(state, kind, np.atleast_1d(
            np.asarray(key_ids, dtype=np.int64)), payload,
            StateFuture(self))
        keys = set(op.key_ids.tolist())
        if not self._waves or not self._waves[-1].admits(op, keys):
            self._waves.append(_Wave())
        self._waves[-1].add(op, keys)
        self.stats["ops"] += 1
        return op.future

    @property
    def pending(self) -> int:
        return sum(len(w.ops) for w in self._waves)

    # -- execution -----------------------------------------------------------

    def drain(self) -> None:
        """Execute everything pending, in wave order. Callbacks may submit
        new ops; the loop runs until the queue is empty (reference:
        drainInflightRecords loops until allRequestsDone)."""
        while self._waves:
            waves, self._waves = self._waves, []
            for wave in waves:
                self._execute(wave)

    def _execute(self, wave: _Wave) -> None:
        self.stats["waves"] += 1
        # group by (state, kind) in first-appearance order
        groups: Dict[Tuple[int, str], List[_Op]] = {}
        for op in wave.ops:
            groups.setdefault((id(op.state), op.kind), []).append(op)
        for ops in groups.values():
            state, kind = ops[0].state, ops[0].kind
            keys = np.concatenate([o.key_ids for o in ops])
            self.stats["kernel_calls"] += 1
            if kind == _GET:
                res = state._exec_get(keys, ops)
                # split the batched result back per op
                offs = np.cumsum([len(o.key_ids) for o in ops])[:-1]
                parts = (res if isinstance(res, list)
                         else _split(res, offs))
                for o, part in zip(ops, parts):
                    o.future._complete(part)
            elif kind == _PUT:
                state._exec_put(keys, ops)
                for o in ops:
                    o.future._complete(None)
            elif kind == _ADD:
                state._exec_add(keys, ops)
                for o in ops:
                    o.future._complete(None)
            else:  # _CLEAR
                state._exec_clear(keys)
                for o in ops:
                    o.future._complete(None)


def _split(arr, offsets):
    return np.split(arr, offsets) if isinstance(arr, np.ndarray) \
        else [arr[a:b] for a, b in _ranges(offsets, _len(arr))]


def _ranges(offsets, n):
    starts = [0] + list(offsets)
    ends = list(offsets) + [n]
    return zip(starts, ends)


def _len(arr):
    return arr.shape[0]


def _concat_payload(ops: List[_Op]) -> np.ndarray:
    return np.concatenate([
        np.broadcast_to(np.asarray(o.payload), o.key_ids.shape)
        for o in ops])


# --------------------------------------------------------------------------
# Async handles over the host states
# --------------------------------------------------------------------------


@public
class AsyncValueState:
    """StateFuture-returning view of a (host or device) value state.

    reference: runtime/state/v2/ValueState.java — asyncValue()/
    asyncUpdate(); here vectorized per the engine's batch contract.
    """

    def __init__(self, controller: AsyncExecutionController, sync: ValueState):
        self._aec = controller
        self._sync = sync

    # async API
    def get(self, key_ids) -> StateFuture:
        return self._aec.submit(self, _GET, key_ids)

    def put(self, key_ids, values) -> StateFuture:
        return self._aec.submit(self, _PUT, key_ids, values)

    def clear(self, key_ids) -> StateFuture:
        return self._aec.submit(self, _CLEAR, key_ids)

    # executor hooks (one vectorized sync call == one kernel)
    def _exec_get(self, keys, ops):
        if isinstance(self._sync, DeviceValueState):
            # the device gather stays on the device until value()
            return self._sync._exec_get(keys, ops)
        return self._sync.get(keys)

    def _exec_put(self, keys, ops):
        self._sync.put(keys, _concat_payload(ops))

    def _exec_clear(self, keys):
        self._sync.clear(keys)


@public
class AsyncReducingState(AsyncValueState):
    """reference: runtime/state/v2/ReducingState.java asyncAdd()."""

    def add(self, key_ids, values) -> StateFuture:
        return self._aec.submit(self, _ADD, key_ids, values)

    def _exec_add(self, keys, ops):
        self._sync.add(keys, _concat_payload(ops))


@public
class AsyncMapState:
    """reference: runtime/state/v2/MapState.java asyncGet/asyncPut.
    Vectorized over (key_id, map_key) pairs; executes through the host
    MapState (variable-size state never hits the device), so the async
    win here is ordering + batching with other states' ops, not kernels.
    """

    def __init__(self, controller: AsyncExecutionController, sync: MapState):
        self._aec = controller
        self._sync = sync

    def get(self, key_ids, map_keys, default=None) -> StateFuture:
        return self._aec.submit(self, _GET, key_ids,
                                (list(map_keys), default))

    def put(self, key_ids, map_keys, values) -> StateFuture:
        return self._aec.submit(self, _PUT, key_ids,
                                (list(map_keys), list(values)))

    def clear(self, key_ids) -> StateFuture:
        return self._aec.submit(self, _CLEAR, key_ids)

    def _exec_get(self, keys, ops):
        out = []
        for o in ops:
            mkeys, default = o.payload
            out.append([self._sync.get(int(k), mk, default)
                        for k, mk in zip(o.key_ids.tolist(), mkeys)])
        return out

    def _exec_put(self, keys, ops):
        for o in ops:
            mkeys, vals = o.payload
            for k, mk, v in zip(o.key_ids.tolist(), mkeys, vals):
                self._sync.put(k, mk, v)

    def _exec_clear(self, keys):
        self._sync.clear(keys)


# --------------------------------------------------------------------------
# Device-resident value state
# --------------------------------------------------------------------------


def gather_clip(values: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``values[clip(slots, 0, n - 1)]``: JAX's ``take(mode="clip")``,
    no sync."""
    return values.index_select(0, slots.clamp(0, values.shape[0] - 1))


def put_last_wins(values: torch.Tensor, slots: torch.Tensor,
                  x: torch.Tensor) -> None:
    """``values[slots] = x`` in place, where of duplicate slots the lane
    that comes last in array order wins (NumPy's and JAX's ``.at[].set``).
    Each slot's last lane is found by an ``amax`` of lane positions (exact
    in any order); every lane then writes its slot's last value, so
    duplicate writes carry the same bits and the scatter's undefined
    winner does not matter. No sync."""
    n = slots.shape[0]
    if n == 0:
        return
    pos = torch.arange(n, device=values.device)
    last = torch.full((values.shape[0],), -1, dtype=torch.int64,
                      device=values.device)
    last.scatter_reduce_(0, slots, pos, "amax")
    values.index_copy_(0, slots, x.index_select(0, last.index_select(0, slots)))


class DeviceValueState(ValueState):
    """ValueState whose dense array is a 1-D tensor on the store's device
    (``KeyedStateStore.device``: the operator's ``execution.device``).

    Gathers (``gather_clip``) return device tensors without a sync, so a
    wave of async gets overlaps the host work after it and materializes at
    ``StateFuture.value()``; puts are stream-ordered (``put_last_wins``).
    Growth allocates ``full(new, default)`` and copies the old rows; a
    snapshot is one device-to-host copy. TTL is refused."""

    def __init__(self, store, desc: ValueStateDescriptor):
        if getattr(desc, "ttl", None) is not None:
            raise ValueError(
                "DeviceValueState does not support TTL yet; keep TTL'd "
                "state on the host backend (state.backend=host-heap)")
        self._store = store
        self.desc = dataclasses.replace(desc, ttl=None)
        self._ttl = None
        self.dtype = np.dtype(desc.dtype)
        self._tdtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        self.device = resolve_device(store.device)
        self._dvals = torch.full((store.capacity,), desc.default,
                                 dtype=self._tdtype, device=self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(
            self.device, non_blocking=True)

    def _slots(self, key_ids) -> torch.Tensor:
        return self._to_device(
            self._store.slots(key_ids).astype(np.int64, copy=False))

    def get(self, key_ids) -> np.ndarray:
        """Sync get: gather, then copy to the host (blocks)."""
        return gather_clip(self._dvals, self._slots(key_ids)).cpu().numpy()

    def put(self, key_ids, values) -> None:
        slots = self._slots(key_ids)
        vals = np.broadcast_to(np.asarray(values, dtype=self.dtype),
                               slots.shape)
        put_last_wins(self._dvals, slots, self._to_device(vals))

    def clear(self, key_ids) -> None:
        self.put(key_ids, self.desc.default)

    # the async view's gather: the DEVICE tensor (no sync); the
    # controller slices it per op and only value() copies it
    def _exec_get(self, keys, ops):
        return gather_clip(self._dvals, self._slots(keys))

    # -- growth / checkpoint -------------------------------------------------

    def _on_grow(self, old: int, new: int) -> None:
        grown = torch.full((new,), self.desc.default, dtype=self._tdtype,
                           device=self.device)
        grown[:old] = self._dvals
        self._dvals = grown

    def snapshot(self) -> Dict[str, Any]:
        return {"values": self._dvals.to("cpu", copy=True).numpy()}

    def restore(self, snap, slot_remap=None) -> None:
        """``snap["values"]`` is NumPy (a checkpoint) or a tensor
        (``convert.from_jax_keyed_state``), which lands without a host
        copy."""
        vals = snap["values"]
        vals = (vals.to(self.device, self._tdtype)
                if isinstance(vals, torch.Tensor)
                else self._to_device(np.asarray(vals, dtype=self.dtype)))
        if slot_remap is not None:
            old, new = (self._to_device(np.asarray(r).astype(np.int64))
                        for r in slot_remap)
            # new slots are distinct keys' slots: a plain scatter
            self._dvals[new] = vals[old]
        else:
            self._dvals[: len(vals)] = vals


@public
@dataclasses.dataclass(frozen=True)
class DeviceValueStateDescriptor(ValueStateDescriptor):
    """ValueStateDescriptor whose values live on the operator's device."""


# register with the store's descriptor dispatch
from flink_tpu_torch.state import keyed_state as _ks  # noqa: E402

_ks._STATE_TYPES[DeviceValueStateDescriptor] = DeviceValueState


def make_async_view(controller: AsyncExecutionController, sync_state):
    """Wrap a sync state handle in its async view."""
    if isinstance(sync_state, ReducingState):
        return AsyncReducingState(controller, sync_state)
    if isinstance(sync_state, ValueState):  # incl. DeviceValueState
        return AsyncValueState(controller, sync_state)
    if isinstance(sync_state, MapState):
        return AsyncMapState(controller, sync_state)
    raise TypeError(
        f"no async view for state type {type(sync_state).__name__} "
        "(ListState stays sync: append-only host logs gain nothing "
        "from coalescing)")
