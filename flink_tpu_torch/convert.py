"""Carry state across from the JAX engine: a ``MeshWindowEngine``'s
``[P, capacity]`` accumulator planes (read back from ``flink_tpu`` as
numpy arrays) become the port's planes on a given device, a process
operator's snapshot (timers and keyed state) becomes the port's with its
device value states as tensors on a given device, and a
``GroupAggOperator`` snapshot becomes one the port's operator restores."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.device import DeviceLike, resolve_device


def from_jax_planes(planes: Sequence[np.ndarray],
                    device: DeviceLike = None) -> Tuple[torch.Tensor, ...]:
    """One contiguous tensor per plane, same dtype and values, on
    ``device`` (default: ``execution.device``, i.e. the card)."""
    dev = resolve_device(device)
    out = []
    for p in planes:
        a = np.ascontiguousarray(np.asarray(p))
        if a.ndim != 2:
            raise ValueError(f"expected a [P, capacity] plane, got "
                             f"shape {a.shape}")
        out.append(torch.from_numpy(a.copy()).to(dev))
    return tuple(out)


def from_jax_keyed_state(snapshot: Dict[str, Any], device: DeviceLike = None,
                         device_states: Iterable[str] = ()
                         ) -> Dict[str, Any]:
    """A reference ``ProcessOperator.snapshot_state()`` (its timers and
    ``keyed_state``, arrays read as numpy) as the port's: the values of
    the states named in ``device_states`` (the operator's
    ``DeviceValueStateDescriptor`` states) become 1-D tensors on
    ``device`` (default: ``execution.device``, i.e. the card), which the
    port's ``ProcessOperator.restore_state`` lands without a host copy;
    every other array is copied as numpy."""
    dev = resolve_device(device)
    on_device = set(device_states)
    out = {k: v for k, v in snapshot.items() if k != "keyed_state"}
    ks = snapshot.get("keyed_state")
    if ks is not None:
        states = {}
        for name, st in ks["states"].items():
            st = dict(st)
            if name in on_device:
                st["values"] = torch.from_numpy(
                    np.array(st["values"], copy=True)).to(dev)
            elif "values" in st:
                st["values"] = np.array(st["values"], copy=True)
            states[name] = st
        missing = on_device - set(states)
        if missing:
            raise KeyError(f"no state named {sorted(missing)} in the "
                           f"snapshot (has {sorted(states)})")
        out["keyed_state"] = {"keys": np.array(ks["keys"], copy=True),
                              "slots": np.array(ks["slots"], copy=True),
                              "states": states}
    return out


def from_jax_group_agg(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """A reference ``GroupAggOperator`` snapshot (``snapshot_state``,
    ``snapshot_state_delta`` or ``snapshot_state_savepoint``) as the
    port's. The accumulators are the slot table's LOGICAL rows (key id,
    namespace, key group and one value array per leaf, not ``[P,
    capacity]`` planes): they are copied in their dtypes and land on the
    operator's device in one put when ``restore_state`` runs. The row
    counts, the emitted mask, the pending (dirty) marks, the TTL stamps
    and the last-emitted images are carried as they are."""
    def copy(v):
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            return np.array(v, copy=True)
        return v

    missing = {"table", "changelog"} - set(snapshot)
    if missing:
        raise KeyError(f"not a GroupAggOperator snapshot: no "
                       f"{sorted(missing)} (has {sorted(snapshot)})")
    out = {k: copy(v) for k, v in snapshot.items()
           if k not in ("key_values",)}
    out["key_values"] = dict(snapshot.get("key_values", {}))
    return out
