"""Carry state across from the JAX engine: a ``MeshWindowEngine``'s
``[P, capacity]`` accumulator planes (read back from ``flink_tpu`` as
numpy arrays) become the port's planes on a given device, a process
operator's snapshot (timers and keyed state) becomes the port's with its
device value states as tensors on a given device, a
``GroupAggOperator`` or OVER snapshot becomes one the port's operator
restores, a checkpoint's operator states (as the reference's storage
reads them) become the port's, and a model's parameter pytree becomes
tensors on a device."""

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


def _np_copy(v):
    if isinstance(v, dict):
        return {k: _np_copy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_np_copy(x) for x in v)
    if isinstance(v, np.ndarray) or hasattr(v, "__array__"):
        return np.array(v, copy=True)
    return v


def from_jax_over_state(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """A reference OVER snapshot (``OverAggOperator`` or
    ``DeviceOverAggOperator.snapshot_state()``, arrays read as numpy) as
    the port's: the pending rows, the host engine's per-key context and
    accumulators and the emitted watermark are copied as they are; the
    device engine's flat context (``over_device_ctx``) keeps its key ids
    and timestamps as int64 and takes its values and weights to float64,
    the port's program dtype (the reference's program returns float32
    running sums unless JAX runs with x64). Either port operator restores
    it and continues with the reference's rows."""
    if "over_emitted_wm" not in snapshot:
        raise KeyError(f"not an OVER snapshot: no 'over_emitted_wm' (has "
                       f"{sorted(snapshot)})")
    out = {k: _np_copy(v) for k, v in snapshot.items()
           if k != "over_device_ctx"}
    out["over_emitted_wm"] = int(snapshot["over_emitted_wm"])
    ctx = snapshot.get("over_device_ctx")
    if ctx is not None:
        out["over_device_ctx"] = {
            "kid": np.array(ctx["kid"], dtype=np.int64, copy=True),
            "ts": np.array(ctx["ts"], dtype=np.int64, copy=True),
            "val": [np.array(v, dtype=np.float64, copy=True)
                    for v in ctx["val"]],
            "wt": [np.array(w, dtype=np.float64, copy=True)
                   for w in ctx["wt"]],
        }
    return out


def from_jax_model_params(params: Any, device: DeviceLike = None
                          ) -> Dict[str, torch.Tensor]:
    """A pytree of arrays (nested dicts, lists and tuples, as a
    ``JaxModel``'s params; read back as numpy) as a flat dict of tensors
    on ``device`` (default: ``execution.device``, i.e. the card), keyed by
    the leaf's path joined with dots (``{"l0": {"w": ...}}`` -> ``"l0.w"``;
    list positions are numbers). Same dtypes and values; the caller maps
    the keys onto its module's ``state_dict`` (a JAX dense kernel is
    ``[in, out]``, ``nn.Linear.weight`` ``[out, in]``)."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = torch.from_numpy(
                np.array(np.asarray(node), copy=True)).to(dev)
            return
        for k, v in items:
            walk(f"{prefix}.{k}" if prefix else str(k), v)

    walk("", params)
    return out


def from_jax_checkpoint_state(states: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint's ``{operator id: state}`` as the reference's
    ``CheckpointStorage.read_checkpoint`` returns it, as the port's
    storage returns it: the on-disk format is shared, so every array
    becomes a numpy copy and every container is rebuilt; nothing else
    changes. The stage executors of both packages merge their subtasks'
    states into this single-slot format."""
    if isinstance(states, dict):
        return {k: from_jax_checkpoint_state(v) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return type(states)(from_jax_checkpoint_state(v) for v in states)
    if hasattr(states, "__array__") and not np.isscalar(states):
        return np.array(states, copy=True)
    return states
