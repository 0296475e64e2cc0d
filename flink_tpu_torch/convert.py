"""Carry state across from the JAX engine: a ``MeshWindowEngine``'s
``[P, capacity]`` accumulator planes (read back from ``flink_tpu`` as
numpy arrays) become the port's planes on a given device."""

from __future__ import annotations

from typing import Sequence, Tuple

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
