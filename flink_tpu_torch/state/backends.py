"""State backend SPI — where keyed state lives (port of
``flink_tpu/state/backends.py``).

reference: StateBackend SPI (flink-runtime/.../state/StateBackend.java)
with HashMapStateBackend (JVM heap) and EmbeddedRocksDBStateBackend
(native, beyond-memory) selected by ``state.backend``.

Re-design: every backend runs the SAME batched programs — what a backend
decides is *placement*: which device holds the accumulator tensors. Torch
computation follows the tensors' device, so choosing the device is the
whole backend:

- ``tpu-slot-table`` (the default; the reference's name, kept because
  users' configurations carry it): accumulators live on
  ``execution.device`` (the card), with the spill tier beyond it;
- ``host-heap``: accumulators live on ``torch.device("cpu")`` — nothing
  crosses the PCIe link (the HashMapStateBackend role: small-state jobs
  where a launch costs more than the compute). The user asked for the
  CPU, so this is a placement, not a fallback;
- third-party backends register a placement factory under a name
  (``register_state_backend``), e.g. a second card.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

#: name -> (execution.device) -> torch.device
_BACKENDS: Dict[str, Callable] = {}


def register_state_backend(name: str, placement_factory: Callable) -> None:
    """Register a backend: ``placement_factory(execution_device) ->
    torch.device | str | None`` (None: the job's ``execution.device``)."""
    _BACKENDS[name] = placement_factory


def _default_placement(execution_device):
    return execution_device


def _host_placement(execution_device):
    return torch.device("cpu")


register_state_backend("tpu-slot-table", _default_placement)
register_state_backend("host-heap", _host_placement)


def resolve_placement(backend: str, execution_device=None) -> torch.device:
    """The device keyed-state accumulators live on under ``backend``
    (``execution_device``: the job's ``execution.device``, default the
    card); raises for an unknown name or a CUDA placement without a
    card."""
    from flink_tpu_torch.core.device import resolve_device

    try:
        factory = _BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown state.backend {backend!r}; registered: "
            f"{sorted(_BACKENDS)}") from None
    placement = factory(execution_device)
    return resolve_device(placement if placement is not None
                          else execution_device)
