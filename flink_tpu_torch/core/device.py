"""Device resolution: the card unless the caller asks for the CPU.

Every entry point of the port takes a device. ``None`` means the
configured default (``execution.device``, itself ``"cuda"`` by default).
A CUDA device that does not exist raises here, once, with the remedy —
the port never continues on the CPU by itself.
"""

from __future__ import annotations

from typing import Union

import torch

from flink_tpu_torch.core.config import ExecutionOptions

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None, config=None) -> torch.device:
    """``device`` (or the configuration's ``execution.device``) as a
    ``torch.device``; raises when it names CUDA and no card is present."""
    if device is None:
        device = (config.get(ExecutionOptions.DEVICE) if config is not None
                  else ExecutionOptions.DEVICE.default)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (execution.device defaults to "
            "'cuda') but torch.cuda.is_available() is False; pass "
            "device='cpu' (or execution.device=cpu) to run on the host")
    return dev
