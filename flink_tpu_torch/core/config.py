"""Typed configuration (port of ``flink_tpu/core/config.py``).

Only the options the Q5 mesh path reads are carried, under the reference's
keys and defaults, plus the port's own ``execution.device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generic, Optional, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class ConfigOption(Generic[T]):
    """A typed configuration key with a default."""

    key: str
    default: Optional[T] = None
    type: type = str
    description: str = ""


def _coerce(value: Any, typ: type) -> Any:
    if value is None or isinstance(value, typ):
        return value
    if typ is bool and isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes", "on")
    return typ(value)


class Configuration:
    """Key/value store with typed access through ConfigOptions (the
    reference's layering and fallback keys are not needed by this slice)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None) -> None:
        self._data: Dict[str, Any] = dict(data or {})

    def get(self, option: ConfigOption[T]) -> Optional[T]:
        if option.key in self._data:
            return _coerce(self._data[option.key], option.type)
        return option.default

    def set(self, option: "ConfigOption[T] | str", value: T) -> "Configuration":
        key = option.key if isinstance(option, ConfigOption) else option
        self._data[key] = value
        return self

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Configuration({self._data!r})"


class CoreOptions:
    DEFAULT_PARALLELISM = ConfigOption(
        "parallelism.default", default=1, type=int,
        description="Default operator parallelism (number of key-group "
        "shards; in this port the shard count of the logical mesh on one "
        "device).")
    MAX_PARALLELISM = ConfigOption(
        "pipeline.max-parallelism", default=128, type=int,
        description="Number of key groups (rescale granularity).")


class ExecutionOptions:
    DEVICE = ConfigOption(
        "execution.device", default="cuda", type=str,
        description="torch device the keyed state and its programs run "
        "on. 'cuda' (default) requires a CUDA card and raises without "
        "one — the port never falls back to the CPU by itself; 'cpu' "
        "runs every program's plain PyTorch version on the host.")


class BatchOptions:
    BATCH_SIZE = ConfigOption(
        "execution.micro-batch.size", default=8192, type=int,
        description="Max records per micro-batch handed to the device.")
    MAX_DISPATCH_AHEAD = ConfigOption(
        "execution.pipeline.max-dispatch-batches", default=4, type=int,
        description="How many batches of device work the task loop may "
        "dispatch ahead of completion (per-batch fences).")
    ASYNC_FIRES = ConfigOption(
        "execution.window.async-fires", default=True, type=bool,
        description="Dispatch window fires asynchronously: the fire "
        "program and its device->host copies run while the loop keeps "
        "ingesting; results and the covering watermark are forwarded "
        "once they land.")


class DeploymentOptions:
    SHUFFLE_MODE = ConfigOption(
        "shuffle.mode", default="device", type=str,
        description="keyBy data plane for the mesh engine: 'device' "
        "(default) ranks, exchanges and scatters the records on the "
        "device (flink_tpu_torch/parallel/shuffle.py). 'host' is not "
        "ported yet.")


class StateOptions:
    SLOT_CAPACITY = ConfigOption(
        "state.slot-table.capacity", default=1 << 20, type=int,
        description="Slot capacity per key-group shard of the keyed "
        "window state (grows by doubling).")
