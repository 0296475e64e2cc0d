"""Typed configuration (port of ``flink_tpu/core/config.py``).

Only the options the Q5 path reads (parallelism 8 and 1) are carried,
under the reference's keys and defaults, plus the port's own
``execution.device``.
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
    MAX_DEVICE_SLOTS = ConfigOption(
        "state.slot-table.max-device-slots", default=0, type=int,
        description="Device-resident slot budget per keyed state (device "
        "memory bound). 0 = unbounded (grow by doubling). When the budget "
        "is reached, cold namespaces spill to host memory and reload "
        "transparently on access. Above parallelism 1 it is per shard of "
        "the logical mesh for session jobs (the mesh paged tier); the mesh "
        "window engine raises for it (ROADMAP item 7c).")
    WINDOW_LAYOUT = ConfigOption(
        "state.window-layout", default="auto", type=str,
        description="Keyed window state layout at parallelism 1: 'slots' "
        "((key, slice) slot table — the general engine, with the spill "
        "tier), 'panes' (ring of slices x stable key columns, dense on the "
        "device: fires are device reductions with no per-fire slot matrix; "
        "aligned windows without a spill tier, "
        "flink_tpu_torch/state/pane_table.py), or 'auto' (resolves to "
        "'slots', as in the reference).")
    SPILL_DIR = ConfigOption(
        "state.spill.dir", default=None, type=str,
        description="Filesystem tier for spilled state (a local path or "
        "file://; other schemes are not ported). None = spill stays in "
        "host memory.")
    SPILL_HOST_MAX_BYTES = ConfigOption(
        "state.spill.host-max-bytes", default=0, type=int,
        description="Host-memory budget for spilled namespaces before they "
        "overflow to state.spill.dir. 0 = unbounded host tier.")
    BACKEND = ConfigOption(
        "state.backend", default="tpu-slot-table", type=str,
        description="Keyed-state backend: 'tpu-slot-table' keeps the "
        "accumulators on execution.device (the card), with the spill "
        "tier beyond it. The reference's placement backends (host-heap, "
        "third-party placements) are not ported.")


class LatencyOptions:
    """The fire-latency tier: a watermark fire costs a bounded delta, not a
    full-window harvest, and never queues behind a whole ingest batch."""

    FIRE_DEADLINE_MS = ConfigOption(
        "latency.fire-deadline-ms", default=0, type=int,
        description="Fire-latency budget in wall-clock ms. When > 0 the "
        "task loop splits each ingest micro-batch against this budget "
        "using the measured per-record rate, advancing the watermark and "
        "harvesting landed async fires between the splits (the output is "
        "the unsplit run's). 0 (default) = whole batches.")
    PANE_PREAGG = ConfigOption(
        "latency.pane-preagg", default=True, type=bool,
        description="Incremental pane pre-aggregation for "
        "state.window-layout=panes: per-window running partials combined "
        "at absorb, so a fire gathers ONE partial ring row instead of "
        "merging the window's k slice rows (the full-window harvest, "
        "which stays the fallback and is the path for false). Float sums "
        "fold in record order rather than per-slice order, so float32 "
        "results can differ from the full harvest in the last ulp.")
