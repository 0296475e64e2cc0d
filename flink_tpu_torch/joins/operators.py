"""Two-input operator wrappers for the join engines (port of
``flink_tpu/joins/operators.py``).

They plug :mod:`flink_tpu_torch.joins.engine` into the DataStream runtime
as ``WindowAggOperator`` plugs the mesh window engine in: the operator
opens its engine on a logical mesh of ``parallelism`` shards on
``execution.device`` (P=8 is eight shards on one card, not a count capped
by the number of devices), rides the device exchange and speaks the
checkpoint protocol (``snapshot_state`` / ``restore_state``).

Selected by ``join.mode=device``; the default host operators
(``runtime/join_operators.py``) are the other plane, chosen by
configuration only: a failure here fails the job.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.joins.engine import (
    MeshIntervalJoinEngine,
    MeshTemporalJoinEngine,
)
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.runtime.operators import Operator


def _engine_kwargs(ctx, capacity: int, max_device_slots: int,
                   spill_dir: Optional[str],
                   spill_host_max_bytes: int = 0):
    from flink_tpu_torch.parallel.mesh import make_mesh

    return dict(
        mesh=make_mesh(max(int(getattr(ctx, "parallelism", 1)), 1),
                       getattr(ctx, "device", None)),
        capacity_per_shard=capacity,
        max_parallelism=getattr(ctx, "max_parallelism", 128),
        max_device_slots=max_device_slots,
        spill_dir=spill_dir,
        spill_host_max_bytes=spill_host_max_bytes,
        backend="device",
        shuffle_mode=getattr(ctx, "shuffle_mode", "device"),
    )


class _DeviceJoinOperator(Operator):
    """What both device join operators share: the engine's options, the
    watermark and checkpoint plumbing."""

    def __init__(self, suffixes: Tuple[str, str] = ("_l", "_r"),
                 capacity: int = 1 << 16,
                 max_device_slots: int = 0,
                 spill_dir: Optional[str] = None,
                 spill_host_max_bytes: int = 0) -> None:
        self.suffixes = tuple(suffixes)
        self._capacity = int(capacity)
        self._max_device_slots = int(max_device_slots)
        self._spill_dir = spill_dir
        self._spill_host_max_bytes = int(spill_host_max_bytes)
        self.engine = None

    def _kwargs(self, ctx):
        return _engine_kwargs(ctx, self._capacity, self._max_device_slots,
                              self._spill_dir, self._spill_host_max_bytes)

    def _attach_watchdog(self, ctx) -> None:
        wd = getattr(ctx, "watchdog", None)
        if wd is not None:
            self.engine.attach_watchdog(wd)

    def process_batch(self, batch, input_index=0) -> List[RecordBatch]:
        return self.engine.process_batch(batch, input_index)

    def process_watermark(self, watermark, input_index=0
                          ) -> List[RecordBatch]:
        return self.engine.on_watermark(int(watermark))

    def close(self) -> List[RecordBatch]:
        return self.engine.on_watermark(MAX_WATERMARK)

    def snapshot_state(self):
        return self.engine.snapshot()

    def restore_state(self, state, key_group_filter=None):
        self.engine.restore(state, key_group_filter=key_group_filter)

    def supports_live_rescale(self) -> bool:
        return True

    def reshard(self, new_shards: int):
        return self.engine.reshard(new_shards)

    def spill_counters(self):
        return self.engine.spill_counters()


class DeviceIntervalJoinOperator(_DeviceJoinOperator):
    """Keyed interval join on the device row tables (INNER): the stream
    contract of ``IntervalJoinOperator`` (matches emit when the second
    side arrives; watermark advances prune both sides)."""

    name = "device_interval_join"

    def __init__(self, lower: int, upper: int,
                 suffixes: Tuple[str, str] = ("_l", "_r"), **kw) -> None:
        if lower > upper:
            raise ValueError(f"lower {lower} > upper {upper}")
        super().__init__(suffixes, **kw)
        self.lower = int(lower)
        self.upper = int(upper)

    def open(self, ctx) -> None:
        self.engine = MeshIntervalJoinEngine(
            self.lower, self.upper, suffixes=self.suffixes,
            **self._kwargs(ctx))
        self._attach_watchdog(ctx)


class DeviceTemporalJoinOperator(_DeviceJoinOperator):
    """Event-time temporal join against the versioned device table."""

    name = "device_temporal_join"

    def open(self, ctx) -> None:
        self.engine = MeshTemporalJoinEngine(suffixes=self.suffixes,
                                             **self._kwargs(ctx))
        self._attach_watchdog(ctx)

    @property
    def late_left_dropped(self) -> int:
        return self.engine.late_left_dropped if self.engine else 0
