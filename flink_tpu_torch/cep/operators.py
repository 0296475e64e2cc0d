"""Operator wrapper for the device CEP engine (port of
``flink_tpu/cep/operators.py``).

Plugs :class:`flink_tpu_torch.cep.mesh_engine.MeshCepEngine` into the
DataStream/job-graph runtime the way the device join operators plug the
join engines in: the operator opens its engine on a logical mesh of the
operator's parallelism on ``execution.device`` (P=8 is eight shards on
one card), rides the device exchange and speaks the checkpoint protocol
(``snapshot_state`` / ``restore_state``).

A pattern outside the bounded-partial device class does NOT fail the
job: :class:`UnsupportedCepPattern` at open() routes the operator to the
host :class:`CepOperator` oracle — counted and logged
(``record_host_fallback``), never silent. That is the reference's
documented semantics for such patterns, not a fallback of the device.
"""

from __future__ import annotations

from typing import List, Optional

from flink_tpu_torch.cep.kernels import UnsupportedCepPattern
from flink_tpu_torch.cep.mesh_engine import (
    MeshCepEngine,
    record_host_fallback,
)
from flink_tpu_torch.cep.pattern import Pattern
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.runtime.operators import Operator


class MeshCepOperator(Operator):
    """Keyed CEP on the device state planes, host-oracle fallback."""

    name = "device_cep"

    def __init__(self, pattern: Pattern,
                 key_field: Optional[str] = None,
                 select=None,
                 capacity: int = 1 << 16,
                 match_capacity: int = 1 << 10,
                 spill_dir: Optional[str] = None,
                 spill_host_max_bytes: int = 0) -> None:
        self.pattern = pattern
        self.key_field = key_field
        self.select = select
        self._capacity = int(capacity)
        self._match_capacity = int(match_capacity)
        self._spill_dir = spill_dir
        self._spill_host_max_bytes = int(spill_host_max_bytes)
        self.engine: Optional[MeshCepEngine] = None

    def open(self, ctx) -> None:
        kwargs = dict(
            key_field=self.key_field,
            select=self.select,
            capacity_per_shard=self._capacity,
            max_parallelism=getattr(ctx, "max_parallelism", 128),
            match_capacity=self._match_capacity,
            spill_dir=self._spill_dir,
            spill_host_max_bytes=self._spill_host_max_bytes,
            key_group_range=getattr(ctx, "key_group_range", None),
        )
        try:
            self.engine = MeshCepEngine(
                self.pattern, backend="device",
                num_shards=max(int(getattr(ctx, "parallelism", 1)), 1),
                device=getattr(ctx, "device", None),
                shuffle_mode=getattr(ctx, "shuffle_mode", "device"),
                **kwargs)
        except UnsupportedCepPattern as e:
            record_host_fallback(str(e))
            self.engine = MeshCepEngine(
                self.pattern, num_shards=1, backend="host",
                shuffle_mode="host", **kwargs)
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
        return self.engine is not None \
            and self.engine.backend == "device"

    def reshard(self, new_shards: int):
        return self.engine.reshard(new_shards)

    def spill_counters(self):
        return self.engine.spill_counters()

    def register_metrics(self, group) -> None:
        self.engine.register_metrics(group)
