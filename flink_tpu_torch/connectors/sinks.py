"""Sinks (port of the base sink and ``CollectSink`` of
``flink_tpu/connectors/sinks.py``)."""

from __future__ import annotations

from typing import List

from flink_tpu_torch.core.records import RecordBatch


class Sink:
    def open(self, subtask_index: int = 0) -> None:
        pass

    def write(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CollectSink(Sink):
    """Collects all batches in memory (tests / execute_and_collect)."""

    def __init__(self):
        self.batches: List[RecordBatch] = []

    def write(self, batch):
        self.batches.append(batch)

    def result(self) -> RecordBatch:
        return RecordBatch.concat(self.batches)

    def rows(self):
        return self.result().to_rows()
