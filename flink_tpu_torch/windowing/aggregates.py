"""Vectorized aggregate functions (port of
``flink_tpu/windowing/aggregates.py``).

An aggregate declares its accumulator as a tuple of *leaves* — flat device
planes, one per accumulator component — each with a scatter-reduce kind.
``add`` over a micro-batch is one in-place scatter per leaf, ``merge``
across window slices a gather + reduce over the slice axis, and
``finish`` maps merged leaves to result columns with torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.ops.segment_ops import SCATTER_METHOD, identity_for


@dataclasses.dataclass(frozen=True)
class AccLeaf:
    """One flat component of an accumulator.

    ``const`` marks a leaf whose per-record input is a constant (the ``1``
    of COUNT): no host value array is built for it, the scatter broadcasts
    the constant on the device. Padded lanes target the reserved identity
    slot 0, so padding never reaches a live accumulator.
    """

    name: str
    dtype: np.dtype
    reduce: str  # 'sum' | 'max' | 'min'
    const: object = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        if self.reduce not in SCATTER_METHOD:
            raise ValueError(f"unsupported reduce {self.reduce!r}")

    @property
    def identity(self):
        return identity_for(self.reduce, self.dtype)


class AggregateFunction:
    """Base class. Subclasses define ``leaves``, ``map_input`` and ``finish``."""

    #: accumulator layout
    leaves: Tuple[AccLeaf, ...] = ()
    #: names of the emitted result columns
    output_names: Tuple[str, ...] = ("result",)

    def map_input(self, batch: RecordBatch) -> Tuple[np.ndarray, ...]:
        """One value array per *input* leaf (host)."""
        raise NotImplementedError

    def finish(self, merged: Tuple[torch.Tensor, ...]
               ) -> Dict[str, torch.Tensor]:
        """Merged accumulator leaves -> result columns (torch ops)."""
        raise NotImplementedError

    @property
    def input_leaves(self) -> Tuple[AccLeaf, ...]:
        """Leaves that take a per-record host value array."""
        return tuple(l for l in self.leaves if l.const is None)


class SumAggregate(AggregateFunction):
    def __init__(self, field: str, dtype=np.float32, output: str = None):
        self.field = field
        self.leaves = (AccLeaf("sum", dtype, "sum"),)
        self.output_names = (output or f"sum_{field}",)

    def map_input(self, batch):
        return (batch[self.field],)

    def finish(self, merged):
        return {self.output_names[0]: merged[0]}


class CountAggregate(AggregateFunction):
    def __init__(self, output: str = "count"):
        self.leaves = (AccLeaf("count", np.int32, "sum", const=1),)
        self.output_names = (output,)

    def map_input(self, batch):
        return ()

    def finish(self, merged):
        return {self.output_names[0]: merged[0]}


class MaxAggregate(AggregateFunction):
    def __init__(self, field: str, dtype=np.float32, output: str = None):
        self.field = field
        self.leaves = (AccLeaf("max", dtype, "max"),)
        self.output_names = (output or f"max_{field}",)

    def map_input(self, batch):
        return (batch[self.field],)

    def finish(self, merged):
        return {self.output_names[0]: merged[0]}


class MinAggregate(AggregateFunction):
    def __init__(self, field: str, dtype=np.float32, output: str = None):
        self.field = field
        self.leaves = (AccLeaf("min", dtype, "min"),)
        self.output_names = (output or f"min_{field}",)

    def map_input(self, batch):
        return (batch[self.field],)

    def finish(self, merged):
        return {self.output_names[0]: merged[0]}


class AvgAggregate(AggregateFunction):
    def __init__(self, field: str, output: str = None):
        self.field = field
        self.leaves = (
            AccLeaf("sum", np.float32, "sum"),
            AccLeaf("count", np.float32, "sum", const=1.0),
        )
        self.output_names = (output or f"avg_{field}",)

    def map_input(self, batch):
        return (batch[self.field],)

    def finish(self, merged):
        s, c = merged
        return {self.output_names[0]: s / torch.clamp(c, min=1.0)}
