"""Vectorized aggregate functions (port of
``flink_tpu/windowing/aggregates.py``).

An aggregate declares its accumulator as a tuple of *leaves* — flat device
planes, one per accumulator component — each with a scatter-reduce kind.
``add`` over a micro-batch is one in-place scatter per leaf, ``merge``
across window slices a gather + reduce over the slice axis, and
``finish`` maps merged leaves to result columns with torch ops. The
single-device engine's programs (``stateplane/families.py``) are reached
through the ``_*_jit`` hooks, under the reference's names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.ops.segment_ops import (
    SCATTER_METHOD,
    identity_for,
    pad_values,
    torch_dtype,
)
from flink_tpu_torch.stateplane import families as _families
from flink_tpu_torch.stateplane.fold import nan_bits


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

    def cache_key(self) -> tuple:
        """Identity of the programs this aggregate needs: two aggregates
        with equal keys share them. Includes every primitive instance
        attribute, so that a parameter ``finish`` reads is part of it."""
        params = tuple(
            (k, v) for k, v in sorted(vars(self).items())
            if isinstance(v, (str, int, float, bool, bytes, tuple)))
        return (type(self).__module__, type(self).__qualname__,
                self.leaves, self.output_names, params)

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

    def init_accumulators(self, capacity: int, device
                          ) -> Tuple[torch.Tensor, ...]:
        """One flat ``[capacity]`` identity-filled tensor per leaf."""
        return tuple(
            torch.full((capacity,), np.asarray(leaf.identity).item(),
                       dtype=torch_dtype(leaf.dtype), device=device)
            for leaf in self.leaves)

    def map_input_valued(self, batch: RecordBatch) -> Tuple[np.ndarray, ...]:
        """One value array per leaf with const leaves materialized (local
        pre-aggregation folds every leaf from explicit values)."""
        vit = iter(self.map_input(batch))
        out = []
        for leaf in self.leaves:
            if leaf.const is not None:
                out.append(np.full(len(batch), leaf.const, dtype=leaf.dtype))
            else:
                out.append(np.asarray(next(vit), dtype=leaf.dtype))
        return tuple(out)

    @property
    def retractable(self) -> bool:
        """True when every accumulator leaf folds by addition: a changelog
        retraction is then the scatter of the row's negated contribution.
        MAX/MIN leaves are not retractable."""
        return all(l.reduce == "sum" for l in self.leaves)

    def map_input_signed(self, batch: RecordBatch,
                         signs: np.ndarray) -> Tuple[np.ndarray, ...]:
        """One SIGNED value array per leaf (const leaves materialized):
        +v for accumulate rows, -v for retraction rows."""
        return tuple(v * signs.astype(v.dtype)
                     for v in self.map_input_valued(batch))

    def pad_input_values(self, values: Sequence[np.ndarray], size: int
                         ) -> Tuple[np.ndarray, ...]:
        """Pad the value arrays of the input leaves to ``size`` with each
        leaf's identity (const leaves are broadcast on the device)."""
        return tuple(
            pad_values(np.asarray(v, dtype=l.dtype), size, l.identity)
            for v, l in zip(values, self.input_leaves))

    # -- the single-device engine's programs (stateplane/families.py) -------

    @property
    def _scatter_jit(self):
        return _families.flat_scatter_combine(self.leaves)

    @property
    def _scatter_valued_jit(self):
        return _families.flat_scatter_valued(self.leaves)

    @property
    def _scatter_signed_jit(self):
        """The retraction fold (every leaf valued and sign-applied); only
        retractable aggregates have one."""
        if not self.retractable:
            raise TypeError(
                f"{type(self).__name__} is not retractable (non-additive "
                "accumulator leaf); an updating input cannot be folded")
        return _families.flat_scatter_signed(self.leaves)

    @property
    def _fire_jit(self):
        return _families.flat_segment_fire(self)

    def _fire_project_jit(self, projector):
        return _families.flat_segment_fire_projected(self, projector)

    @property
    def _merge_jit(self):
        return _families.flat_segment_merge(self.leaves)

    @property
    def _gather_jit(self):
        return _families.flat_gather(self.leaves)

    @property
    def _put_jit(self):
        return _families.flat_put(self.leaves)

    @property
    def _reset_jit(self):
        return _families.flat_reset(self.leaves)


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
        c = torch.clamp(c, min=1.0)
        # the CPU's (x86) NaN rule, the reference's bits, which the card's
        # divide (its canonical NaN) does not keep: a NaN operand comes
        # out quieted, the dividend's first; an invalid divide (inf/inf)
        # gives the default NaN
        q = s / c
        q = torch.where(torch.isnan(q), nan_bits(q, quiet=False), q)
        q = torch.where(torch.isnan(c), nan_bits(c, quiet=True), q)
        return {self.output_names[0]: torch.where(
            torch.isnan(s), nan_bits(s, quiet=True), q)}


class MultiAggregate(AggregateFunction):
    """Several aggregates over the same key and window in one state table:
    one scatter pass, one presence plane, several result columns."""

    def __init__(self, aggs: Sequence[AggregateFunction]):
        self.aggs = list(aggs)
        leaves: List[AccLeaf] = []
        outs: List[str] = []
        self._spans = []
        for i, a in enumerate(self.aggs):
            start = len(leaves)
            leaves.extend(AccLeaf(f"a{i}_{l.name}", l.dtype, l.reduce, l.const)
                          for l in a.leaves)
            self._spans.append((start, len(leaves)))
            outs.extend(a.output_names)
        self.leaves = tuple(leaves)
        self.output_names = tuple(outs)

    def cache_key(self):
        return ("multi", tuple(a.cache_key() for a in self.aggs))

    def map_input(self, batch):
        vals: List[np.ndarray] = []
        for a in self.aggs:
            vals.extend(a.map_input(batch))
        return tuple(vals)

    def finish(self, merged):
        out: Dict[str, torch.Tensor] = {}
        for a, (s, e) in zip(self.aggs, self._spans):
            out.update(a.finish(tuple(merged[s:e])))
        return out
