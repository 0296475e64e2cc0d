"""Transformation DAG and stream graph (port of
``flink_tpu/graph/transformations.py``): transformations carry operator
factories; the graph is a topologically ordered adjacency structure."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

_ids = itertools.count(1)


@dataclasses.dataclass
class Transformation:
    name: str
    kind: str  # 'source' | 'one_input' | 'sink'
    operator_factory: Optional[Callable[[], Any]] = None
    inputs: List["Transformation"] = dataclasses.field(default_factory=list)
    #: None = unset -> the executor applies `parallelism.default` to keyed
    #: operators
    parallelism: Optional[int] = None
    source: Any = None
    watermark_strategy: Any = None
    #: keyed-exchange marker: records are routed by key group after this
    keyed: bool = False
    key_field: Optional[str] = None
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))

    def __hash__(self):
        return self.uid


class StreamGraph:
    """Topologically-ordered view of the transformation DAG."""

    def __init__(self, transformations: Sequence[Transformation]):
        self.nodes: List[Transformation] = self._topo_sort(transformations)
        self.downstream: Dict[int, List[Transformation]] = {}
        for t in self.nodes:
            for inp in t.inputs:
                self.downstream.setdefault(inp.uid, []).append(t)

    @staticmethod
    def _topo_sort(sinks: Sequence[Transformation]) -> List[Transformation]:
        seen: Dict[int, Transformation] = {}
        order: List[Transformation] = []

        def visit(t: Transformation):
            if t.uid in seen:
                return
            seen[t.uid] = t
            for inp in t.inputs:
                visit(inp)
            order.append(t)

        for s in sinks:
            visit(s)
        return order

    @property
    def sources(self) -> List[Transformation]:
        return [t for t in self.nodes if t.kind == "source"]

    def children(self, t: Transformation) -> List[Transformation]:
        return self.downstream.get(t.uid, [])

    def input_index(self, parent: Transformation,
                    child: Transformation) -> int:
        return [i.uid for i in child.inputs].index(parent.uid)
