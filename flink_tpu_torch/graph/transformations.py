"""Transformation DAG and stream graph (port of
``flink_tpu/graph/transformations.py``): transformations carry operator
factories; the graph is a topologically ordered adjacency structure."""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

_ids = itertools.count(1)


@dataclasses.dataclass
class Transformation:
    name: str
    kind: str  # 'source' | 'one_input' | 'two_input' | 'sink'
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
    #: side-output edge: this node consumes only TaggedBatches with this
    #: tag (OutputTag, DataStream.get_side_output)
    side_tag: Optional[str] = None
    #: broadcast edge: every parallel instance sees every record
    broadcast: bool = False
    #: slot sharing group (DataStream.slot_sharing_group); None inherits
    #: the first input's
    slot_group: Optional[str] = None
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

    def slot_groups(self) -> Dict[int, str]:
        """uid -> resolved slot sharing group: an unset group inherits
        the (first) input's, sources default to "default"."""
        out: Dict[int, str] = {}
        for t in self.nodes:
            if t.slot_group is not None:
                out[t.uid] = t.slot_group
            elif t.inputs:
                out[t.uid] = out[t.inputs[0].uid]
            else:
                out[t.uid] = "default"
        return out

    def distinct_slot_groups(self) -> List[str]:
        seen: List[str] = []
        for g in self.slot_groups().values():
            if g not in seen:
                seen.append(g)
        return seen

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

    def stable_id(self, t: Transformation) -> str:
        """Process-independent operator identity for checkpoints:
        topological position + sanitized name — the key of the
        operator's state in a checkpoint, the reference's string exactly.
        Used as a filename component, so path-hostile characters are
        replaced."""
        safe = re.sub(r"[^A-Za-z0-9_.()-]", "_", t.name)
        return f"{self.nodes.index(t)}:{safe}"

    def children(self, t: Transformation) -> List[Transformation]:
        return self.downstream.get(t.uid, [])

    def input_index(self, parent: Transformation,
                    child: Transformation) -> int:
        return [i.uid for i in child.inputs].index(parent.uid)
