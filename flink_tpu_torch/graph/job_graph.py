"""JobGraph: chained operator vertices + ExecutionGraph expansion (port of
``flink_tpu/graph/job_graph.py``).

reference: StreamingJobGraphGenerator.java:221 turns the StreamGraph into a
JobGraph by CHAINING operators that can share a task (isChainable:
one-to-one forward edge, same parallelism, no exchange between them), then
DefaultExecutionGraph expands every JobVertex into `parallelism`
ExecutionVertex subtasks, each owning a key-group range
(ExecutionJobVertex + KeyGroupRangeAssignment).

Re-design: chaining here decides *process/thread placement*, not code
fusion — within a chain, operators hand batches by direct Python calls,
so the JobGraph's job is to mark where the exchanges (key-group shuffles,
broadcasts, side-output routes) are and how many subtasks run each chain.
``EXPLAIN`` prints it (table/explain.py); ``to_json`` is the shape of the
reference's /jobs/:id/plan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from flink_tpu_torch.graph.transformations import StreamGraph, Transformation

#: how records travel along a JobEdge
FORWARD = "FORWARD"        # same subtask, direct call (chained boundary)
HASH = "HASH"              # key-group routed exchange
REBALANCE = "REBALANCE"    # round-robin redistribute (parallelism change)
BROADCAST = "BROADCAST"    # replicated to every consumer subtask
SIDE = "SIDE"              # side-output tagged route


@dataclasses.dataclass
class JobVertex:
    """A chain of transformations executed as one task."""

    vid: int
    chained: List[Transformation]
    parallelism: int
    #: key field when this vertex's head consumes a keyed exchange
    key_field: Optional[str] = None

    @property
    def name(self) -> str:
        return " -> ".join(t.name for t in self.chained)

    @property
    def head(self) -> Transformation:
        return self.chained[0]

    @property
    def tail(self) -> Transformation:
        return self.chained[-1]

    @property
    def is_source(self) -> bool:
        return self.head.kind == "source"


@dataclasses.dataclass
class JobEdge:
    source_vid: int
    target_vid: int
    ship: str                      # FORWARD | HASH | BROADCAST | SIDE
    key_field: Optional[str] = None
    side_tag: Optional[str] = None


@dataclasses.dataclass
class JobGraph:
    vertices: List[JobVertex]
    edges: List[JobEdge]

    def vertex_of(self, t: Transformation) -> JobVertex:
        for v in self.vertices:
            if any(c.uid == t.uid for c in v.chained):
                return v
        raise KeyError(t.name)

    def to_json(self) -> dict:
        """The REST /jobs/:id/plan shape (reference: JsonPlanGenerator)."""
        return {
            "nodes": [{
                "id": v.vid,
                "description": v.name,
                "parallelism": v.parallelism,
                "operators": [t.name for t in v.chained],
                **({"key_field": v.key_field} if v.key_field else {}),
            } for v in self.vertices],
            "edges": [{
                "source": e.source_vid,
                "target": e.target_vid,
                "ship_strategy": e.ship,
                **({"key_field": e.key_field} if e.key_field else {}),
                **({"side_tag": e.side_tag} if e.side_tag else {}),
            } for e in self.edges],
        }


def _resolve_parallelisms(graph: StreamGraph,
                          default_parallelism: int) -> Dict[int, int]:
    """uid -> effective subtask count. Explicit set_parallelism wins;
    keyed operators take parallelism.default (the key-group axis size);
    other one-input operators INHERIT their input's parallelism (a sink
    after a parallel aggregation runs in each subtask — the reference's
    operators default to env parallelism uniformly, with chaining keeping
    them co-located); sources and multi-input nodes default to 1."""
    out: Dict[int, int] = {}
    for t in graph.nodes:
        if t.parallelism:
            out[t.uid] = t.parallelism
        elif t.keyed:
            out[t.uid] = default_parallelism
        elif len(t.inputs) == 1:
            out[t.uid] = out[t.inputs[0].uid]
        else:
            out[t.uid] = 1
    # backward pass: a key_by routing marker without explicit parallelism
    # adopts its same-key consumer's (the reference has no keyBy operator
    # at all — partitioning is an edge property; the marker must not
    # force an extra exchange by disagreeing with the operator it feeds)
    for t in reversed(graph.nodes):
        if t.keyed and not t.parallelism:
            children = graph.children(t)
            if len(children) == 1 and children[0].keyed \
                    and children[0].key_field == t.key_field:
                out[t.uid] = out[children[0].uid]
    return out


def _partitioning(graph: StreamGraph) -> Dict[int, Optional[str]]:
    """uid -> key field the stream is hash-partitioned by AT THE OUTPUT of
    that transformation (None = arbitrary). A keyed transformation
    (re)partitions; one-to-one forward edges preserve the upstream
    partitioning (the reference's KeyedStream property, which is why
    key_by -> window_agg is ONE exchange, not two)."""
    part: Dict[int, Optional[str]] = {}
    for t in graph.nodes:
        if t.keyed:
            part[t.uid] = t.key_field
        elif len(t.inputs) == 1 and not t.broadcast \
                and t.side_tag is None:
            part[t.uid] = part.get(t.inputs[0].uid)
        else:
            part[t.uid] = None
    return part


def _edge_ship(child: Transformation,
               upstream_partition: Optional[str],
               same_parallelism: bool = True
               ) -> Tuple[str, Optional[str]]:
    if child.keyed:
        if upstream_partition == child.key_field and same_parallelism:
            # already partitioned by this key AND 1:1 subtasks — a
            # parallelism change re-shuffles even on the same key (the
            # consumer's key-group ranges differ)
            return FORWARD, None
        return HASH, child.key_field
    if child.broadcast:
        return BROADCAST, None
    if child.side_tag is not None:
        return SIDE, None
    if not same_parallelism:
        # N -> M subtasks cannot be one-to-one (reference renders
        # REBALANCE/RESCALE for parallelism changes)
        return REBALANCE, None
    return FORWARD, None


def is_chainable(graph: StreamGraph, up: Transformation,
                 down: Transformation, par: Dict[int, int],
                 upstream_partition: Optional[str],
                 respect_parallelism: bool = True) -> bool:
    """reference: StreamingJobGraphGenerator.isChainable — one-to-one
    forward edge, equal parallelism, single input on the downstream side."""
    if len(down.inputs) != 1 or len(graph.children(up)) != 1:
        return False
    # with respect_parallelism off (stage planning), per-operator
    # parallelism is advisory — stages get their counts from config, so
    # a same-key edge stays forward regardless of the advisory values
    same_par = (not respect_parallelism) or par[up.uid] == par[down.uid]
    ship, _ = _edge_ship(down, upstream_partition, same_parallelism=same_par)
    if ship != FORWARD:
        return False
    return same_par


def build_job_graph(graph: StreamGraph,
                    default_parallelism: int = 1,
                    respect_parallelism: bool = True) -> JobGraph:
    """Greedy chaining along topological order (each transformation joins
    its upstream's chain when chainable, else starts a new vertex).

    ``respect_parallelism=False`` chains across parallelism mismatches —
    the stage planner uses it because each stage's subtask count comes
    from config (source/stage parallelism), not per-operator settings."""
    part = _partitioning(graph)
    par = _resolve_parallelisms(graph, default_parallelism)
    vertex_of: Dict[int, JobVertex] = {}
    vertices: List[JobVertex] = []
    for t in graph.nodes:
        up = t.inputs[0] if len(t.inputs) == 1 else None
        if up is not None and up.uid in vertex_of and \
                vertex_of[up.uid].tail.uid == up.uid and \
                is_chainable(graph, up, t, par, part.get(up.uid),
                             respect_parallelism):
            v = vertex_of[up.uid]
            v.chained.append(t)
            if t.keyed and v.key_field is None:
                v.key_field = t.key_field
        else:
            v = JobVertex(vid=len(vertices), chained=[t],
                          parallelism=par[t.uid],
                          key_field=t.key_field if t.keyed else None)
            vertices.append(v)
        vertex_of[t.uid] = v
    edges: List[JobEdge] = []
    for t in graph.nodes:
        for inp in t.inputs:
            sv, tv = vertex_of[inp.uid], vertex_of[t.uid]
            if sv.vid == tv.vid:
                continue  # chained: direct call, no exchange
            ship, key = _edge_ship(
                t, part.get(inp.uid),
                same_parallelism=par[inp.uid] == par[t.uid])
            edges.append(JobEdge(sv.vid, tv.vid, ship, key, t.side_tag))
    return JobGraph(vertices, edges)


# ---------------------------------------------------------------------------
# ExecutionGraph: subtask expansion
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecutionVertex:
    """One subtask of a JobVertex (reference: ExecutionVertex — the unit
    Execution.deploy ships to a slot)."""

    vertex: JobVertex
    subtask_index: int
    #: inclusive key-group range owned by this subtask (None: not keyed)
    key_group_range: Optional[Tuple[int, int]] = None

    @property
    def name(self) -> str:
        return (f"{self.vertex.name} "
                f"({self.subtask_index + 1}/{self.vertex.parallelism})")


class ExecutionGraph:
    """JobGraph expanded subtask-by-subtask with key-group assignment
    (reference: DefaultExecutionGraph.attachJobGraph +
    KeyGroupRangeAssignment.computeKeyGroupRangeForOperatorIndex)."""

    def __init__(self, job_graph: JobGraph, max_parallelism: int = 128):
        from flink_tpu_torch.state.keygroups import compute_key_group_range

        self.job_graph = job_graph
        self.max_parallelism = max_parallelism
        self.execution_vertices: List[ExecutionVertex] = []
        for v in job_graph.vertices:
            for i in range(v.parallelism):
                kgr = None
                if v.key_field is not None:
                    kgr = compute_key_group_range(
                        max_parallelism, v.parallelism, i)
                self.execution_vertices.append(
                    ExecutionVertex(v, i, key_group_range=kgr))

    def subtasks_of(self, v: JobVertex) -> List[ExecutionVertex]:
        return [ev for ev in self.execution_vertices
                if ev.vertex.vid == v.vid]
