"""Stage-parallel execution: ExecutionGraph-style subtask expansion (port
of ``flink_tpu/cluster/stage_executor.py``, behind
``execution.stage-parallelism``).

reference: the reference expands every JobVertex into `parallelism`
ExecutionVertex subtasks (executiongraph/DefaultExecutionGraph.java,
Execution.java:572 deploy()), routes records between them by key group
(streaming/runtime/partitioner/KeyGroupStreamPartitioner.java:55), and
aligns checkpoint barriers across input channels
(streaming/runtime/io/checkpointing/SingleCheckpointBarrierHandler.java).

The job splits into pipelined stages, each subtask a thread —

  source stage (S subtasks): source + chained stateless operators;
    each output batch is partitioned by key group into one sub-batch per
    keyed subtask and emitted through the shuffle SPI
    (runtime/shuffle_spi.py — pluggable transport, credit-based flow
    control), optionally pre-aggregated by ``LocalWindowCombiner``
    (``execution.local-agg``).
  keyed stages (N subtasks each): the keyed operator chain + sink; each
    subtask owns a key-group range and runs its own engine instance on
    the job's device. Watermarks combine per channel (min across
    channels); checkpoint barriers align (channels that delivered the
    barrier are buffered until all have), or with
    ``execution.checkpointing.unaligned`` overtake queued data, which is
    persisted as channel state.

Checkpoints: a coordinator (the run() thread) triggers sources, collects
the acks, MERGES the per-subtask operator states into the logical format
the single-slot executor writes (key-group-indexed rows), and commits the
manifest — so multi-slot checkpoints restore into single-slot jobs, other
subtask counts (key-group re-filtering), and the other way round.

Mesh x stage on one card: ``execution.stage-mesh-devices = D`` opens each
keyed subtask's engine over D logical shards of its own key-group range,
as ``[D, cap]`` planes on the job's device (the reference's sub-mesh of D
chips; the port does not clamp D to a device count). The subtasks' device
programs run from their threads on one card, each on the current stream.

``run(cancel_event=)`` cancels the job from outside: the coordinator's
``cancelled`` event stops every subtask, and ``run`` raises
``JobCancelledError`` (also from a checkpoint's wait).

Point queries: a ``StateQueryBatchRequest`` is routed to the owning keyed
subtasks by key group, one control message per owner; each owner serves
its part on its own thread between batches, through its operator's
``query_state_batch`` (one gather, one device-to-host copy).
"""

from __future__ import annotations

import os
import queue as _q
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.core.config import (
    BatchOptions,
    CheckpointOptions,
    Configuration,
    CoreOptions,
    DeploymentOptions,
    ExecutionModeOptions,
    MemoryOptions,
    StateOptions,
    check_unread_keys,
    retained_checkpoints,
)
from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.cluster.local_executor import (
    JobCancelledError,
    LocalExecutor,
    operator_context,
)
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.graph.transformations import StreamGraph, Transformation
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.runtime.operators import OperatorContext
from flink_tpu_torch.runtime.shuffle_spi import (
    END_OF_PARTITION,
    Barrier,
    LocalShuffleService,
    create_shuffle_service,
)
from flink_tpu_torch.runtime.elements import MAX_WATERMARK
from flink_tpu_torch.state.keygroups import (
    assign_key_groups,
    compute_key_group_range,
    key_group_to_operator_index,
)

__all__ = ["StagePlan", "StagePlanError", "StageParallelExecutor",
           "plan_stages", "merge_subtask_states"]


class StagePlanError(ValueError):
    """The graph shape is not supported by stage-parallel execution."""


class StageInput:
    """One input branch of the keyed stage: a source, its chained
    stateless pre-operators (incl. the key_by routing marker), and the
    key field records are hash-exchanged on."""

    def __init__(self, source: Transformation,
                 pre_chain: List[Transformation], key_field: str):
        self.source = source
        self.pre_chain = pre_chain
        self.key_field = key_field


class OutSpec:
    """One outgoing keyed exchange of a producer (a source or a keyed
    stage): optional stateless branch transformations applied in the
    producer subtask (key_by routing markers, maps after a fan-out
    point), then records hash-route on ``key_field`` to ``target_input``
    of stage ``target_stage``."""

    def __init__(self, key_field: str, target_stage: int,
                 target_input: int = 0,
                 branch: Optional[List[Transformation]] = None):
        self.key_field = key_field
        self.target_stage = target_stage
        self.target_input = target_input
        self.branch = branch or []


class SourceSpec:
    """One physical source: the source transformation, its chained
    stateless pre-operators (shared by every output), and the outgoing
    exchanges. Fan-out (multiple outputs) duplicates the stream to every
    exchange — one subtask reads the split once and routes it everywhere
    (reference: a source vertex with multiple output JobEdges)."""

    def __init__(self, source: Transformation,
                 chain: List[Transformation], outputs: List[OutSpec]):
        self.source = source
        self.chain = chain
        self.outputs = outputs

    @property
    def transformations(self) -> List[Transformation]:
        out = list(self.chain)
        for o in self.outputs:
            out.extend(o.branch)
        return out


class KeyedStage:
    """One keyed stage of the DAG: the main operator chain (head is the
    key_by routing marker or a two-input keyed op), optional side-output
    branches executed in the same subtask, and the outgoing exchanges
    (empty = terminal, the chain ends in the sink)."""

    def __init__(self, chain: List[Transformation],
                 side_chains: Optional[
                     List[Tuple[str, List[Transformation]]]] = None,
                 num_inputs: int = 1,
                 outputs: Optional[List[OutSpec]] = None):
        self.chain = chain
        #: (tag, chain) branches fed by TaggedBatch outputs of main-chain
        #: operators; stateless + sink, run inside each subtask
        self.side_chains = side_chains or []
        self.num_inputs = num_inputs
        self.outputs = outputs or []

    @property
    def out_key_field(self) -> Optional[str]:
        return self.outputs[0].key_field if self.outputs else None

    @property
    def operator_transformations(self) -> List[Transformation]:
        out = list(self.chain)
        for _, sc in self.side_chains:
            out.extend(sc)
        for o in self.outputs:
            out.extend(o.branch)
        return out


class StagePlan:
    """Source(s) + keyed stages connected by hash exchanges, as a DAG
    (reference: DefaultExecutionGraph runs any DAG at any per-vertex
    parallelism). Supported: any number of physical sources with output
    fan-out, chains of keyed exchanges, one- and two-input keyed stages
    (joins — fed by sources and/or upstream stages, Q7's diamond), and
    side-output branches."""

    def __init__(self, source_specs: List[SourceSpec],
                 stages: List[KeyedStage]):
        #: one per physical source
        self.source_specs = source_specs
        #: keyed stages in topological order; terminal stages end in sinks
        self.stages = stages

    # -- single-input / single-stage compat views (the linear pipeline's
    # -- and the two-input join's vocabulary, kept for callers/tests)
    @property
    def inputs(self) -> List[StageInput]:
        outs = []
        for spec in self.source_specs:
            for o in spec.outputs:
                if o.target_stage == 0:
                    outs.append((o.target_input, StageInput(
                        spec.source, spec.chain + o.branch, o.key_field)))
        outs.sort(key=lambda x: x[0])
        return [si for _, si in outs]

    @property
    def source(self) -> Transformation:
        return self.source_specs[0].source

    @property
    def pre_chain(self) -> List[Transformation]:
        return self.inputs[0].pre_chain

    @property
    def key_field(self) -> str:
        return self.inputs[0].key_field

    @property
    def keyed_chain(self) -> List[Transformation]:
        return self.stages[0].chain


def plan_stages(graph: StreamGraph) -> StagePlan:
    """Derive the stage DAG from the chained JobGraph
    (flink_tpu/graph/job_graph.py — the StreamingJobGraphGenerator role).

    Supported shapes: any DAG of physical sources (with output fan-out)
    and keyed stages connected by hash exchanges — linear pipelines,
    chains of keyed exchanges (agg -> re-key -> agg), one- and two-input
    keyed stages (joins fed by sources and/or upstream stages, incl.
    Q7's diamond), and side-output branches off keyed stages (stateless
    + sink, executed inside the owning subtask). A ``key_by`` routing
    marker that could not chain into a two-input consumer becomes a
    ROUTING vertex: its chain runs producer-side and its key names the
    exchange (the reference's partitioner-on-the-edge model). Raises
    StagePlanError for anything else (broadcast edges, rebalance,
    exchange unions) — callers fall back to single-slot execution when
    configured to."""
    from flink_tpu_torch.graph.job_graph import FORWARD, HASH, SIDE, \
        build_job_graph
    from flink_tpu_torch.runtime.operators import KeyByOperator

    jg = build_job_graph(graph, default_parallelism=1,
                         respect_parallelism=False)
    if not any(e.ship == HASH for e in jg.edges):
        raise StagePlanError("no keyed exchange — nothing to expand")
    out_edges: Dict[int, List] = {v.vid: [] for v in jg.vertices}
    in_edges: Dict[int, List] = {v.vid: [] for v in jg.vertices}
    for e in jg.edges:
        out_edges[e.source_vid].append(e)
        in_edges[e.target_vid].append(e)

    def _is_routing_vertex(v) -> bool:
        """A key_by marker vertex whose single consumer is a two-input
        stage: it exists only because markers cannot chain into a
        multi-input head — its chain runs producer-side."""
        if v.is_source or v.head.kind == "two_input":
            return False
        if not v.head.keyed or v.head.key_field is None:
            return False
        probe = (v.head.operator_factory()
                 if v.head.operator_factory else None)
        if not isinstance(probe, KeyByOperator):
            return False
        cons = out_edges[v.vid]
        return len(cons) == 1 and \
            jg.vertices[cons[0].target_vid].head.kind == "two_input"

    routing = {v.vid: v for v in jg.vertices if _is_routing_vertex(v)}
    # stage heads: every vertex entered through a hash exchange that is
    # not a routing vertex, in topological (vid) order
    stage_heads = []
    for v in jg.vertices:
        if v.is_source or v.vid in routing:
            continue
        ins = in_edges[v.vid]
        if ins and all(e.ship == HASH for e in ins):
            if not (v.head.keyed or v.head.kind == "two_input"):
                raise StagePlanError(
                    f"exchange target [{v.name}] does not start at a "
                    "keyed operator — only keyed stages shard by key "
                    "group")
            stage_heads.append(v)
    stage_index = {v.vid: m for m, v in enumerate(stage_heads)}
    used: set = set(routing)

    def _resolve_exchange(e) -> OutSpec:
        """A HASH (or partition-preserving FORWARD) edge out of a
        producer -> the OutSpec it denotes: either directly into a
        one-input stage head, or through a routing vertex into one input
        of a two-input stage."""
        tv = jg.vertices[e.target_vid]
        if tv.vid in routing:
            kv2 = jg.vertices[out_edges[tv.vid][0].target_vid]
            if kv2.vid not in stage_index:
                raise StagePlanError(
                    f"routing vertex [{tv.name}] feeds [{kv2.name}], "
                    "which is not a keyed stage")
            idx = next((i for i, it in enumerate(kv2.head.inputs)
                        if it.uid == tv.tail.uid), None)
            if idx is None:
                raise StagePlanError(
                    f"routing vertex [{tv.name}] is not an input of "
                    f"[{kv2.name}]")
            return OutSpec(e.key_field or tv.head.key_field,
                           stage_index[kv2.vid], idx,
                           branch=list(tv.chained))
        if tv.vid in stage_index:
            if tv.head.kind == "two_input":
                raise StagePlanError(
                    f"two-input stage [{tv.name}] must be fed through "
                    "key_by routing vertices (one per input)")
            if e.key_field is None:
                raise StagePlanError(
                    f"keyed exchange into [{tv.name}] has no key field")
            return OutSpec(e.key_field, stage_index[tv.vid], 0)
        raise StagePlanError(
            f"unsupported exchange target [{tv.name}]")

    def _walk_outputs(head_v):
        """From a stage head, absorb FORWARD continuations into the
        chain and SIDE branches into side_chains; every HASH edge (and
        FORWARD edge into a routing vertex) becomes an outgoing
        exchange. Returns (chain, side_chains, outputs)."""
        chain = list(head_v.chained)
        side_chains: List[Tuple[str, List[Transformation]]] = []
        exchange_edges = []
        cur = head_v
        used.add(cur.vid)
        while True:
            outs = out_edges[cur.vid]
            fwd, side, hashed, other = [], [], [], []
            for e in outs:
                if e.ship == HASH or (
                        e.ship == FORWARD and e.target_vid in routing):
                    hashed.append(e)
                elif e.ship == FORWARD:
                    fwd.append(e)
                elif e.ship == SIDE:
                    side.append(e)
                else:
                    other.append(e)
            if other:
                raise StagePlanError(
                    f"unsupported exchange {other[0].ship} out of "
                    f"[{cur.name}]")
            for e in side:
                sv = jg.vertices[e.target_vid]
                if out_edges[sv.vid]:
                    raise StagePlanError(
                        f"side-output branch [{sv.name}] must end in a "
                        "sink (no further exchanges)")
                if sv.tail.kind != "sink":
                    raise StagePlanError(
                        f"side-output branch [{sv.name}] must end in a "
                        "sink")
                if any(t.keyed for t in sv.chained):
                    raise StagePlanError(
                        f"side-output branch [{sv.name}] re-keys — "
                        "keyed side branches are not supported in stage "
                        "mode")
                used.add(sv.vid)
                side_chains.append((sv.head.side_tag, sv.chained))
            exchange_edges.extend(hashed)
            if len(fwd) > 1:
                raise StagePlanError(
                    f"[{cur.name}] has multiple forward continuations — "
                    "not a supported DAG shape")
            if fwd:
                cur = jg.vertices[fwd[0].target_vid]
                used.add(cur.vid)
                chain.extend(cur.chained)
                continue
            break
        return chain, side_chains, [
            _resolve_exchange(e) for e in exchange_edges]

    # physical sources
    source_specs: List[SourceSpec] = []
    for v in jg.vertices:
        if not v.is_source:
            continue
        chain, side_chains, outputs = _walk_outputs(v)
        if side_chains:
            raise StagePlanError(
                f"side outputs on the source stage [{v.name}] are not "
                "supported — move the split after the keyed exchange")
        if not outputs:
            raise StagePlanError(
                f"source [{v.name}] feeds no keyed exchange")
        if chain[-1].kind == "sink":
            raise StagePlanError(
                f"source stage [{v.name}] ends in a sink — nothing to "
                "expand on that branch")
        source_specs.append(SourceSpec(v.head, chain[1:], outputs))

    # keyed stages
    stages: List[KeyedStage] = []
    for m, head_v in enumerate(stage_heads):
        chain, side_chains, outputs = _walk_outputs(head_v)
        num_inputs = 2 if head_v.head.kind == "two_input" else 1
        if num_inputs == 1 and len(in_edges[head_v.vid]) != 1:
            raise StagePlanError(
                f"stage [{head_v.name}] has {len(in_edges[head_v.vid])} "
                "producers — unioning exchanges into one keyed input is "
                "not supported")
        if not outputs and chain[-1].kind != "sink":
            raise StagePlanError("pipeline must end in a sink")
        stages.append(KeyedStage(chain, side_chains=side_chains,
                                 num_inputs=num_inputs, outputs=outputs))
    if not stages:
        raise StagePlanError("no keyed stage")

    # every stage input must be fed exactly once
    feeds: Dict[Tuple[int, int], int] = {}
    for spec in source_specs:
        for o in spec.outputs:
            feeds[(o.target_stage, o.target_input)] = feeds.get(
                (o.target_stage, o.target_input), 0) + 1
    for m, stage in enumerate(stages):
        for o in stage.outputs:
            if o.target_stage <= m:
                raise StagePlanError(
                    "exchange cycles are not supported")
            feeds[(o.target_stage, o.target_input)] = feeds.get(
                (o.target_stage, o.target_input), 0) + 1
    for m, stage in enumerate(stages):
        for i in range(stage.num_inputs):
            if feeds.get((m, i), 0) != 1:
                raise StagePlanError(
                    f"stage {m} input {i} is fed by "
                    f"{feeds.get((m, i), 0)} exchanges (must be exactly "
                    "one)")

    # every vertex must be part of the plan — an unreachable/unsupported
    # branch must fail, not silently drop
    missing = [v for v in jg.vertices if v.vid not in used]
    if missing:
        raise StagePlanError(
            "graph has vertices outside the supported source -> keyed-"
            "stage DAG shape: "
            + "; ".join(f"[{v.name}]" for v in missing))
    return StagePlan(source_specs, stages)


# ---------------------------------------------------------------------------
# state merge (per-subtask -> logical single-slot format)
# ---------------------------------------------------------------------------


def _merge_changelog(values: List[Dict[str, Any]]) -> Dict[str, Any]:
    """GroupAgg changelog rows: concatenate, with per-subtask 'last' column
    sets unioned — a subtask that has not emitted yet has no last-image
    columns, and its rows (all emitted=False) get identity fill."""
    kid = [np.asarray(v["key_id"]) for v in values]
    cols = set()
    for v in values:
        cols.update(v.get("last", {}).keys())
    last: Dict[str, np.ndarray] = {}
    for c in sorted(cols):
        dt = next(np.asarray(v["last"][c]).dtype for v in values
                  if c in v.get("last", {}))
        last[c] = np.concatenate([
            np.asarray(v["last"][c]) if c in v.get("last", {})
            else np.zeros(len(k), dtype=dt)
            for v, k in zip(values, kid)])
    return {
        "key_id": np.concatenate(kid),
        "count": np.concatenate([np.asarray(v["count"]) for v in values]),
        "emitted": np.concatenate([np.asarray(v["emitted"])
                                   for v in values]),
        "dirty": np.concatenate([
            np.asarray(v.get("dirty", np.zeros(len(k), bool)))
            for v, k in zip(values, kid)]),
        "last": last,
    }


def _merge_values(key: str, values: List[Any]):
    """Merge one state field across subtasks by its semantic kind.

    Event-time progress merges to the LEAST subtask's: an unaligned
    barrier overtakes queued watermarks, so subtasks snapshot at
    different watermarks, and the channel state of the one behind holds
    records of windows that the others have fired. Restored at the
    greatest watermark those records would replay late and be dropped;
    at the least, a subtask that had fired a window re-fires it over no
    rows (its slices were freed). Aligned barriers cut every subtask at
    the same watermark, where least and greatest agree."""
    if key in ("watermark", "max_fired_end", "max_fired_watermark"):
        return min(values)
    if key in ("max_ts", "next_sid"):
        return max(values)
    if key == "late_records_dropped":
        return sum(values)
    if key == "keys_hashed":
        return any(values)
    if key == "pending":
        return sorted({x for v in values for x in v})
    if key in ("um_keys", "um_rows"):
        # upsert-materializer images: key-disjoint lists across subtasks
        return [x for v in values for x in v]
    if key in ("slice_last_window", "sessions", "key_values"):
        merged: Dict = {}
        for v in values:
            merged.update(v)
        return merged
    if key == "changelog":
        return _merge_changelog(values)
    if key in ("left", "right"):
        # interval-join side buffers: lists of column dicts, key-group
        # disjoint across subtasks — union by concatenating the lists
        return [c for v in values for c in v]
    if key == "buf":
        # window-join per-slice side buffers: {slice_end: ([left column
        # dicts], [right column dicts])} — union per slice end
        out: Dict[int, Tuple[List, List]] = {}
        for v in values:
            for se, (l, r) in v.items():
                cur = out.setdefault(se, ([], []))
                cur[0].extend(l)
                cur[1].extend(r)
        return out
    if isinstance(values[0], np.ndarray):
        return np.concatenate([np.asarray(v) for v in values])
    if isinstance(values[0], dict):
        # dict-of-arrays (table leaves) / nested metadata: merge per field
        return {sub: _merge_values(sub, [v[sub] for v in values])
                for sub in values[0]}
    # scalars expected identical (e.g. format flags)
    return values[0]


def merge_subtask_states(states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Union the per-subtask snapshots of ONE operator into the logical
    single-slot format. Table rows (key-group disjoint across subtasks)
    concatenate; metadata merges by kind (least watermarks, union
    dicts)."""
    states = [s for s in states if s]
    if not states:
        return {}
    if len(states) == 1:
        return states[0]
    return {k: _merge_values(k, [s[k] for s in states])
            for k in states[0]}


# ---------------------------------------------------------------------------
# subtasks
# ---------------------------------------------------------------------------


class _SubtaskFailure(Exception):
    pass


class _SharedSink:
    """Thread-safe facade over ONE sink instance shared by N keyed
    subtasks: writes serialize under a lock, and the underlying sink opens
    once / closes only when the last subtask closes (the reference deploys
    a sink INSTANCE per subtask; collect-style sinks here aggregate in one
    object, so sharing + refcounting is the honest equivalent)."""

    def __init__(self, sink):
        self._sink = sink
        self._lock = threading.Lock()
        self._opens = 0
        self._closes = 0
        self._closed = False

    def open(self, subtask_index: int = 0) -> None:
        with self._lock:
            if self._opens == 0:
                self._sink.open(0)
            self._opens += 1

    def write(self, batch) -> None:
        with self._lock:
            self._sink.write(batch)

    def close(self) -> None:
        with self._lock:
            self._closes += 1
            if self._closes >= self._opens and not self._closed:
                self._closed = True
                self._sink.close()

    def __getattr__(self, name):
        return getattr(self._sink, name)


class _OperatorChain:
    """The fused operator chain of one subtask (reference: OperatorChain —
    direct method-call hand-off between chained operators).

    ``side_chains`` maps side-output tags to branch chains run in the same
    subtask: a TaggedBatch emitted by any main-chain operator is diverted
    to the matching branch (reference: OutputTag routing in OperatorChain)
    instead of continuing down the main chain. process_batch /
    process_watermark / close RETURN the batches that survive past the
    last main-chain operator — empty when the tail is a sink, the
    downstream-exchange payload for intermediate keyed stages."""

    def __init__(self, transformations: Sequence[Transformation],
                 ctx: OperatorContext,
                 shared_sinks: Optional[Dict[int, _SharedSink]] = None,
                 side_chains: Optional[
                     List[Tuple[str, Sequence[Transformation]]]] = None):
        self.transformations = list(transformations)
        self.operators = []
        self._shared_sinks = shared_sinks
        for t in self.transformations:
            self.operators.append(self._make_operator(t, ctx))
        self.side_chains: Dict[str, _OperatorChain] = {}
        for tag, sc in (side_chains or []):
            self.side_chains[tag] = _OperatorChain(
                sc, ctx, shared_sinks=shared_sinks)

    def _make_operator(self, t: Transformation, ctx: OperatorContext):
        op = t.operator_factory() if t.operator_factory else None
        if op is not None:
            if self._shared_sinks is not None and hasattr(op, "sink"):
                # every subtask's factory captured the same sink
                # object — route all of them through one refcounted,
                # locked facade (see _SharedSink)
                op.sink = self._shared_sinks.setdefault(
                    t.uid, _SharedSink(op.sink))
            op.open(ctx)
        return op

    def _route(self, outs: List) -> List[RecordBatch]:
        """Divert TaggedBatch outputs to their side branch; return the
        main-stream batches."""
        from flink_tpu_torch.runtime.process import TaggedBatch

        main: List[RecordBatch] = []
        for b in outs:
            if isinstance(b, TaggedBatch):
                branch = self.side_chains.get(b.tag.name)
                if branch is not None:
                    branch.process_batch(b.batch)
                # unmatched tags drop, like the single-slot router
            else:
                main.append(b)
        return main

    def process_batch(self, batch: RecordBatch,
                      input_index: int = 0) -> List[RecordBatch]:
        outs = [batch]
        head = True
        for op in self.operators:
            if op is None:
                continue
            nxt: List[RecordBatch] = []
            for b in outs:
                # only the chain HEAD can be multi-input (a two-input
                # keyed op); everything downstream consumes its single
                # output stream
                nxt.extend(op.process_batch(b, input_index if head else 0))
            head = False
            outs = self._route(nxt)
            if not outs:
                break
        return outs

    def process_watermark(self, wm: int) -> List[RecordBatch]:
        """Advance the watermark through the chain; batches an operator
        fires are fed to the operators AFTER it (then the watermark), and
        whatever survives past the tail is returned."""
        carried: List[RecordBatch] = []
        for op in self.operators:
            if op is None:
                continue
            nxt: List[RecordBatch] = []
            for b in carried:
                nxt.extend(op.process_batch(b))
            nxt.extend(op.process_watermark(wm))
            carried = self._route(nxt)
        return carried

    @property
    def uses_processing_time(self) -> bool:
        return any(getattr(op, "uses_processing_time", False)
                   for op in self.operators if op is not None)

    def tick_processing_time(self, now_ms: int, emit=None) -> None:
        """Wall-clock tick: fire processing-time windows/timers and push
        their output through the rest of the chain. ``emit`` receives
        batches that survive past the LAST operator (source-stage chains
        end at the keyed exchange, not a sink)."""
        for i, op in enumerate(self.operators):
            if op is None or not getattr(op, "uses_processing_time", False):
                continue
            outs = op.on_processing_time(now_ms)
            for out in outs:
                cur = [out]
                for op2 in self.operators[i + 1:]:
                    if op2 is None:
                        continue
                    nxt: List[RecordBatch] = []
                    for b in cur:
                        nxt.extend(op2.process_batch(b))
                    cur = self._route(nxt)
                    if not cur:
                        break
                if emit is not None:
                    for b in cur:
                        emit(b)

    def close(self) -> List[RecordBatch]:
        carried: List[RecordBatch] = []
        for op in self.operators:
            if op is None:
                continue
            nxt: List[RecordBatch] = []
            for b in carried:
                nxt.extend(op.process_batch(b))
            nxt.extend(op.close())
            carried = self._route(nxt)
        for branch in self.side_chains.values():
            branch.close()
        return carried

    def dispose(self) -> None:
        for op in self.operators:
            if op is not None:
                try:
                    op.dispose()
                except Exception:
                    pass
        for branch in self.side_chains.values():
            branch.dispose()

    def snapshot(self, graph: StreamGraph, savepoint: bool = False
                 ) -> Dict[str, Any]:
        snap = {}
        for t, op in zip(self.transformations, self.operators):
            if op is None:
                continue
            if savepoint and hasattr(op, "snapshot_state_savepoint"):
                state = op.snapshot_state_savepoint()
            else:
                state = op.snapshot_state()
            if state:
                snap[graph.stable_id(t)] = state
        for branch in self.side_chains.values():
            snap.update(branch.snapshot(graph, savepoint=savepoint))
        return snap

    def restore(self, graph: StreamGraph, states: Dict[str, Any],
                key_group_filter=None) -> None:
        for branch in self.side_chains.values():
            branch.restore(graph, states, key_group_filter=key_group_filter)
        for t, op in zip(self.transformations, self.operators):
            if op is None:
                continue
            state = states.get(graph.stable_id(t))
            if state is None:
                continue
            if key_group_filter is None:
                op.restore_state(state)
                continue
            import inspect

            sig = inspect.signature(op.restore_state)
            if "key_group_filter" not in sig.parameters:
                # restoring the FULL merged state into every subtask would
                # silently duplicate keyed state (N× timer fires, N×
                # emissions) — fail precisely instead
                raise RuntimeError(
                    f"operator {t.name!r} ({type(op).__name__}) does not "
                    "support key-group-filtered restore; it cannot be "
                    "restored in stage-parallel mode (reference: keyed "
                    "state restore is key-group-range scoped)")
            op.restore_state(state, key_group_filter=key_group_filter)


def _local_combiner_factory(plan: StagePlan):
    """A () -> LocalWindowCombiner factory when the keyed stage starts
    with an aligned event-time window aggregation, else None. Introspects
    a throwaway operator instance (construction is cheap; open() is what
    builds device state)."""
    from flink_tpu_torch.runtime.local_agg import LocalWindowCombiner
    from flink_tpu_torch.runtime.operators import KeyByOperator, WindowAggOperator

    # the keyed chain opens with the key_by routing op; the aggregation
    # is the first operator after it
    head = None
    for t in plan.keyed_chain:
        if t.operator_factory is None:
            return None
        probe = t.operator_factory()
        if isinstance(probe, KeyByOperator):
            continue
        head = t
        break
    if head is None:
        return None
    if type(probe) is not WindowAggOperator:
        return None  # sessions (merging) and non-window heads: no combine
    if probe.assigner is None or probe.assigner.is_merging or \
            getattr(probe, "uses_processing_time", False):
        return None

    def factory():
        op = head.operator_factory()
        return LocalWindowCombiner(op.assigner, op.agg, op.key_field)

    return factory


class _OutputRoute:
    """One outgoing keyed exchange of a producer subtask (source or
    keyed): optional stateless branch operators (key_by routing markers,
    post-fan-out maps) run here, then records hash-route on the exchange
    key to the consuming stage's subtasks — the ONE keyBy routing
    implementation (reference: KeyGroupStreamPartitioner.selectChannel +
    RecordWriter). In batch mode sub-batches coalesce into bulk blocks
    per subpartition (the SortMergeResultPartition role)."""

    def __init__(self, out: OutSpec, writer, num_channels: int,
                 max_parallelism: int, ctx: OperatorContext,
                 batch_mode: bool = False, batch_size: int = 0,
                 combiner=None, recompute_key_id: bool = False):
        from flink_tpu_torch.runtime.shuffle_spi import KeyGroupPartitioner

        self.out = out
        self.writer = writer
        self.num_channels = num_channels
        self.batch_mode = batch_mode
        self.batch_size = batch_size
        #: two-phase agg, local half: at most one row per (key, slice)
        #: leaves this subtask per batch (flink_tpu/runtime/local_agg.py)
        self.combiner = combiner
        #: routes OUT OF a keyed stage must re-hash: the batch carries
        #: the PREVIOUS exchange's __key_id__. Source routes reuse a
        #: present __key_id__ (the key_by marker / local combiner
        #: computed it from this same key field — local_agg.py:95), and
        #: a branch whose own key_by marker re-keys on THIS exchange's
        #: field has already rewritten __key_id__ — recomputing would
        #: hash every row twice
        if recompute_key_id and any(
                t.keyed and t.key_field == out.key_field
                for t in out.branch):
            recompute_key_id = False
        self.recompute_key_id = recompute_key_id
        self.chain = _OperatorChain(out.branch, ctx) if out.branch \
            else None
        self._partitioner = KeyGroupPartitioner("__key_id__",
                                                max_parallelism)
        self._pending: Dict[int, List[RecordBatch]] = {}
        self._pending_rows: Dict[int, int] = {}
        self.records_out = 0

    def process(self, batch: RecordBatch) -> None:
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        batches = self.chain.process_batch(batch) if self.chain \
            else [batch]
        for b in batches:
            if self.combiner is not None:
                b = self.combiner.combine(b)
            if self.out.key_field not in b.columns:
                raise _SubtaskFailure(
                    f"exchange key field {self.out.key_field!r} missing "
                    f"from batch columns {b.names()}")
            if self.recompute_key_id or "__key_id__" not in b.columns:
                # ints are identity under hash_keys_to_i64, so routing
                # and downstream state share one key identity
                b = b.with_column(
                    "__key_id__",
                    hash_keys_to_i64(b[self.out.key_field]))
            for sub, part in self._partitioner.partition(
                    b, self.num_channels):
                self.records_out += len(part)
                if not self.batch_mode:
                    self.writer.emit(sub, part)
                    continue
                # batch mode: coalesce into bulk blocks (fewer, larger
                # transfers — the batch-shuffle trade)
                self._pending.setdefault(sub, []).append(part)
                n = self._pending_rows.get(sub, 0) + len(part)
                if n >= self.batch_size:
                    self.writer.emit(sub, RecordBatch.concat(
                        self._pending.pop(sub)))
                    self._pending_rows[sub] = 0
                else:
                    self._pending_rows[sub] = n

    def flush(self) -> None:
        for sub, parts in sorted(self._pending.items()):
            if parts:
                self.writer.emit(sub, RecordBatch.concat(parts))
        self._pending.clear()
        self._pending_rows.clear()

    def broadcast(self, event) -> None:
        self.writer.broadcast_event(event)

    def close(self) -> None:
        self.writer.close()

    def snapshot(self, graph, savepoint: bool = False) -> Dict[str, Any]:
        return self.chain.snapshot(graph, savepoint=savepoint) \
            if self.chain else {}

    def restore(self, graph, states, key_group_filter=None) -> None:
        if self.chain:
            self.chain.restore(graph, states,
                               key_group_filter=key_group_filter)


class _SourceSubtask(threading.Thread):
    """One source-stage subtask: polls its source split, applies the
    shared pre-chain, and emits every batch through each of its output
    routes (fan-out duplicates the stream; each route applies its branch
    ops and hash-partitions on its own exchange key)."""

    def __init__(self, index: int, parallelism: int, spec: SourceSpec,
                 graph: StreamGraph, routes: List[_OutputRoute],
                 max_parallelism: int, batch_size: int,
                 coordinator: "_Coordinator", source,
                 restore_position=None, batch_mode: bool = False,
                 source_index: int = 0):
        self.spec = spec
        self.source_index = source_index
        super().__init__(
            name=f"source-subtask-s{source_index}-{index}", daemon=True)
        #: bounded/batch execution: no intermediate watermarks
        self.batch_mode = batch_mode
        self.index = index
        self.parallelism = parallelism
        self.graph = graph
        self.routes = routes
        self.max_parallelism = max_parallelism
        self.batch_size = batch_size
        self.coordinator = coordinator
        self.source = source
        self.restore_position = restore_position
        self.config = coordinator.config
        self.control: _q.Queue = _q.Queue()
        self.error: Optional[BaseException] = None
        self.wm_gen = spec.source.watermark_strategy.create()
        self.chain: Optional[_OperatorChain] = None
        self.records_polled = 0
        self.batches_polled = 0
        #: position at exit — checkpoints after this subtask drains its
        #: split still record where it ended (restore must not replay it)
        self.final_position = None
        #: execution.checkpointing.every-n-source-batches when this is the
        #: job's only source subtask: hold after every N-th batch until the
        #: checkpoint trigger arrives (0: never hold)
        self.hold_every = 0

    @property
    def records_out(self) -> int:
        return sum(r.records_out for r in self.routes)

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001
            self.error = e
            self.coordinator.subtask_failed(self, e)

    def _emit(self, batch: RecordBatch) -> None:
        for r in self.routes:
            r.process(batch)

    def _run(self) -> None:
        spec = self.spec
        ctx = operator_context(self.config, 1, async_fires=False,
                               operator_index=self.index)
        self.chain = _OperatorChain(spec.chain, ctx)
        self.source.open(self.index, self.parallelism)
        if self.restore_position is not None:
            self.source.restore_position(self.restore_position)
        stopping = False
        ticks_pt = self.chain.uses_processing_time
        try:
            while not stopping:
                stopping = self._serve_control()
                if stopping:
                    break
                if self.coordinator.cancelled.is_set():
                    return
                if ticks_pt:
                    # pre-chain processing-time timers fire on the wall
                    # clock even between batches (parity with the
                    # single-slot executor's tick)
                    self.chain.tick_processing_time(
                        int(time.time() * 1000), emit=self._emit)
                batch = self.source.poll_batch(self.batch_size)
                if batch is None:
                    break
                if len(batch) == 0:
                    continue
                self.batches_polled += 1
                self.records_polled += len(batch)
                batch = spec.source.watermark_strategy.assign_timestamps(
                    batch)
                wm = self.wm_gen.on_batch(batch)
                for out in self.chain.process_batch(batch):
                    self._emit(out)
                if wm is not None and not self.batch_mode:
                    for r in self.routes:
                        r.broadcast(int(wm))
                if self.hold_every and \
                        self.batches_polled % self.hold_every == 0:
                    while self.control.empty() and \
                            not self.coordinator.cancelled.is_set():
                        time.sleep(0.001)
        finally:
            self.final_position = self.source.snapshot_position()
            self.source.close()
        for r in self.routes:
            r.flush()
        # a barrier enqueued while this loop was finishing must still be
        # served (position + ack + in-band broadcast) before EOP — the
        # coordinator synthesizes acks only for barriers that arrive after
        # the thread is observably dead
        self._serve_control()
        for r in self.routes:
            r.broadcast(MAX_WATERMARK)
            r.close()

    def snapshot_operators(self, graph, savepoint: bool = False
                           ) -> Dict[str, Any]:
        snap = self.chain.snapshot(graph, savepoint=savepoint) \
            if self.chain else {}
        for r in self.routes:
            snap.update(r.snapshot(graph, savepoint=savepoint))
        return snap

    def _serve_control(self) -> bool:
        """Returns True when the job should stop (stop-with-savepoint)."""
        stopping = False
        while True:
            try:
                trigger = self.control.get_nowait()
            except _q.Empty:
                return stopping
            barrier: Barrier = trigger
            snap = {"position": self.source.snapshot_position(),
                    "operators": self.snapshot_operators(
                        self.graph,
                        savepoint=barrier.savepoint is not None)}
            self.coordinator.ack(barrier.checkpoint_id,
                                 ("source", self.source_index, self.index),
                                 snap)
            # coalesced batch-mode blocks hold pre-barrier records — they
            # must reach the channels BEFORE the barrier or they would be
            # cut out of the snapshot yet covered by the position
            for r in self.routes:
                r.flush()
                r.broadcast(barrier)
            if barrier.stop:
                stopping = True


class _KeyedSubtask(threading.Thread):
    """One keyed-stage subtask: owns a key-group range, consumes one gate
    PER INPUT with per-channel watermarking and aligned barriers spanning
    every channel of every gate (reference:
    SingleCheckpointBarrierHandler aligns across all input channels of a
    multi-input task). An INTERMEDIATE stage's subtask additionally owns a
    downstream partition: main-chain output is re-keyed on the stage's
    out_key_field and hash-exchanged to the next stage, and watermarks /
    aligned barriers / end-of-partition forward in-band (reference: a
    non-sink Task's RecordWriter + barrier forwarding)."""

    def __init__(self, index: int, parallelism: int, stage: KeyedStage,
                 graph: StreamGraph, gates, max_parallelism: int,
                 coordinator: "_Coordinator", config: Configuration,
                 shared_sinks: Optional[Dict[int, _SharedSink]] = None,
                 stage_index: int = 0,
                 routes: Optional[List[_OutputRoute]] = None,
                 mesh_devices: int = 0, memory_manager=None):
        super().__init__(
            name=f"keyed-subtask-st{stage_index}-{index}", daemon=True)
        #: managed device-memory pool shared across the job's subtasks
        self.memory_manager = memory_manager
        self.shared_sinks = shared_sinks
        self.index = index
        self.parallelism = parallelism
        self.stage = stage
        self.stage_index = stage_index
        #: outgoing exchanges (empty: terminal stage, sink in-chain)
        self.routes = routes or []
        #: devices per subtask for the mesh x stage composition (0 = one
        #: device per subtask)
        self.mesh_devices = mesh_devices
        self.graph = graph
        #: one gate per keyed-stage input, in head-operator input order
        self.gates = list(gates) if isinstance(gates, (list, tuple)) \
            else [gates]
        self.max_parallelism = max_parallelism
        self.coordinator = coordinator
        self.config = config
        rng = compute_key_group_range(max_parallelism, parallelism, index)
        self.key_groups = range(rng.start, rng.end + 1)
        #: state queries routed here by the job loop (``_serve_queries``)
        self.control: _q.Queue = _q.Queue()
        self.error: Optional[BaseException] = None
        self.chain: Optional[_OperatorChain] = None
        self.records_in = 0
        #: wall seconds this subtask spent restoring its key-group range
        self.restore_s = 0.0
        self._restore_states: Optional[Dict[str, Any]] = None
        #: slot -> {"b0": {col: arr}, ...} from an unaligned checkpoint
        self._restore_channel_state: Dict[str, Any] = {}

    @property
    def records_out(self) -> int:
        return sum(r.records_out for r in self.routes)

    def _emit_downstream(self, batch: RecordBatch) -> None:
        for r in self.routes:
            r.process(batch)

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001
            self.error = e
            self.coordinator.subtask_failed(self, e)

    def _run(self) -> None:
        # fires are synchronous inside a subtask (the chain hands their
        # output on at once); mesh x stage: the subtask's engine spreads
        # its own key-group range over D logical shards on the job's
        # device — D is not clamped to a device count
        D = self.mesh_devices
        ctx = operator_context(
            self.config, D if D > 1 else 1, async_fires=False,
            operator_index=self.index, memory_manager=self.memory_manager,
            key_group_range=((self.key_groups.start, self.key_groups[-1])
                             if D > 1 else None))
        self.chain = _OperatorChain(self.stage.chain, ctx,
                                    shared_sinks=self.shared_sinks,
                                    side_chains=self.stage.side_chains)
        if self._restore_states is not None:
            t0 = time.perf_counter()
            self.chain.restore(self.graph, self._restore_states,
                               key_group_filter=set(self.key_groups))
            for r in self.routes:
                r.restore(self.graph, self._restore_states,
                          key_group_filter=set(self.key_groups))
            self.restore_s = time.perf_counter() - t0
        gates = self.gates
        K = len(gates)
        # flat channel addressing across gates: (gate, ch) -> slot
        nch = [g.num_channels for g in gates]
        total = sum(nch)
        base = [sum(nch[:g]) for g in range(K)]
        chan_wm = [-(1 << 62)] * total
        done = [False] * total
        combined = -(1 << 62)
        aligning: Optional[Barrier] = None
        barriered = [False] * total
        buffered: List[Tuple[int, int, Any]] = []
        # unaligned-checkpoint mode (reference: CheckpointedInputGate's
        # priority-barrier path + ChannelStateWriter): operator state is
        # snapshotted at the FIRST barrier, data keeps flowing, and
        # pre-barrier batches from not-yet-barriered channels are copied
        # into channel state while being processed
        ua: Optional[Barrier] = None
        ua_snap: Optional[Dict] = None
        ua_barriered = [False] * total
        ua_chan_state: Dict[int, List] = {}
        stopping = False
        poll_at = 0

        def combined_wm() -> int:
            return min((MAX_WATERMARK if done[c] else chan_wm[c])
                       for c in range(total))

        downstream = bool(self.routes)

        def forward(outs) -> None:
            if downstream:
                for b in outs:
                    if len(b):
                        self._emit_downstream(b)
            # terminal stage: sink is in-chain; trailing output dropped

        def process(item, gi: int, slot: int):
            nonlocal combined, stopping
            if isinstance(item, RecordBatch):
                # chaos: kill one keyed subtask mid-batch; the
                # coordinator fails the attempt and the job-level
                # restart/restore machinery takes over (one pipeline =
                # one failover region)
                chaos.fault_point("task.subtask_batch",
                                  stage=self.stage_index,
                                  subtask=self.index)
                self.records_in += len(item)
                forward(self.chain.process_batch(item, input_index=gi))
            elif isinstance(item, int):
                chan_wm[slot] = max(chan_wm[slot], item)
                new = combined_wm()
                if new > combined:
                    combined = new
                    forward(self.chain.process_watermark(combined))
                    # results precede the watermark that fired them
                    for r in self.routes:
                        r.broadcast(int(combined))

        def aligned_snapshot_ack() -> bool:
            """Snapshot + ack the aligning barrier, then forward it
            downstream (barriers flow through the whole pipeline before
            any post-barrier data); returns stop flag."""
            snap = self.chain.snapshot(
                self.graph, savepoint=aligning.savepoint is not None)
            for r in self.routes:
                snap.update(r.snapshot(
                    self.graph, savepoint=aligning.savepoint is not None))
            self.coordinator.ack(aligning.checkpoint_id,
                                 ("keyed", self.stage_index, self.index),
                                 {"operators": snap})
            for r in self.routes:
                r.flush()
                r.broadcast(aligning)
            return aligning.stop

        def finish() -> None:
            """End of all inputs: flush remaining windows through the
            chain, forward downstream, and close the exchanges."""
            outs = self.chain.close()
            forward(outs)
            for r in self.routes:
                r.flush()
                r.broadcast(MAX_WATERMARK)
                r.close()

        def gate_slot(slot: int) -> Tuple[int, int]:
            for g in range(K - 1, -1, -1):
                if slot >= base[g]:
                    return g, slot - base[g]
            return 0, slot

        def ua_begin(item: Barrier) -> None:
            nonlocal ua, ua_snap, ua_barriered, ua_chan_state
            ua = item
            ua_barriered = [False] * total
            ua_chan_state = {}
            snap = self.chain.snapshot(self.graph, savepoint=False)
            for r in self.routes:
                snap.update(r.snapshot(self.graph, savepoint=False))
            ua_snap = snap
            # forward immediately: the barrier overtakes this subtask's
            # own output queues too, so downstream starts ITS unaligned
            # snapshot without waiting behind the exchange backlog
            for r in self.routes:
                r.flush()
                r.broadcast(item)

        def ua_maybe_complete() -> None:
            nonlocal ua, ua_snap
            if ua is None or not all(
                    ua_barriered[c] or done[c] for c in range(total)):
                return
            payload = {"operators": ua_snap}
            if ua_chan_state:
                payload["channel_state"] = {
                    str(slot): {f"b{i}": dict(b.columns)
                                for i, b in enumerate(batches)}
                    for slot, batches in ua_chan_state.items() if batches}
            self.coordinator.ack(ua.checkpoint_id,
                                 ("keyed", self.stage_index, self.index),
                                 payload)
            ua = None
            ua_snap = None

        if self._restore_channel_state:
            # in-flight batches an unaligned checkpoint persisted: they
            # were consumed from the channels AFTER the snapshot cut, so
            # on restore they replay through the operator first —
            # upstream's positions are already past them (no duplication)
            from flink_tpu_torch.core.records import RecordBatch as _RB

            for slot_str in sorted(self._restore_channel_state, key=int):
                slot = int(slot_str)
                gi0, _ = gate_slot(slot)
                entry = self._restore_channel_state[slot_str]
                for bk in sorted(entry, key=lambda s: int(s[1:])):
                    process(_RB(entry[bk]), gi0, slot)

        ticks_pt = self.chain.uses_processing_time
        while True:
            self._serve_queries()
            if self.coordinator.cancelled.is_set():
                return
            if ticks_pt:
                self.chain.tick_processing_time(
                    int(time.time() * 1000),
                    emit=(self._emit_downstream if downstream else None))
            # non-blocking sweep of every gate first — an idle/exhausted
            # input must not throttle a live one; only when ALL gates are
            # empty does one (rotating) gate take a short blocking poll
            entry = None
            gi = poll_at
            for off in range(K):
                g = (poll_at + off) % K
                entry = gates[g].poll(timeout=0)
                if entry is not None:
                    gi = g
                    break
            if entry is None:
                gi = poll_at
                entry = gates[gi].poll(timeout=0.05)
            poll_at = (gi + 1) % K
            if entry is None:
                continue
            ch, item = entry
            slot = base[gi] + ch
            if isinstance(item, Barrier) and item.unaligned:
                if ua is None or ua.checkpoint_id != item.checkpoint_id:
                    ua_begin(item)
                ua_barriered[slot] = True
                ua_chan_state.setdefault(slot, []).extend(
                    gates[gi].take_inflight(ch, item.checkpoint_id))
                ua_maybe_complete()
                continue
            if isinstance(item, Barrier):
                if aligning is None:
                    aligning = item
                    barriered = [False] * total
                barriered[slot] = True
                if all(barriered[c] or done[c] for c in range(total)):
                    # all channels of all gates aligned: snapshot + ack,
                    # then drain the buffered post-barrier items
                    if aligned_snapshot_ack():
                        stopping = True
                    aligning = None
                    for bgi, bslot, bitem in buffered:
                        process(bitem, bgi, bslot)
                    buffered = []
                    if stopping:
                        # stop-with-savepoint: close WITHOUT forwarding —
                        # post-savepoint output would duplicate on resume
                        self.chain.close()
                        for r in self.routes:
                            r.close()
                        return
                continue
            if item is END_OF_PARTITION:
                done[slot] = True
                ua_maybe_complete()
                if aligning is not None and all(
                        barriered[c] or done[c] for c in range(total)):
                    stop = aligned_snapshot_ack()
                    if stop:
                        # stop-with-savepoint completed by an EOP: stop
                        # exactly like the barrier-completion branch —
                        # post-savepoint output would duplicate on resume
                        aligning = None
                        self.chain.close()
                        for r in self.routes:
                            r.close()
                        return
                    aligning = None
                    for bgi, bslot, bitem in buffered:
                        process(bitem, bgi, bslot)
                    buffered = []
                if all(done):
                    if MAX_WATERMARK > combined:
                        forward(self.chain.process_watermark(
                            MAX_WATERMARK))
                    finish()
                    return
                # a finished channel no longer constrains the watermark
                new = combined_wm()
                if new > combined:
                    combined = new
                    forward(self.chain.process_watermark(combined))
                    for r in self.routes:
                        r.broadcast(int(combined))
                continue
            if aligning is not None and barriered[slot]:
                # aligned-barrier blocking: post-barrier data waits until
                # alignment completes (bounded by channel credits)
                buffered.append((gi, slot, item))
                continue
            if ua is not None and not ua_barriered[slot] and \
                    isinstance(item, RecordBatch):
                # unaligned in progress: pre-barrier data from channels
                # whose barrier has not arrived is BOTH processed (live
                # run continues) and copied into channel state (it is not
                # covered by the already-taken operator snapshot)
                ua_chan_state.setdefault(slot, []).append(item)
            process(item, gi, slot)


    def _serve_queries(self) -> None:
        """Answer the state queries the job loop routed to this subtask
        (reference ``flink_tpu/cluster/stage_executor.py:1379``), on this
        subtask's thread between batches: ``(operator, keys, namespace,
        reply)``, keys a list (one batched read) or a single key."""
        while True:
            try:
                req = self.control.get_nowait()
            except _q.Empty:
                return
            op_name, key, namespace, reply = req
            try:
                result = None
                for t, op in zip(self.chain.transformations,
                                 self.chain.operators):
                    if t.name != op_name:
                        continue
                    if op is None or not hasattr(op, "query_state"):
                        raise RuntimeError(
                            f"operator {op_name!r} has no queryable "
                            "state")
                    if isinstance(key, list):
                        if hasattr(op, "query_state_batch"):
                            result = op.query_state_batch(key, namespace)
                        else:
                            result = [op.query_state(k, namespace)
                                      for k in key]
                    else:
                        result = op.query_state(key, namespace)
                    break
                reply.put((result, None))
            except BaseException as e:  # noqa: BLE001 - to the client
                reply.put((None, e))


class _Coordinator:
    """Checkpoint + failure coordination for one stage-parallel job run."""

    def __init__(self, num_acks: int, config: Configuration):
        self.num_acks = num_acks
        #: the job's configuration (the subtasks open their operators
        #: from it)
        self.config = config
        self.cancelled = threading.Event()
        self.failure: Optional[BaseException] = None
        self._acks: Dict[int, Dict[Tuple[str, int], Dict]] = {}
        self._complete: Dict[int, threading.Event] = {}
        self._lock = threading.Lock()

    def expect(self, checkpoint_id: int) -> threading.Event:
        with self._lock:
            self._acks[checkpoint_id] = {}
            ev = self._complete[checkpoint_id] = threading.Event()
            return ev

    def ack(self, checkpoint_id: int, who: Tuple[str, int],
            snap: Dict) -> None:
        with self._lock:
            acks = self._acks.get(checkpoint_id)
            if acks is None or who in acks:
                # first ack wins: a synthesized end-of-split ack must never
                # replace a real barrier-cut ack (their positions differ)
                return
            acks[who] = snap
            if len(acks) >= self.num_acks:
                self._complete[checkpoint_id].set()

    def collected(self, checkpoint_id: int) -> Dict[Tuple[str, int], Dict]:
        with self._lock:
            return self._acks.pop(checkpoint_id, {})

    def subtask_failed(self, subtask, error: BaseException) -> None:
        self.failure = self.failure or error
        self.cancelled.set()
        with self._lock:
            for ev in self._complete.values():
                ev.set()


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class StageParallelExecutor:
    """Same run() contract as LocalExecutor, executing via subtask
    expansion (reference: Execution.deploy — but subtasks here are threads
    wired by the Shuffle SPI; a cross-process transport plugs in via
    ``shuffle.service``)."""

    def __init__(self, config: Optional[Configuration] = None,
                 shuffle_service=None):
        self.config = config or Configuration()
        self._shuffle = shuffle_service
        self._cancel_event = None

    def run(self, graph: StreamGraph, job_name: str = "job",
            restore_from: Optional[str] = None, cancel_event=None,
            restore_mode: str = "no-claim", control_queue=None):
        """Execute the graph to completion; the same contract as
        ``LocalExecutor.run``."""
        self._cancel_event = cancel_event
        from flink_tpu_torch.datastream.environment import JobExecutionResult
        from flink_tpu_torch.metrics import MetricRegistry, TraceCollector
        from flink_tpu_torch.observe.export import (
            register_flight_metrics,
            register_kernel_metrics,
        )

        check_unread_keys(self.config)
        plan = plan_stages(graph)
        registry = MetricRegistry()
        traces = TraceCollector()
        job_group = registry.root_group("job", job_name)
        chaos.register_chaos_metrics(job_group)
        flight.set_job(job_name)
        register_flight_metrics(registry.root_group())
        register_kernel_metrics(registry.root_group())
        #: per checkpoint written: id, bytes, write ms
        self.checkpoints: List[Dict[str, Any]] = []
        self.restore_ms = 0.0
        src_specs = plan.source_specs
        K = len(src_specs)
        cfg = self.config
        N = cfg.get(DeploymentOptions.STAGE_PARALLELISM)
        S = cfg.get(DeploymentOptions.SOURCE_PARALLELISM)
        max_par = cfg.get(CoreOptions.MAX_PARALLELISM)
        batch_size = cfg.get(BatchOptions.BATCH_SIZE)
        batch_mode = cfg.get(
            ExecutionModeOptions.RUNTIME_MODE) == "batch"
        for spec in src_specs:
            if batch_mode and not getattr(spec.source.source, "bounded",
                                          True):
                raise RuntimeError(
                    "execution.runtime-mode=batch requires bounded "
                    f"sources; {spec.source.name!r} is unbounded")
        if N == -1:
            # adaptive batch parallelism (reference:
            # AdaptiveBatchScheduler decides downstream parallelism from
            # PRODUCED partition volume, not a plan-time guess). Bounded
            # sources are replayable by contract (open() rewinds — see
            # connectors/source_v2.py reset + tests/test_source_v2.py),
            # so the volume is MEASURED with a metering pass through each
            # source; estimate_records() is only the fallback when a
            # source cannot be metered. A wrong or absent estimate
            # therefore cannot missize the stage (it previously silently
            # fell to N=1).
            if not batch_mode:
                raise StagePlanError(
                    "execution.stage-parallelism=-1 (adaptive) requires "
                    "execution.runtime-mode=batch")
            target = cfg.get(
                ExecutionModeOptions.TARGET_RECORDS_PER_SUBTASK)
            if target < 1:
                raise StagePlanError(
                    "execution.batch.target-records-per-subtask must be "
                    f">= 1, got {target}")
            est = 0
            for spec in src_specs:
                src = spec.source.source
                try:
                    src.open(0, 1)
                    meter = 0
                    while True:
                        b = src.poll_batch(1 << 16)
                        if b is None:
                            break
                        meter += len(b)
                    est += meter
                except Exception:
                    est += int(getattr(src, "estimate_records",
                                       lambda: 0)() or 0)
            N = max(1, min(-(-int(est) // target) if est else 1, max_par))
        if N < 1:
            raise StagePlanError("execution.stage-parallelism must be >= 1")

        shuffle = self._shuffle or create_shuffle_service(
            cfg.get(DeploymentOptions.SHUFFLE_SERVICE))
        credits = cfg.get(DeploymentOptions.SHUFFLE_CREDITS)

        ckpt_dir = cfg.get(StateOptions.CHECKPOINT_DIR)
        ckpt_interval = cfg.get(CheckpointOptions.INTERVAL_MS)
        ckpt_every_n = cfg.get(CheckpointOptions.EVERY_N_BATCHES)
        storage = None
        if ckpt_dir and (ckpt_interval or ckpt_every_n):
            from flink_tpu_torch.checkpoint.storage import CheckpointStorage

            storage = CheckpointStorage(
                ckpt_dir, compress=cfg.get(CheckpointOptions.COMPRESSION))

        # restore
        checkpoint_id = 0
        restore_states: Dict[str, Any] = {}
        restore_positions: Dict[int, Any] = {}
        restore_channel_state: Dict[Tuple[int, int], Dict[str, Any]] = {}
        if restore_from is not None:
            from flink_tpu_torch.checkpoint.savepoint import prepare_restore
            from flink_tpu_torch.checkpoint.storage import (
                read_checkpoint_chain,
                read_manifest,
            )

            t_restore = time.perf_counter()
            snap_dir, _ = prepare_restore(restore_from, restore_mode,
                                          own_checkpoint_root=ckpt_dir)
            states = read_checkpoint_chain(snap_dir)
            checkpoint_id = int(read_manifest(snap_dir)["checkpoint_id"])
            src_ids = {graph.stable_id(spec.source): i
                       for i, spec in enumerate(src_specs)}
            known_ids = {graph.stable_id(t)
                         for spec in src_specs
                         for t in spec.transformations
                         if t.operator_factory is not None}
            known_ids.update(
                graph.stable_id(t)
                for stage in plan.stages
                for t in stage.operator_transformations
                if t.operator_factory is not None)
            for sid, state in states.items():
                if sid.startswith("__channel_state__."):
                    _, m_s, j_s, slot_s = sid.rsplit(".", 3)
                    m_i, j_i = int(m_s), int(j_s)
                    if j_i >= N:
                        raise RuntimeError(
                            "unaligned checkpoint holds channel state for "
                            f"subtask {j_i} but execution.stage-parallelism "
                            f"is {N} — restore with the original "
                            "parallelism")
                    restore_channel_state.setdefault(
                        (m_i, j_i), {})[slot_s] = state
                    continue
                if sid in src_ids:
                    pos = state["source"]
                    if isinstance(pos, dict) and "__subtasks__" in pos:
                        per_sub = {int(k): v
                                   for k, v in pos["__subtasks__"].items()}
                        if len(per_sub) != S:
                            raise RuntimeError(
                                "snapshot has positions for "
                                f"{len(per_sub)} source subtasks "
                                f"but execution.source-parallelism is {S} "
                                "— source splits cannot be re-assigned "
                                "across counts (restore with the original "
                                "source parallelism)")
                    else:
                        if S != 1:
                            raise RuntimeError(
                                "snapshot has a single source position "
                                f"but execution.source-parallelism is {S}")
                        per_sub = {0: pos}
                    restore_positions[src_ids[sid]] = per_sub
                elif sid in known_ids:
                    restore_states[sid] = state
                else:
                    # the reference fails on non-restored state by default
                    # (allowNonRestoredState opt-in); dropping it silently
                    # would e.g. restart a renamed source from record 0
                    raise RuntimeError(
                        "checkpoint contains state for operators not "
                        "present in the graph (graph changed since "
                        f"snapshot?): {sid!r}")
            if storage is not None:
                checkpoint_id = max(
                    checkpoint_id, storage.latest_checkpoint_id() or 0)
            self.restore_ms = (time.perf_counter() - t_restore) * 1e3

        self._traces = traces
        M = len(plan.stages)
        coordinator = _Coordinator(num_acks=K * S + M * N, config=cfg)

        # wire exchanges: every OutSpec of every producer is one
        # exchange; producer subtask p owns one partition with N
        # subpartitions, and the consuming stage's subtask j reads
        # subpartition j of every producer partition through one gate
        # per stage INPUT (ordered by the head operator's input index).
        # (reference: IntermediateResultPartition / InputGate wiring in
        # the ExecutionGraph.)
        exchanges = []  # (producer kind, producer idx, out_spec)
        for i, spec in enumerate(src_specs):
            for o in spec.outputs:
                exchanges.append(("src", i, o))
        for m, stage in enumerate(plan.stages):
            for o in stage.outputs:
                exchanges.append(("stage", m, o))

        def xpid(eid: int, p: int) -> str:
            return f"{job_name}-x{eid}-{p}"

        #: eid -> list of per-producer-subtask partition writers
        x_writers: Dict[int, list] = {}
        #: (target_stage, target_input) -> eid
        x_target: Dict[Tuple[int, int], int] = {}
        for eid, (kind, idx, o) in enumerate(exchanges):
            p_count = S if kind == "src" else N
            x_writers[eid] = [
                shuffle.create_partition(xpid(eid, p), N, credits)
                for p in range(p_count)]
            x_target[(o.target_stage, o.target_input)] = eid
        #: stage m, subtask j -> gates ordered by input index
        stage_gates = {
            m: [[shuffle.create_gate(
                [xpid(x_target[(m, i)], p)
                 for p in range(len(x_writers[x_target[(m, i)]]))], j)
                for i in range(stage.num_inputs)]
                for j in range(N)]
            for m, stage in enumerate(plan.stages)}

        combiner_factory = None
        if K == 1 and len(src_specs[0].outputs) == 1 and \
                src_specs[0].outputs[0].target_stage == 0 and \
                not src_specs[0].outputs[0].branch and \
                cfg.get(DeploymentOptions.LOCAL_AGG):
            combiner_factory = _local_combiner_factory(plan)

        def make_routes(kind: str, idx: int, outs: List[OutSpec],
                        sub: int, ctx: OperatorContext,
                        with_combiner: bool = False) -> List[_OutputRoute]:
            routes = []
            for o in outs:
                eid = next(e for e, (k2, i2, o2) in enumerate(exchanges)
                           if k2 == kind and i2 == idx and o2 is o)
                routes.append(_OutputRoute(
                    o, x_writers[eid][sub], N, max_par, ctx,
                    batch_mode=batch_mode, batch_size=batch_size,
                    combiner=(combiner_factory()
                              if with_combiner and combiner_factory
                              else None),
                    recompute_key_id=(kind == "stage")))
            return routes

        sources = []
        import copy as _copy

        for i, spec in enumerate(src_specs):
            per_src_pos = restore_positions.get(i, {})
            for s in range(S):
                src = spec.source.source if S == 1 else _copy.deepcopy(
                    spec.source.source)
                ctx = operator_context(cfg, 1, async_fires=False,
                                       operator_index=s)
                sources.append(_SourceSubtask(
                    s, S, spec, graph,
                    make_routes("src", i, spec.outputs, s, ctx,
                                with_combiner=(i == 0)),
                    max_par, batch_size, coordinator, src,
                    restore_position=per_src_pos.get(s),
                    batch_mode=batch_mode,
                    source_index=i))
        shared_sinks: Dict[int, _SharedSink] = {}
        mesh_devices = cfg.get(DeploymentOptions.STAGE_MESH_DEVICES)
        memory_manager = None
        device_budget = cfg.get(MemoryOptions.DEVICE_MEMORY_BUDGET)
        if device_budget > 0:
            from flink_tpu_torch.core.memory import MemoryManager

            # one pool across every subtask of the job (they share the
            # process's device)
            memory_manager = MemoryManager(device_budget)
        self.memory_manager = memory_manager
        keyed: List[_KeyedSubtask] = []
        for m, stage in enumerate(plan.stages):
            for j in range(N):
                ctx = operator_context(cfg, 1, async_fires=False,
                                       operator_index=j)
                keyed.append(_KeyedSubtask(
                    j, N, stage, graph, stage_gates[m][j],
                    max_par, coordinator, cfg,
                    shared_sinks=shared_sinks, stage_index=m,
                    routes=make_routes("stage", m, stage.outputs, j, ctx),
                    mesh_devices=mesh_devices,
                    memory_manager=memory_manager))
        for k in keyed:
            if restore_states:
                k._restore_states = restore_states
            cs = restore_channel_state.get((k.stage_index, k.index))
            if cs:
                k._restore_channel_state = cs
        if storage is not None and ckpt_every_n and len(sources) == 1:
            # one source subtask: the every-N trigger is exact — the
            # source holds after each N-th batch until its barrier comes,
            # so a thread that outruns this loop cannot skip a checkpoint
            sources[0].hold_every = ckpt_every_n
        for t in keyed + sources:
            t.start()

        t0 = time.perf_counter()
        savepoint_path = None
        last_ckpt = time.time() * 1000
        last_batches = 0
        try:
            while any(t.is_alive() for t in sources + keyed):
                if cancel_event is not None and cancel_event.is_set():
                    raise JobCancelledError(job_name)
                if coordinator.failure is not None:
                    raise coordinator.failure
                # user control: savepoints / queries
                if control_queue is not None:
                    sp = self._serve_control(
                        control_queue, plan, graph, sources, keyed,
                        coordinator, storage, ckpt_dir, job_name,
                        checkpoint_id)
                    if sp is not None:
                        checkpoint_id, savepoint_path, stopped = sp
                        if stopped:
                            break
                # periodic checkpoints (time interval or deterministic
                # every-N-source-batches, like the single-slot executor)
                if storage is not None and any(
                        s.is_alive() for s in sources):
                    total_batches = sum(s.batches_polled for s in sources)
                    due = (ckpt_every_n and total_batches - last_batches
                           >= ckpt_every_n) or (
                        not ckpt_every_n and ckpt_interval
                        and time.time() * 1000 - last_ckpt >= ckpt_interval)
                    if due:
                        checkpoint_id += 1
                        self._checkpoint(
                            checkpoint_id,
                            Barrier(checkpoint_id,
                                    unaligned=cfg.get(
                                        CheckpointOptions.UNALIGNED)),
                            sources, keyed, coordinator, graph, plan,
                            storage=storage, job_name=job_name)
                        last_ckpt = time.time() * 1000
                        last_batches = total_batches
                time.sleep(0.01)
            if coordinator.failure is not None:
                raise coordinator.failure
            for t in sources + keyed:
                t.join(timeout=30)
                if t.error is not None:
                    raise t.error
        except BaseException:
            coordinator.cancelled.set()
            if isinstance(shuffle, LocalShuffleService):
                shuffle.cancel()
            for t in sources + keyed:
                t.join(timeout=5)
            for k in keyed:
                if k.chain is not None:
                    k.chain.dispose()
            raise
        finally:
            if self._shuffle is None:
                # a service this run created (a sort-merge one owns a
                # spill directory) ends with the run
                shuffle.close()
            if control_queue is not None:
                from flink_tpu_torch.cluster.local_executor import _ControlRequest

                try:
                    while True:
                        req = control_queue.get_nowait()
                        if isinstance(req, _ControlRequest):
                            req.finish(None, RuntimeError(
                                f"job {job_name!r} terminated"))
                except _q.Empty:
                    pass

        elapsed = time.perf_counter() - t0
        # the restore: reading and splitting the snapshot, then the
        # slowest subtask's restore of its key-group range
        self.restore_ms += max((k.restore_s for k in keyed),
                               default=0.0) * 1e3
        for k in keyed:
            job_group.add_group(f"stage{k.stage_index}.subtask{k.index}") \
                .gauge("numRecordsIn", lambda k=k: k.records_in)
        total = sum(s.records_polled for s in sources)
        metrics = {
            "records": total,
            "elapsed_s": elapsed,
            "records_per_s": total / elapsed if elapsed else 0.0,
            "stage_parallelism": N,
            "source_parallelism": S,
            # rows that actually crossed the keyed exchange (< records
            # when the local combiner collapsed them — the two-phase win)
            "records_shuffled": sum(s.records_out for s in sources),
            "subtask_records_in": [k.records_in for k in keyed
                                   if k.stage_index == 0],
            **({"keyed_stages": M,
                "per_stage_records_in": [
                    [k.records_in for k in keyed if k.stage_index == m]
                    for m in range(M)]} if M > 1 else {}),
        }
        if savepoint_path:
            metrics["savepoint"] = savepoint_path
        if self.checkpoints or restore_from is not None:
            metrics["checkpoints"] = list(self.checkpoints)
            metrics["restore_ms"] = self.restore_ms
        result = JobExecutionResult(job_name, metrics)
        result.registry = registry
        result.traces = traces
        return result

    # ------------------------------------------------------------- control

    def _serve_control(self, control_queue, plan, graph, sources, keyed,
                       coordinator, storage, ckpt_dir, job_name,
                       checkpoint_id):
        """Serve one queued control request: a savepoint (or stop-with-
        savepoint) through the barrier machinery, or a state query routed
        to its owning keyed subtasks (reference
        ``flink_tpu/cluster/stage_executor.py:1839``); any other request
        (a live rescale included) fails as the reference's does."""
        from flink_tpu_torch.cluster.local_executor import (
            SavepointRequest,
            StateQueryBatchRequest,
            StateQueryRequest,
        )

        try:
            req = control_queue.get_nowait()
        except _q.Empty:
            return None
        if isinstance(req, (StateQueryRequest, StateQueryBatchRequest)):
            try:
                req.finish(self._route_query(req, plan, keyed))
            except BaseException as e:  # noqa: BLE001 - to the client
                req.finish(None, e)
            return None
        if not isinstance(req, SavepointRequest):
            # the reference's answer to any other request (a live rescale
            # included: a stage job's subtasks each own their engine)
            req.finish(None, RuntimeError(f"unsupported control {req!r}"))
            return None
        try:
            new_id = checkpoint_id + 1
            path = self._checkpoint(
                new_id, Barrier(new_id, savepoint=req.path, stop=req.stop),
                sources, keyed, coordinator, graph, plan,
                savepoint_dir=req.path, job_name=job_name)
            req.finish(path)
            return (new_id, path, req.stop)
        except Exception as e:  # reported to the requester
            req.finish(None, e)
            return None

    def _route_query(self, req, plan, keyed):
        """One control message per OWNING keyed subtask of the operator's
        stage (key group -> operator index, the data path's formula); the
        owners answer on their threads and the parts are put back in
        request order. An unknown operator raises ``KeyError`` naming what
        exists, as ``LocalExecutor._serve_query`` does."""
        from flink_tpu_torch.cluster.local_executor import (
            StateQueryBatchRequest,
        )
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        stage_index = None
        for m, stage in enumerate(plan.stages):
            if any(t.name == req.operator_name
                   for t in stage.operator_transformations):
                stage_index = m
                break
        if stage_index is None:
            raise KeyError(
                f"no operator named {req.operator_name!r}; available: "
                f"{sorted(t.name for stage in plan.stages for t in stage.operator_transformations)}")
        batched = isinstance(req, StateQueryBatchRequest)
        keys = req.keys if batched else [req.key]
        N = sum(1 for k in keyed if k.stage_index == stage_index)
        mp = self.config.get(CoreOptions.MAX_PARALLELISM)
        owners = key_group_to_operator_index(
            assign_key_groups(hash_keys_to_i64(np.asarray(keys)), mp),
            mp, N)
        results: list = [None] * len(keys)
        pending = []
        for owner in sorted(set(int(o) for o in owners)):
            sel = [i for i, o in enumerate(owners) if int(o) == owner]
            reply: _q.Queue = _q.Queue()
            part = [keys[i] for i in sel] if batched else keys[0]
            # keyed is stage-major: m * N + j
            keyed[stage_index * N + owner].control.put(
                (req.operator_name, part, req.namespace, reply))
            pending.append((sel, reply))
        err = None
        for sel, reply in pending:
            part, e = reply.get(timeout=30)
            if e is not None:
                err = err or e
                continue
            if not batched:
                return part
            for i, r in zip(sel, part or []):
                results[i] = r
        if err is not None:
            raise err
        return results

    # ---------------------------------------------------------- checkpoint

    def _checkpoint(self, checkpoint_id: int, barrier: Barrier, sources,
                    keyed, coordinator, graph, plan,
                    storage=None, savepoint_dir=None, job_name="job"):
        """Trigger, await S+N acks, merge subtask states into the logical
        single-slot snapshot format, commit."""
        live_sources = [s for s in sources if s.is_alive()]
        if not live_sources:
            raise RuntimeError("cannot checkpoint: all sources finished")
        coordinator.num_acks = len(live_sources) + len(keyed)
        done = coordinator.expect(checkpoint_id)
        for s in live_sources:
            s.control.put(barrier)
        deadline = time.monotonic() + 120
        while not done.wait(timeout=0.1):
            # a source may have drained its split between the is_alive()
            # check and serving the trigger: synthesize its ack from the
            # recorded final position (the thread has exited — its chain
            # is safe to snapshot from here)
            for s in live_sources:
                if not s.is_alive() and s.final_position is not None:
                    coordinator.ack(
                        checkpoint_id,
                        ("source", s.source_index, s.index),
                        {"position": s.final_position,
                         "operators": s.snapshot_operators(graph)})
            # the run loop is parked here — subtask death must abort the
            # checkpoint, not wait out the full deadline
            if coordinator.failure is not None:
                raise coordinator.failure
            if self._cancel_event is not None \
                    and self._cancel_event.is_set():
                raise JobCancelledError("cancelled during checkpoint")
            if coordinator.cancelled.is_set():
                raise RuntimeError(
                    f"checkpoint {checkpoint_id} aborted: the job was "
                    "cancelled")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"checkpoint {checkpoint_id} timed out")
        if coordinator.failure is not None:
            raise coordinator.failure
        acks = coordinator.collected(checkpoint_id)
        # assemble logical snapshot: per-source positions under each
        # physical source's own transformation id
        positions: Dict[int, Dict[int, Any]] = {}
        for who, sub in acks.items():
            if who[0] == "source":
                positions.setdefault(who[1], {})[who[2]] = sub["position"]
        # finished subtasks that were not in this trigger round still
        # contribute their end-of-split position — omitting them would
        # replay their whole split on restore
        for s in sources:
            per_input = positions.setdefault(s.source_index, {})
            if s.index not in per_input and s.final_position is not None:
                per_input[s.index] = s.final_position
        snap: Dict[str, Any] = {}
        source_parallelism = self.config.get(
            DeploymentOptions.SOURCE_PARALLELISM)
        for i, spec in enumerate(plan.source_specs):
            per_input = positions.get(i, {})
            # the wrap decision is per input from the CONFIGURED source
            # parallelism, not the observed position count — a missing
            # subtask position must fail the checkpoint precisely, not
            # produce a snapshot that later fails restore with a
            # misleading cross-count error
            if len(per_input) != source_parallelism:
                raise RuntimeError(
                    f"checkpoint {checkpoint_id} incomplete: input {i} "
                    f"has positions for {sorted(per_input)} but "
                    f"execution.source-parallelism is {source_parallelism}")
            # a single-subtask source stores its position unwrapped, so
            # the snapshot is restorable by the single-slot executor too;
            # S > 1 wraps per-subtask positions (stage-mode restore only)
            if source_parallelism == 1:
                source_state = {"source": per_input.get(0)}
            else:
                source_state = {"source": {"__subtasks__": {
                    str(s): p for s, p in per_input.items()}}}
            snap[graph.stable_id(spec.source)] = source_state
        per_operator: Dict[str, List[Dict]] = {}
        for who, sub in acks.items():
            for sid, state in sub.get("operators", {}).items():
                per_operator.setdefault(sid, []).append(state)
            if who[0] == "keyed" and sub.get("channel_state"):
                # in-flight batches an unaligned barrier overtook, keyed
                # by (stage, subtask, flat channel) — replayed on restore
                for slot, payload in sub["channel_state"].items():
                    snap[f"__channel_state__.{who[1]}.{who[2]}.{slot}"] = \
                        payload
        for sid, states in per_operator.items():
            snap[sid] = merge_subtask_states(states)
        if savepoint_dir is not None:
            from flink_tpu_torch.checkpoint.savepoint import write_savepoint

            return write_savepoint(savepoint_dir, job_name, snap,
                                   checkpoint_id=checkpoint_id)
        if storage is not None:
            t0 = time.perf_counter()
            with flight.span("checkpoint.write"), self._traces.span(
                    "checkpoint", f"checkpoint-{checkpoint_id}"):
                new_dir = storage.write_checkpoint(checkpoint_id, job_name,
                                                   snap)
            self.checkpoints.append({
                "id": checkpoint_id,
                "unaligned": bool(barrier.unaligned),
                "bytes": sum(e.stat().st_size for e in os.scandir(new_dir)
                             if e.is_file()),
                "write_ms": (time.perf_counter() - t0) * 1e3,
            })
            # bounded disk: same torn-aware GC as the single-slot
            # executor (state.checkpoints.num-retained; retention
            # anchors on VERIFIED checkpoints, so a torn newest never
            # strands the fallback chain)
            storage.retain(retained_checkpoints(self.config))
        return None


def make_executor(config: Configuration, graph: StreamGraph):
    """LocalExecutor unless ``execution.stage-parallelism`` is set AND the
    graph is expandable — shared by env.execute() and
    TaskExecutor.submit_task so local runs and cluster deployments pick
    the same engine (reference: the scheduler, not the API, decides the
    execution shape)."""
    sp = config.get(DeploymentOptions.STAGE_PARALLELISM)
    if sp == -1 or sp > 0:
        try:
            plan_stages(graph)
        except StagePlanError as e:
            if not config.get(DeploymentOptions.STAGE_FALLBACK):
                raise StagePlanError(
                    f"execution.stage-parallelism={sp} requested but {e}. "
                    "Set execution.stage-fallback=true to run single-slot "
                    "instead.") from e
            import warnings

            warnings.warn(
                f"execution.stage-parallelism set but {e}; running "
                "single-slot (execution.stage-fallback=true)",
                stacklevel=2)
            ex = LocalExecutor(config)
            ex.fallback_reason = str(e)
            return ex
        else:
            return StageParallelExecutor(config)
    return LocalExecutor(config)
