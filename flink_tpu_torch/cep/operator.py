"""CEP operator: keyed NFA matching with event-time ordering (port of
``flink_tpu/cep/operator.py``, on the port's runtime operator, graph
transformation and DataStream).

reference: flink-cep/.../operator/CepOperator.java — buffers out-of-order
events in keyed state (a MapState of ts -> events) and advances the NFA in
timestamp order when the watermark passes, one NFA per key.

Batched re-design: per micro-batch, all stage conditions are evaluated
vectorized over the whole batch (one mask per stage); events + their
per-stage hit booleans are bucketed per key into host buffers; on watermark
advance each key's due events are sorted by timestamp and threaded through
that key's NFA. The Python loop is O(events x live partials) per key but
does no predicate work — the predicates ran columnar.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.cep.nfa import KeyNFA, Match
from flink_tpu_torch.cep.pattern import Pattern
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.operators import Operator


def default_select(key: Any, match: Match,
                   events_by_stage: Dict[str, List[dict]]) -> dict:
    """Default match projection: key, span, per-stage event counts."""
    row = {"key": key, "start_ts": match.start_ts, "end_ts": match.end_ts}
    for name, events in events_by_stage.items():
        row[f"{name}_count"] = len(events)
    return row


class CepOperator(Operator):
    name = "cep"

    def __init__(self, pattern: Pattern, key_field: str,
                 select: Optional[Callable] = None):
        self.pattern = pattern.validate()
        self.key_field = key_field
        self.select = select or default_select
        self._nfas: Dict[int, KeyNFA] = {}
        # pending (not yet watermark-ripe) events per key:
        # list of (ts, event_row, stage_hits tuple)
        self._pending: Dict[int, List] = {}
        self._key_values: Dict[int, Any] = {}

    # -- hooks ---------------------------------------------------------------

    def process_batch(self, batch: RecordBatch, input_index: int = 0
                      ) -> List[RecordBatch]:
        if len(batch) == 0:
            return []
        # vectorized: one mask per stage over the whole batch, with
        # until-condition columns appended (same pattern-order the NFA's
        # _until_col mapping assumes)
        cols = [st.evaluate(batch) for st in self.pattern.stages]
        cols.extend(
            np.asarray(st.until_condition(batch), dtype=bool)
            for st in self.pattern.stages if st.until_condition is not None)
        hits = np.stack(cols, axis=1)  # [n, n_stages + n_untils]
        kids = batch.key_ids
        tss = batch.timestamps
        rows = batch.to_rows()
        if self.key_field in batch.columns:
            kv = self._key_values
            for k, r in zip(kids.tolist(), rows):
                if k not in kv:
                    kv[k] = r.get(self.key_field)
        pending = self._pending
        hit_list = hits.tolist()
        for i, (k, t) in enumerate(zip(kids.tolist(), tss.tolist())):
            pending.setdefault(k, []).append((t, rows[i], hit_list[i]))
        return []

    def process_watermark(self, watermark: int, input_index: int = 0
                          ) -> List[RecordBatch]:
        out_rows: List[dict] = []
        out_ts: List[int] = []
        for k, buf in self._pending.items():
            due = [e for e in buf if e[0] <= watermark]
            if not due:
                continue
            self._pending[k] = [e for e in buf if e[0] > watermark]
            due.sort(key=lambda e: e[0])
            nfa = self._nfas.get(k)
            if nfa is None:
                nfa = self._nfas[k] = KeyNFA(self.pattern)
            for ts, row, stage_hits in due:
                for m in nfa.advance(row, ts, stage_hits):
                    # every pattern stage is present (possibly empty) so
                    # emitted rows share one schema regardless of optionals
                    events = {
                        st.name: [nfa.event(i) for i in
                                  m.events_by_stage.get(st.name, [])]
                        for st in self.pattern.stages}
                    out_rows.append(self.select(
                        self._key_values.get(k, k), m, events))
                    out_ts.append(m.end_ts)
        # prune EVERY key (idle keys must release within-expired partials
        # and their event logs), dropping empty per-key state entirely.
        # Pruning can RELEASE matches: a trailing notFollowedBy completes
        # when its window expires without the forbidden event.
        for k in list(self._nfas):
            nfa = self._nfas[k]
            for m in nfa.prune(watermark):
                events = {
                    st.name: list((m.resolved_events or {}).get(st.name,
                                                                []))
                    for st in self.pattern.stages}
                out_rows.append(self.select(
                    self._key_values.get(k, k), m, events))
                out_ts.append(m.end_ts)
            if nfa.empty:
                del self._nfas[k]
        for k in [k for k, v in self._pending.items() if not v]:
            del self._pending[k]
        # a key's id->value mapping is only needed while it has live NFA
        # state or buffered events; dropping it with them keeps state (and
        # checkpoints) bounded for high-cardinality keys
        for k in [k for k in self._key_values
                  if k not in self._nfas and k not in self._pending]:
            del self._key_values[k]
        if not out_rows:
            return []
        out = RecordBatch.from_rows(out_rows).with_timestamps(out_ts)
        return [out]

    def close(self) -> List[RecordBatch]:
        # flush everything still buffered (end of input = MAX_WATERMARK
        # already arrived through process_watermark, so usually a no-op)
        return []

    # -- checkpoint ----------------------------------------------------------

    def snapshot_state(self):
        return {
            "nfas": {k: n.snapshot() for k, n in self._nfas.items()},
            "pending": {k: list(v) for k, v in self._pending.items()},
            "key_values": dict(self._key_values),
        }

    def restore_state(self, state):
        self._nfas = {}
        for k, snap in state.get("nfas", {}).items():
            nfa = KeyNFA(self.pattern)
            nfa.restore(snap)
            self._nfas[int(k)] = nfa
        self._pending = {int(k): [tuple(e) for e in v]
                         for k, v in state.get("pending", {}).items()}
        self._key_values = dict(state.get("key_values", {}))


class CEP:
    """Entry point (reference: flink-cep/.../CEP.java + PatternStream)."""

    @staticmethod
    def pattern(keyed_stream, pattern: Pattern) -> "PatternStream":
        return PatternStream(keyed_stream, pattern)


class PatternStream:
    def __init__(self, keyed_stream, pattern: Pattern):
        self.keyed = keyed_stream
        self.pattern = pattern

    def select(self, fn: Optional[Callable] = None, name: str = "cep"):
        from flink_tpu_torch.datastream.stream import DataStream
        from flink_tpu_torch.graph.transformations import Transformation

        pattern, key_field = self.pattern, self.keyed.key_field
        t = Transformation(
            name=name, kind="one_input",
            operator_factory=lambda: CepOperator(pattern, key_field,
                                                 select=fn),
            inputs=[self.keyed.transformation], keyed=True,
            key_field=key_field)
        return DataStream(self.keyed.env, t)
