"""NFA runtime for CEP pattern matching (port of ``flink_tpu/cep/nfa.py``:
the host NFA, the semantics oracle of every pattern).

reference: flink-cep/.../nfa/NFA.java (946 LoC), ComputationState.java,
SharedBuffer. The reference threads one event at a time through versioned
computation states (TAKE / IGNORE / PROCEED transitions) over a shared
event buffer.

Re-design: conditions were already evaluated batch-wide (a bool matrix
[events x stages]); the NFA advance loop per key reads only those booleans
and event timestamps. Partial matches keep indices into a per-key event
log (the SharedBuffer analog — events stored once, matches reference them).

Semantics kept from the reference:
- between-stage contiguity: ``next`` (strict — a miss kills the waiting
  partial) vs ``followedBy`` (relaxed — misses are ignored);
- loop-internal contiguity of ``times``/``oneOrMore`` is relaxed unless
  ``consecutive()`` (reference: Quantifier.ConsecutiveStrategy);
- every event may begin a new match (start state always active), including
  at stages reachable through an all-optional prefix;
- a match completes as soon as the remaining suffix is all-optional;
- ``within`` prunes partials whose span exceeds the window;
- after-match skip: NO_SKIP emits every combination, SKIP_PAST_LAST_EVENT
  discards partials and events inside the matched span;
- negative patterns compile into GUARDS on the following positive stage
  (notNext: the first event after arrival must not match; notFollowedBy:
  no event before the stage's first take may match — reference:
  NotCondition edges); a TRAILING notFollowedBy holds completed matches
  until the within-window expires, then emits (reference: timestamped
  releases of not-followed-by matches);
- ``until`` gates further loop takes once its condition fires.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.cep.pattern import (
    AfterMatchSkipStrategy,
    Contiguity,
    Pattern,
)

_VIRTUAL = -(1 << 62)  # start_ts marker for the always-active start state


@dataclasses.dataclass
class _Partial:
    """One computation state (reference: ComputationState.java)."""

    stage: int  # index into the EXEC (positive) stage list
    count: int  # takes in the current stage
    events: Tuple[Tuple[int, int], ...]  # (exec_stage_idx, event_log_idx)
    start_ts: int
    #: log index of the event whose processing created this partial (the
    #: strict notNext guard applies only to the event right after it)
    arrived: int = _VIRTUAL

    def key(self):
        return (self.stage, self.count, self.events)


@dataclasses.dataclass
class _ExecStage:
    """A positive stage with its compiled pre-guards. ``pre_negs`` holds
    (original stage index, strict) for each negative stage the pattern
    placed immediately before this one; ``tail_negative`` marks the
    synthetic wait-state a trailing notFollowedBy compiles into."""

    stage: object  # the positive Stage (None for the synthetic tail)
    orig_idx: int  # condition column in the operator's hit matrix (-1 tail)
    pre_negs: List[Tuple[int, bool]] = dataclasses.field(
        default_factory=list)
    tail_negative: bool = False


def compile_stages(pattern: Pattern) -> List[_ExecStage]:
    out: List[_ExecStage] = []
    pending_negs: List[Tuple[int, bool]] = []
    for i, st in enumerate(pattern.stages):
        if st.negated:
            pending_negs.append((i, st.contiguity is Contiguity.STRICT))
            continue
        out.append(_ExecStage(st, i, pending_negs))
        pending_negs = []
    if pending_negs:
        # trailing notFollowedBy: a wait-state released by within expiry
        out.append(_ExecStage(None, -1, pending_negs, tail_negative=True))
    return out


class IterativeContext:
    """What an iterative condition may read: the events the partial match
    has already taken, by stage name (reference:
    IterativeCondition.Context.getEventsForPattern)."""

    def __init__(self, nfa: "KeyNFA", partial: "_Partial"):
        self._nfa = nfa
        self._partial = partial

    def events_for(self, name: str) -> List[dict]:
        nfa = self._nfa
        return [nfa.event(ei) for si, ei in self._partial.events
                if nfa.exec_stages[si].stage.name == name]


@dataclasses.dataclass
class Match:
    start_ts: int
    end_ts: int
    # stage name -> list of event-log indices
    events_by_stage: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    #: pre-resolved events for matches released by prune() (their log
    #: entries may be compacted in the same call); None otherwise
    resolved_events: Optional[Dict[str, List[dict]]] = None


class KeyNFA:
    """Per-key NFA instance: event log + live partial matches."""

    def __init__(self, pattern: Pattern):
        self.pattern = pattern
        self.exec_stages = compile_stages(pattern)
        # the SharedBuffer analog: events stored once, referenced by index.
        # Indices are absolute; the log is compacted by rebasing on _log_base
        # (prune()) so long-running keys don't grow without bound.
        self.event_log: List[dict] = []
        self._log_base = 0
        self.partials: List[_Partial] = []
        # suffix_optional[j] == True iff all exec stages AFTER j are
        # optional (the synthetic tail-negative stage is NOT optional: it
        # must be waited out)
        n = len(self.exec_stages)
        self._suffix_optional = [True] * n
        for j in range(n - 2, -1, -1):
            nxt = self.exec_stages[j + 1]
            self._suffix_optional[j] = (
                self._suffix_optional[j + 1]
                and not nxt.tail_negative
                and nxt.stage.min_times == 0)
        # exec stage index -> until-condition column offset (appended
        # after the pattern-stage columns in the operator's hit matrix)
        self._until_col: Dict[int, int] = {}
        k = 0
        for j, es in enumerate(self.exec_stages):
            if not es.tail_negative \
                    and es.stage.until_condition is not None:
                self._until_col[j] = k
                k += 1

    def _start_stages(self) -> List[int]:
        """Exec-stage indices a fresh match may begin at (0 plus the
        stages behind an all-optional prefix)."""
        out = [0]
        for j, es in enumerate(self.exec_stages[:-1]):
            if not es.tail_negative and es.stage.min_times == 0:
                out.append(j + 1)
            else:
                break
        return out

    # -- advance -------------------------------------------------------------

    def advance(self, event: dict, ts: int,
                stage_hits: List[bool]) -> List[Match]:
        """Feed one event (with precomputed per-stage condition booleans;
        until-condition columns appended after the pattern stages);
        returns completed matches."""
        exec_stages = self.exec_stages
        within = self.pattern.within_ms
        n_stages = len(self.pattern.stages)
        skip_past = (self.pattern.skip
                     is AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT)

        log_idx = self._log_base + len(self.event_log)
        self.event_log.append(event)
        matches: List[Match] = []
        new_partials: List[_Partial] = []
        seen = set()

        def emit(start_ts: int, taken, end_ts: int = ts) -> None:
            by_stage: Dict[str, List[int]] = {}
            for si, ei in taken:
                by_stage.setdefault(exec_stages[si].stage.name,
                                    []).append(ei)
            matches.append(Match(start_ts, end_ts, by_stage))

        def add(p: _Partial) -> None:
            k = p.key()
            if k not in seen:
                seen.add(k)
                new_partials.append(p)

        candidates = list(self.partials) + [
            _Partial(j, 0, (), _VIRTUAL) for j in self._start_stages()]

        matched_now = False
        for p in candidates:
            virtual = p.start_ts == _VIRTUAL
            st = exec_stages[p.stage]
            if (not virtual and within is not None
                    and ts - p.start_ts > within):
                if st.tail_negative:
                    # a trailing notFollowedBy survived its whole window:
                    # the match releases at the expiry timestamp. This
                    # does NOT trigger skip-past pruning — the released
                    # span lies entirely before the current event, so
                    # partials this event starts are outside it.
                    emit(p.start_ts, p.events, end_ts=p.start_ts + within)
                continue  # timed out (reference: pruning on within)
            # pre-guards: negative stages compiled onto this stage apply
            # while it has not taken yet (notNext only to the event right
            # after arrival — reference: NotCondition edges)
            if p.count == 0 and st.pre_negs and not virtual:
                killed = False
                for neg_idx, strict in st.pre_negs:
                    if strict and log_idx != p.arrived + 1:
                        continue
                    if bool(stage_hits[neg_idx]):
                        killed = True
                        break
                if killed:
                    continue
            if st.tail_negative:
                add(p)  # waiting out the window (guards checked above)
                continue
            if not virtual and p.count == 0 and p.stage > 0:
                prev = exec_stages[p.stage - 1]
                if not prev.tail_negative and prev.stage.greedy:
                    # the gate only applies while the loop can still TAKE
                    # (reference: greedy guards edges of live loop
                    # states): a saturated loop (taken == max_times)
                    # cannot claim the event, so the waiting state must
                    # keep its normal take/ignore behavior
                    taken_in_loop = sum(
                        1 for si, _ in p.events if si == p.stage - 1)
                    saturated = (prev.stage.max_times is not None
                                 and taken_in_loop
                                 >= prev.stage.max_times)
                    prev_hit = (not saturated
                                and bool(stage_hits[prev.orig_idx]))
                    if prev_hit and \
                            prev.stage.iterative_condition is not None:
                        # the proceed partial carries the loop's taken
                        # events, so its context evaluates the loop's
                        # match-dependent condition exactly
                        prev_hit = bool(prev.stage.iterative_condition(
                            event, IterativeContext(self, p)))
                    if prev_hit and not (
                            prev.stage.until_condition is not None
                            and bool(stage_hits[
                                n_stages
                                + self._until_col[p.stage - 1]])):
                        # greedy loop behind this fresh waiting state
                        # claims the event: the shorter-prefix branch can
                        # neither take nor ignore it — it dies, and the
                        # loop's own take spawns the longer-prefix
                        # replacement (reference:
                        # NFACompiler.updateWithGreedyCondition guards
                        # both edges with not(loop condition))
                        continue
            hit = bool(stage_hits[st.orig_idx])
            if hit and st.stage.iterative_condition is not None:
                hit = bool(st.stage.iterative_condition(
                    event, IterativeContext(self, p)))
            until_hit = (st.stage.until_condition is not None
                         and bool(stage_hits[n_stages
                                             + self._until_col[p.stage]]))
            can_take = hit and not until_hit and (
                st.stage.max_times is None
                or p.count < st.stage.max_times)
            if can_take:
                start_ts = ts if virtual else p.start_ts
                taken = p.events + ((p.stage, log_idx),)
                count = p.count + 1
                if count >= st.stage.min_times \
                        and self._suffix_optional[p.stage]:
                    emit(start_ts, taken)
                    matched_now = True
                    if skip_past:
                        break
                if st.stage.max_times is None \
                        or count < st.stage.max_times:
                    add(_Partial(p.stage, count, taken, start_ts,
                                 arrived=log_idx))
                if count >= st.stage.min_times:
                    # PROCEED: wait in the next stage, chaining past any
                    # optional stages (each may be skipped entirely)
                    j = p.stage + 1
                    while j < len(exec_stages):
                        add(_Partial(j, 0, taken, start_ts,
                                     arrived=log_idx))
                        nxt = exec_stages[j]
                        if not nxt.tail_negative \
                                and nxt.stage.min_times == 0:
                            j += 1
                        else:
                            break
                if st.stage.combinations and not virtual and p.count > 0:
                    add(p)  # allowCombinations: also skip the match event
            elif virtual:
                continue  # a start that doesn't start is nothing
            elif not hit or until_hit:
                if until_hit:
                    # the stop condition closes the loop for good: a
                    # waiting partial (any count) can never take again —
                    # satisfied loops live on through the proceed
                    # branches spawned at their last take (reference:
                    # until stops accepting elements into the loop)
                    continue
                if p.count == 0 \
                        and st.stage.contiguity is Contiguity.STRICT \
                        and p.stage > 0:
                    continue  # 'next' stage missed its immediate event
                if p.count > 0 and st.stage.consecutive_internal:
                    continue  # consecutive() loop broken
                add(p)  # IGNORE: keep waiting (relaxed)
            else:
                # hit but the loop is saturated (count == max_times): this
                # partial only survives via the proceed branch spawned at
                # its last take
                continue

        if matched_now and skip_past:
            # discard every other partial match (the reference's
            # skipPastLastEvent prunes computation states, NOT future
            # events — the break above also
            # kept this event out of any new partial
            self.partials = []
            return matches
        self.partials = new_partials
        return matches

    def event(self, abs_idx: int) -> dict:
        return self.event_log[abs_idx - self._log_base]

    def prune(self, watermark: int) -> List[Match]:
        """Drop timed-out partials and compact the event log below the
        lowest index any live partial still references (the reference
        SharedBuffer's ref-counting, done as a rebase). Returns matches
        RELEASED by the pruning: a trailing notFollowedBy partial whose
        window expired without the forbidden event completes here (the
        reference's timestamped not-followed-by releases)."""
        matches: List[Match] = []
        within = self.pattern.within_ms
        if within is not None:
            keep: List[_Partial] = []
            for p in self.partials:
                if watermark - p.start_ts <= within:
                    keep.append(p)
                elif self.exec_stages[p.stage].tail_negative:
                    # resolve events NOW — the compaction below may drop
                    # the log entries this released match references
                    by_stage: Dict[str, List[int]] = {}
                    resolved: Dict[str, List[dict]] = {}
                    for si, ei in p.events:
                        name = self.exec_stages[si].stage.name
                        by_stage.setdefault(name, []).append(ei)
                        resolved.setdefault(name, []).append(self.event(ei))
                    matches.append(Match(p.start_ts, p.start_ts + within,
                                         by_stage, resolved))
            self.partials = keep
        next_idx = self._log_base + len(self.event_log)
        if not self.partials:
            min_ref = next_idx
        else:
            min_ref = min(ei for p in self.partials for _, ei in p.events)
        if min_ref > self._log_base:
            del self.event_log[: min_ref - self._log_base]
            self._log_base = min_ref
        return matches

    @property
    def empty(self) -> bool:
        return not self.partials and not self.event_log

    # -- checkpoint ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "event_log": list(self.event_log),
            "log_base": self._log_base,
            "partials": [dataclasses.asdict(p) for p in self.partials],
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        self.event_log = list(snap["event_log"])
        self._log_base = snap.get("log_base", 0)
        self.partials = [
            _Partial(d["stage"], d["count"],
                     tuple(tuple(e) for e in d["events"]), d["start_ts"],
                     arrived=d.get("arrived", _VIRTUAL))
            for d in snap["partials"]]
