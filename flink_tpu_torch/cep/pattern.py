"""CEP Pattern API (port of ``flink_tpu/cep/pattern.py``, host only).

reference: flink-libraries/flink-cep/.../pattern/Pattern.java (begin/next/
followedBy/where/times/oneOrMore/optional/within) and
AfterMatchSkipStrategy.java.

Re-design: conditions are *vectorized* — a condition is a function
``batch -> bool mask`` evaluated once per micro-batch for all events (the
expensive part), so the per-event NFA loop only reads precomputed booleans.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional

import numpy as np

from flink_tpu_torch.core.records import RecordBatch


class Contiguity(enum.Enum):
    STRICT = "next"  # reference: Pattern.next
    RELAXED = "followed_by"  # reference: Pattern.followedBy


class AfterMatchSkipStrategy(enum.Enum):
    """reference: cep/nfa/aftermatch/AfterMatchSkipStrategy.java."""

    NO_SKIP = "no_skip"
    SKIP_PAST_LAST_EVENT = "skip_past_last_event"


@dataclasses.dataclass
class Stage:
    name: str
    condition: Optional[Callable[[RecordBatch], np.ndarray]] = None
    contiguity: Contiguity = Contiguity.STRICT
    min_times: int = 1
    max_times: Optional[int] = 1  # None = unbounded (oneOrMore)
    # loop-internal contiguity of times()/one_or_more(); the reference
    # defaults to relaxed, .consecutive() opts into strict
    consecutive_internal: bool = False
    # allowCombinations(): a matching event may ALSO be skipped inside the
    # loop, yielding non-adjacent combinations (reference: followedByAny
    # internal strategy)
    combinations: bool = False
    #: negative pattern (notNext / notFollowedBy): an event matching this
    #: stage's condition INVALIDATES partial matches instead of extending
    #: them (reference: Pattern.notNext/notFollowedBy + NotCondition)
    negated: bool = False
    #: oneOrMore().until(cond): the loop stops accepting events once an
    #: event satisfies cond (the until event itself is not consumed by the
    #: loop; reference: Pattern.until / IterativeCondition stop condition)
    until_condition: Optional[Callable[[RecordBatch], np.ndarray]] = None
    #: greedy(): the loop consumes as many matching events as possible —
    #: an event matching the loop condition can neither be taken nor
    #: ignored by the FOLLOWING stage's fresh waiting state (reference:
    #: Quantifier.greedy + NFACompiler.updateWithGreedyCondition)
    greedy: bool = False
    #: iterative (match-context) condition evaluated per (event, partial)
    #: with access to the events already taken — reference:
    #: IterativeCondition.filter(event, ctx). ANDed with ``condition``.
    iterative_condition: Optional[Callable] = None

    def evaluate(self, batch: RecordBatch) -> np.ndarray:
        if self.condition is None:
            return np.ones(len(batch), dtype=bool)
        return np.asarray(self.condition(batch), dtype=bool)


class Pattern:
    """Fluent pattern builder.

    Example (reference docs' canonical fraud pattern)::

        Pattern.begin("small").where(lambda b: b["amount"] < 1.0) \\
               .next("big").where(lambda b: b["amount"] > 500.0) \\
               .within(60_000)
    """

    def __init__(self, stages: List[Stage], within_ms: Optional[int] = None,
                 skip: AfterMatchSkipStrategy = AfterMatchSkipStrategy.NO_SKIP):
        self.stages = stages
        self.within_ms = within_ms
        self.skip = skip

    # -- construction --------------------------------------------------------

    @staticmethod
    def begin(name: str,
              skip: AfterMatchSkipStrategy = AfterMatchSkipStrategy.NO_SKIP
              ) -> "Pattern":
        return Pattern([Stage(name)], skip=skip)

    # Builder methods are persistent: each returns a NEW Pattern (stages are
    # never mutated in place), so a shared prefix can safely branch into
    # several derived patterns — the same linked-object semantics as the
    # reference's Pattern.next/followedBy returning fresh Pattern nodes.

    def _append(self, stage: Stage) -> "Pattern":
        return Pattern(self.stages + [stage], self.within_ms, self.skip)

    def _amend_last(self, **changes) -> "Pattern":
        stages = self.stages[:-1] + [
            dataclasses.replace(self.stages[-1], **changes)]
        return Pattern(stages, self.within_ms, self.skip)

    def next(self, name: str) -> "Pattern":
        return self._append(Stage(name, contiguity=Contiguity.STRICT))

    def followed_by(self, name: str) -> "Pattern":
        return self._append(Stage(name, contiguity=Contiguity.RELAXED))

    def not_next(self, name: str) -> "Pattern":
        """The event immediately after the previous stage's match must NOT
        satisfy this stage (reference: Pattern.notNext)."""
        return self._append(Stage(name, contiguity=Contiguity.STRICT,
                                  negated=True))

    def not_followed_by(self, name: str) -> "Pattern":
        """No event between the previous stage's match and the following
        stage's match may satisfy this stage (reference:
        Pattern.notFollowedBy). As the LAST stage it requires within():
        the match emits once the window expires without the forbidden
        event."""
        return self._append(Stage(name, contiguity=Contiguity.RELAXED,
                                  negated=True))

    # -- stage modifiers (apply to the LAST stage) ---------------------------

    def where(self, condition: Callable[[RecordBatch], np.ndarray]
              ) -> "Pattern":
        prev = self.stages[-1].condition
        if prev is None:
            combined = condition
        else:  # multiple where() = AND (reference: RichAndCondition)
            def combined(b, prev=prev, cond=condition):
                return (np.asarray(prev(b), dtype=bool)
                        & np.asarray(cond(b), dtype=bool))
        return self._amend_last(condition=combined)

    def or_where(self, condition) -> "Pattern":
        prev = (self.stages[-1].condition
                or (lambda b: np.zeros(len(b), dtype=bool)))

        def combined(b, prev=prev, cond=condition):
            return (np.asarray(prev(b), dtype=bool)
                    | np.asarray(cond(b), dtype=bool))

        return self._amend_last(condition=combined)

    def times(self, n: int, max_n: Optional[int] = None) -> "Pattern":
        return self._amend_last(min_times=n,
                                max_times=n if max_n is None else max_n)

    def one_or_more(self) -> "Pattern":
        return self._amend_last(min_times=1, max_times=None)

    def times_or_more(self, n: int) -> "Pattern":
        """At least n takes, unbounded above (reference:
        Pattern.timesOrMore)."""
        return self._amend_last(min_times=n, max_times=None)

    def until(self, condition: Callable[[RecordBatch], np.ndarray]
              ) -> "Pattern":
        """Stop the last stage's loop once an event satisfies
        ``condition`` (reference: Pattern.until — only meaningful on an
        unbounded quantifier)."""
        if self.stages[-1].max_times is not None:
            raise ValueError("until() applies to oneOrMore()/"
                             "timesOrMore() stages")
        return self._amend_last(until_condition=condition)

    def allow_combinations(self) -> "Pattern":
        """reference: Pattern.allowCombinations()."""
        return self._amend_last(combinations=True)

    def greedy(self) -> "Pattern":
        """The loop consumes as many matching events as possible before
        the next stage may proceed (reference: Pattern.greedy() — only
        meaningful on a times()/oneOrMore() loop whose condition overlaps
        the following stage's)."""
        last = self.stages[-1]
        if last.max_times == 1:
            raise ValueError(
                "greedy() applies to times()/oneOrMore() loop stages")
        if last.combinations:
            raise ValueError(
                "greedy() cannot combine with allowCombinations() "
                "(reference restriction)")
        return self._amend_last(greedy=True)

    def where_iterative(self, condition: Callable) -> "Pattern":
        """Match-context condition ``fn(event_row, ctx) -> bool`` where
        ``ctx.events_for(stage_name)`` returns the events the partial
        match has already taken for a stage (reference:
        IterativeCondition.filter(value, ctx) /
        ctx.getEventsForPattern). ANDed with any vectorized where()."""
        prev = self.stages[-1].iterative_condition
        if prev is None:
            combined = condition
        else:
            def combined(ev, ctx, prev=prev, cond=condition):
                return bool(prev(ev, ctx)) and bool(cond(ev, ctx))
        return self._amend_last(iterative_condition=combined)

    def consecutive(self) -> "Pattern":
        """reference: Pattern.consecutive() — strict contiguity inside a
        times()/oneOrMore() loop."""
        return self._amend_last(consecutive_internal=True)

    def optional(self) -> "Pattern":
        return self._amend_last(min_times=0)

    def within(self, ms: int) -> "Pattern":
        return Pattern(self.stages, ms, self.skip)

    def with_skip_strategy(self, skip: AfterMatchSkipStrategy) -> "Pattern":
        return Pattern(self.stages, self.within_ms, skip)

    # -- validation ----------------------------------------------------------

    def validate(self) -> "Pattern":
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        positives = [s for s in self.stages if not s.negated]
        if not positives:
            raise ValueError("pattern needs at least one positive stage")
        if all(s.min_times == 0 for s in positives):
            raise ValueError("pattern cannot be entirely optional")
        if self.stages[0].negated:
            raise ValueError("a pattern cannot begin with notNext/"
                             "notFollowedBy (reference restriction)")
        for s in self.stages:
            if s.negated and (s.min_times != 1 or s.max_times != 1
                              or s.combinations):
                raise ValueError(
                    f"negative stage {s.name!r} cannot carry quantifiers "
                    "(reference: not-patterns reject oneOrMore/times)")
            if s.negated and s.condition is None:
                raise ValueError(
                    f"negative stage {s.name!r} needs a where() condition")
        for i, s in enumerate(self.stages[:-1]):
            nxt = self.stages[i + 1]
            if s.negated and not nxt.negated and nxt.min_times == 0:
                raise ValueError(
                    f"negative stage {s.name!r} cannot precede optional "
                    f"stage {nxt.name!r}: the branch that skips the "
                    "optional stage would lose the guard (reference: "
                    "notFollowedBy/notNext before optional is rejected)")
        if self.stages[-1].negated:
            if self.stages[-1].contiguity is Contiguity.STRICT:
                raise ValueError("a pattern cannot end with notNext "
                                 "(reference restriction)")
            if self.within_ms is None:
                raise ValueError(
                    "a pattern ending with notFollowedBy requires "
                    "within() — the match emits at window expiry "
                    "(reference restriction)")
        return self
