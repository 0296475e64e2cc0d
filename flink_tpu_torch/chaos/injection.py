"""Deterministic, seeded fault injection (port of
``flink_tpu/chaos/injection.py``; host code with the same behaviour).

- Code under test declares **named fault points**:
  ``chaos.fault_point("shuffle.device_exchange", records=n)``. With no
  controller armed the call is a no-op costing one module-global load and
  a ``None`` check.
- A :class:`FaultPlan` maps point-name PATTERNS (fnmatch) to seeded
  schedules and fault kinds. A run is reproducible from ``(plan, seed)``:
  nth-hit schedules count matching hits, and the probabilistic schedule
  draws from a per-rule PRNG seeded with ``(seed, crc32(pattern),
  rule_index)`` — the reference's draws, never the global RNG.
- Fault kinds: ``raise`` (an :class:`InjectedFault`, optionally
  ``recoverable`` for the retry wrapper), ``delay`` (sleep ``delay_ms``),
  and the payload kinds ``drop`` / ``duplicate`` / ``corrupt`` which the
  instrumented site applies itself.
- Recoverable I/O sites (spill page reloads, checkpoint storage) wrap
  their attempt in :func:`run_recoverable`, which retries transient
  ``InjectedFault``s with the reference's exponential backoff and counts
  ``retries`` / ``recoveries``.

``register_chaos_metrics`` puts the armed controller's counters on a
job's metric tree (``job.<name>.chaos``), and every injection lands a
``chaos.inject`` instant in the flight recorder's timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from fnmatch import fnmatchcase
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

import numpy as np

T = TypeVar("T")

#: fault kinds a plain (non-payload) fault point honors
POINT_KINDS = ("raise", "delay")
#: additional kinds only a payload-carrying site can apply
PAYLOAD_KINDS = ("drop", "duplicate", "corrupt")
FAULT_KINDS = POINT_KINDS + PAYLOAD_KINDS


class InjectedFault(RuntimeError):
    """A fault raised by the chaos controller at a named fault point.

    ``recoverable`` marks transient faults the site-local retry wrapper
    (:func:`run_recoverable`) may absorb; everything else propagates as
    a process/task crash for the failover layers (restart strategies,
    the chaos harness) to handle.
    """

    def __init__(self, point: str, rule: "FaultRule",
                 recoverable: bool = False) -> None:
        super().__init__(
            f"injected fault at {point!r} (rule {rule.pattern!r}"
            f"{', recoverable' if recoverable else ''})")
        self.point = point
        self.rule = rule
        self.recoverable = recoverable


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One pattern -> schedule -> fault-kind mapping.

    Schedule semantics (hits are counted per rule, over the calls whose
    point name matches ``pattern`` AND whose context matches ``where``):

    - ``nth``   inject on exactly the nth matching hit (1-based)
    - ``every`` inject on every ``every``-th matching hit
    - ``prob``  inject each hit with this probability (per-rule PRNG)

    ``max_injections`` bounds total injections (default 1 — the "once"
    schedule; 0 = unlimited). ``where`` filters on fault-point context,
    e.g. ``{"shard": 3}`` pins a rule to one shard's calls.
    """

    pattern: str
    kind: str = "raise"
    nth: int = 0
    every: int = 0
    prob: float = 0.0
    max_injections: int = 1
    delay_ms: float = 0.0
    recoverable: bool = False
    where: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if not (self.nth or self.every or self.prob):
            raise ValueError(
                f"rule {self.pattern!r} has no schedule: set nth, every "
                "or prob")
        if isinstance(self.where, dict):  # ergonomic: accept a dict
            object.__setattr__(self, "where", tuple(sorted(
                self.where.items())))


@dataclasses.dataclass
class FaultPlan:
    """An ordered rule list plus the retry policy for recoverable sites.

    The FIRST matching rule that triggers wins a given hit. Retry
    backoff defaults keep tests fast (sub-millisecond waits) while
    still exercising the exponential-delay strategy for real.
    """

    rules: List[FaultRule] = dataclasses.field(default_factory=list)
    retry_max_attempts: int = 4
    retry_initial_ms: int = 0
    retry_max_ms: int = 8
    #: PROCESS-LEVEL retry budget across ALL recoverable sites (0 =
    #: unlimited): per-site backoff bounds one site's attempts, but a
    #: permanently failing tier that keeps "recovering" elsewhere would
    #: otherwise retry forever. When the global budget is spent, the
    #: next recoverable fault ESCALATES to a real (non-recoverable)
    #: failure — the same declare-dead discipline the device watchdog
    #: applies to persistently slow shards, extended to soft faults.
    retry_budget_total: int = 0

    @staticmethod
    def from_spec(spec) -> "FaultPlan":
        """Build from a list of dicts (the JSON/CLI-friendly form):
        ``[{"pattern": "spill.page_reload", "nth": 3,
        "kind": "raise", "recoverable": True}, ...]``."""
        return FaultPlan(rules=[FaultRule(**r) for r in spec])

    def describe(self) -> List[str]:
        out = []
        for r in self.rules:
            sched = (f"nth={r.nth}" if r.nth else
                     f"every={r.every}" if r.every else f"prob={r.prob}")
            out.append(f"{r.pattern} -> {r.kind} ({sched}, "
                       f"max={r.max_injections or 'inf'})")
        return out


class ExponentialBackoff:
    """The retry policy of :func:`run_recoverable`: the reference's
    ``ExponentialDelayRestartStrategy`` without jitter and quiet-period
    reset (the chaos controller uses neither) — the backoff doubles per
    failure up to ``max_ms``, and ``max_attempts`` failures end the
    retries."""

    def __init__(self, initial_ms: int, max_ms: int, max_attempts: int,
                 multiplier: float = 2.0) -> None:
        self.initial_ms = initial_ms
        self.max_ms = max_ms
        self.multiplier = multiplier
        self.max_attempts = max_attempts
        self.attempts = 0
        self._current = initial_ms

    def notify_failure(self) -> None:
        if self.attempts > 0:
            self._current = min(self.max_ms,
                                int(self._current * self.multiplier))
        self.attempts += 1

    def can_restart(self) -> bool:
        return self.attempts < self.max_attempts

    def backoff_ms(self) -> int:
        return self._current


class ChaosController:
    """Process-global fault decision engine (see module docstring).

    The controller survives engine kill/rebuild cycles within one armed
    session, so hit counters and ``faults_injected`` accumulate across
    crash-restore rounds — exactly what makes an nth-hit crash fire
    once per run instead of once per engine incarnation.
    """

    def __init__(self, plan: FaultPlan, seed: int) -> None:
        self.plan = plan
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits = [0] * len(plan.rules)
        self._injections = [0] * len(plan.rules)
        self._rngs = [
            np.random.default_rng(
                [self.seed, zlib.crc32(r.pattern.encode()), i])
            for i, r in enumerate(plan.rules)
        ]
        #: point name -> number of faults actually injected there
        self.faults_injected: Dict[str, int] = {}
        #: hits observed per point name (armed only; for reachability
        #: assertions and plan debugging)
        self.points_hit: Dict[str, int] = {}
        self.retries = 0
        self.recoveries = 0
        #: recoverable faults escalated to real failures because the
        #: process-level retry budget was exhausted
        self.budget_exhausted = 0

    def consume_retry_budget(self) -> bool:
        """Account one retry against the process-level budget; False
        means the budget is spent and the fault must escalate."""
        with self._lock:
            total = self.plan.retry_budget_total
            if total and self.retries >= total:
                self.budget_exhausted += 1
                return False
            self.retries += 1
            return True

    # ------------------------------------------------------------- decisions

    def _decide(self, point: str, ctx: Dict[str, Any],
                kinds: Tuple[str, ...]) -> Optional[FaultRule]:
        with self._lock:
            self.points_hit[point] = self.points_hit.get(point, 0) + 1
            for i, rule in enumerate(self.plan.rules):
                if rule.kind not in kinds:
                    continue
                if not fnmatchcase(point, rule.pattern):
                    continue
                if rule.where and any(
                        ctx.get(k) != v for k, v in rule.where):
                    continue
                self._hits[i] += 1
                h = self._hits[i]
                if rule.max_injections and \
                        self._injections[i] >= rule.max_injections:
                    continue
                fire = bool(
                    (rule.nth and h == rule.nth)
                    or (rule.every and h % rule.every == 0)
                    or (rule.prob
                        and self._rngs[i].random() < rule.prob))
                if fire:
                    self._injections[i] += 1
                    self.faults_injected[point] = \
                        self.faults_injected.get(point, 0) + 1
                    # the injection in the flight recorder's timeline,
                    # under the span that was open when it fired
                    from flink_tpu_torch.observe import (
                        flight_recorder as flight,
                    )

                    flight.instant(
                        "chaos.inject",
                        shard=int(ctx.get("shard", -1))
                        if isinstance(ctx.get("shard"), int) else -1)
                    return rule
            return None

    def _apply_point(self, point: str, ctx: Dict[str, Any]) -> None:
        rule = self._decide(point, ctx, POINT_KINDS)
        if rule is None:
            return
        if rule.kind == "delay":
            time.sleep(rule.delay_ms / 1000.0)
            return
        raise InjectedFault(point, rule, recoverable=rule.recoverable)

    def _apply_payload(self, point: str, ctx: Dict[str, Any],
                       kinds: Tuple[str, ...]) -> Optional[FaultRule]:
        rule = self._decide(point, ctx, kinds)
        if rule is None:
            return None
        if rule.kind == "delay":
            time.sleep(rule.delay_ms / 1000.0)
            return None
        if rule.kind == "raise":
            raise InjectedFault(point, rule, recoverable=rule.recoverable)
        return rule  # drop / duplicate / corrupt: the site applies it

    def note_recovery(self) -> None:
        """Count a site-local recovery (a fault absorbed without
        retrying, e.g. a safely-skipped compaction)."""
        with self._lock:
            self.recoveries += 1

    def make_retry_strategy(self) -> "ExponentialBackoff":
        return ExponentialBackoff(
            initial_ms=self.plan.retry_initial_ms,
            max_ms=self.plan.retry_max_ms,
            max_attempts=self.plan.retry_max_attempts)

    def counters(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "faults_injected": dict(self.faults_injected),
                "faults_injected_total":
                    sum(self.faults_injected.values()),
                "retries": self.retries,
                "recoveries": self.recoveries,
                "retry_budget_exhausted": self.budget_exhausted,
            }


#: THE process-global controller slot. None = disarmed; every fault
#: point is then one load + one is-None check.
_controller: Optional[ChaosController] = None


def armed() -> bool:
    return _controller is not None


def controller() -> Optional[ChaosController]:
    return _controller


def arm(plan: FaultPlan, seed: int) -> ChaosController:
    global _controller
    if _controller is not None:
        raise RuntimeError("chaos controller already armed — disarm() "
                           "first (plans do not stack)")
    _controller = ChaosController(plan, seed)
    return _controller


def disarm() -> Optional[ChaosController]:
    """Disarm and return the controller (its counters stay readable)."""
    global _controller
    c = _controller
    _controller = None
    return c


@contextlib.contextmanager
def chaos_active(plan: FaultPlan, seed: int):
    c = arm(plan, seed)
    try:
        yield c
    finally:
        disarm()


# --------------------------------------------------------------- fault APIs


def fault_point(point: str, **ctx) -> None:
    """Declare a named fault point: may raise InjectedFault or sleep.

    No-op when disarmed. ``ctx`` kwargs (e.g. ``shard=3``) are matched
    against rules' ``where`` filters."""
    c = _controller
    if c is None:
        return
    c._apply_point(point, ctx)


def payload_action(point: str, kinds: Tuple[str, ...] = FAULT_KINDS,
                   **ctx) -> Optional[FaultRule]:
    """A fault point whose site carries a payload it can drop,
    duplicate or corrupt: returns the triggered drop/duplicate/corrupt
    rule for the CALLER to apply, after handling raise/delay kinds
    itself. ``kinds`` restricts which fault kinds the site supports —
    e.g. a post-rename tear point only accepts ("drop", "corrupt"),
    because raising there would model a failure that never existed
    (the checkpoint IS durable). Returns None when disarmed or nothing
    triggered."""
    c = _controller
    if c is None:
        return None
    return c._apply_payload(point, ctx, kinds)


class RetryBudgetExhaustedError(RuntimeError):
    """The process-level retry budget is spent: a recoverable fault
    escalated to a real failure (permanent soft fault — e.g. a spill
    tier that never stops failing). Carries the original fault."""

    def __init__(self, point: str, fault: InjectedFault) -> None:
        super().__init__(
            f"global retry budget exhausted at {point!r}: recoverable "
            f"fault escalated to a real failure ({fault})")
        self.point = point
        self.fault = fault


def run_recoverable(point: str, fn: Callable[[], T]) -> T:
    """Run ``fn``, retrying transient (``recoverable``) InjectedFaults
    with :class:`ExponentialBackoff`; counts retries and (on eventual
    success) recoveries. Non-recoverable faults and exhausted per-site
    budgets propagate — they are the crash path. The PROCESS-LEVEL
    budget (``FaultPlan.retry_budget_total``) bounds total retries
    across all sites: once spent, the next recoverable fault escalates
    as :class:`RetryBudgetExhaustedError` instead of retrying forever
    (counted in ``retry_budget_exhausted``)."""
    c = _controller
    if c is None:
        return fn()
    strategy = c.make_retry_strategy()
    retried = False
    while True:
        try:
            out = fn()
            if retried:
                with c._lock:
                    c.recoveries += 1
            return out
        except InjectedFault as f:
            if not f.recoverable:
                raise
            strategy.notify_failure()
            if not strategy.can_restart():
                raise
            if not c.consume_retry_budget():
                raise RetryBudgetExhaustedError(point, f) from f
            retried = True
            backoff = strategy.backoff_ms()
            if backoff:
                time.sleep(backoff / 1000.0)


def io_point(point: str, **ctx) -> None:
    """A recoverable-I/O fault point: transient injected failures retry
    with backoff in place (the storage/spill contract); persistent ones
    raise. No-op when disarmed."""
    c = _controller
    if c is None:
        return
    run_recoverable(point, lambda: fault_point(point, **ctx))


def register_chaos_metrics(group) -> None:
    """Register the armed controller's counters as gauges on an
    existing MetricGroup (job -> chaos scope). Values are read live at
    report time, so gauges registered at job start see every later
    injection. No-op when disarmed."""
    c = _controller
    if c is None:
        return
    g = group.add_group("chaos")
    g.gauge("faults_injected",
            lambda c=c: sum(c.faults_injected.values()))
    g.gauge("retries", lambda c=c: c.retries)
    g.gauge("recoveries", lambda c=c: c.recoveries)
    g.gauge("points_hit", lambda c=c: sum(c.points_hit.values()))
    g.gauge("retry_budget_exhausted", lambda c=c: c.budget_exhausted)
