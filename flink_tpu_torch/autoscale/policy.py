"""DS2-style scaling policy (port of ``flink_tpu/autoscale/policy.py``):
the target shard count from observed rates.

Estimate the operator's TRUE processing rate (observed throughput over
the fraction of time it was busy), then size it so the incoming rate plus
a backlog drain fits under a utilization target — with hysteresis,
cooldown, min/max bounds, a skew guard and a fire-latency signal. Pure
arithmetic over a :class:`PolicyInput` with an injectable clock.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


def key_imbalance(shard_resident_rows: Sequence[int]) -> float:
    """max/mean resident rows per shard (1.0 = perfectly balanced) —
    THE skew definition, shared by the engines' gauge and the policy's
    scale-down guard so the number the operator exports is exactly the
    number the guard acts on."""
    rows = list(shard_resident_rows)
    total = sum(rows)
    if not rows or total <= 0:
        return 1.0
    return max(rows) * len(rows) / total


@dataclasses.dataclass
class PolicyInput:
    """One signal sample, pre-aggregated over the sampling window."""

    current_shards: int
    #: records/s actually processed over the window
    processing_rate: float = 0.0
    #: fraction of wall time the operator was busy (0..1) — the DS2
    #: "useful time" denominator
    busy_fraction: float = 0.0
    #: instantaneous backlog (records queued upstream of the operator)
    backlog: float = 0.0
    #: records/s the backlog GREW over the window (negative = draining)
    backlog_growth: float = 0.0
    #: device-resident rows per shard (the key-imbalance signal)
    shard_resident_rows: Sequence[int] = ()
    #: recent window-fire p99 in wall-clock ms (0 = no fires observed)
    #: — the SECOND signal next to backlog: sustained misses of the
    #: fire deadline are a capacity problem even when throughput keeps
    #: up (the latency tier's autoscale hook, ROADMAP item 1)
    fire_latency_p99_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class Decision:
    """target == current means "stay"; ``reason`` says why."""

    target: int
    reason: str

    @property
    def rescale(self) -> bool:
        return self.reason not in _STAY_REASONS


_STAY_REASONS = ("no-signal", "steady", "hysteresis", "cooldown",
                 "imbalance", "fire-latency-hold")


class ScalingPolicy:
    """Target shard count under a utilization target, with hysteresis,
    cooldown, min/max bounds and a skew guard.

    - **utilization_target**: size the operator so busy fraction lands
      here (0.7 default — headroom absorbs bursts without rescaling).
    - **hysteresis**: ignore targets within this relative band of the
      current size (a 10%% rate wobble must not flap the mesh).
    - **cooldown_s**: minimum time between rescales (state migration is
      cheap but not free; reference: the k8s autoscaler's
      scaling-interval).
    - **min/max_shards**: hard bounds; enforced immediately (out-of-
      bounds current size rescales on the next tick regardless of
      rates — the operator may have been deployed before the bounds).
    - **imbalance_limit**: refuse to scale DOWN while
      max/mean resident rows per shard exceeds it — a hot shard under
      skew is not spare capacity, and fewer shards concentrate the same
      keys harder.
    - **backlog_drain_s**: extra capacity is provisioned to drain the
      standing backlog within this horizon.
    - **fire_deadline_ms / fire_breach_ticks**: the fire-latency
      signal. When a deadline is set (> 0) and the sampled window-fire
      p99 exceeds it for ``fire_breach_ticks`` CONSECUTIVE decisions,
      scale up by half the current size even though the rate signal
      says steady — a sustained deadline miss means fires are queueing
      behind ingest, which more shards (smaller per-shard deltas)
      relieve. While any breach streak is active, scale-DOWN decisions
      are vetoed (a deadline-missing operator is not overprovisioned).

    ``clock`` is injectable (unit tests pass a fake); cooldown tracking
    is internal — call :meth:`mark_rescaled` after actually applying a
    decision.
    """

    def __init__(
        self,
        utilization_target: float = 0.7,
        hysteresis: float = 0.25,
        cooldown_s: float = 30.0,
        min_shards: int = 1,
        max_shards: int = 0,
        imbalance_limit: float = 2.0,
        backlog_drain_s: float = 60.0,
        backlog_threshold: float = 0.0,
        fire_deadline_ms: float = 0.0,
        fire_breach_ticks: int = 3,
        clock=None,
    ) -> None:
        import time as _time

        if not (0.0 < utilization_target <= 1.0):
            raise ValueError(
                f"utilization_target must be in (0, 1], got "
                f"{utilization_target}")
        self.utilization_target = float(utilization_target)
        self.hysteresis = max(float(hysteresis), 0.0)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.min_shards = max(int(min_shards), 1)
        self.max_shards = int(max_shards or 0)  # 0 = unbounded
        if self.max_shards and self.max_shards < self.min_shards:
            raise ValueError(
                f"max_shards {self.max_shards} < min_shards "
                f"{self.min_shards}")
        self.imbalance_limit = float(imbalance_limit)
        self.backlog_drain_s = max(float(backlog_drain_s), 1.0)
        self.backlog_threshold = float(backlog_threshold)
        self.fire_deadline_ms = max(float(fire_deadline_ms), 0.0)
        self.fire_breach_ticks = max(int(fire_breach_ticks), 1)
        self._clock = clock or _time.monotonic
        self._last_rescale: Optional[float] = None
        #: consecutive decisions whose fire p99 exceeded the deadline
        self._fire_breaches = 0
        #: times the skew guard vetoed a scale-down — previously the
        #: guard refused SILENTLY; a rebalancer (autoscale.rebalance)
        #: keys off this signal instead of a log line
        self.skew_guard_refusals = 0
        #: imbalance measured at the most recent decide() with resident
        #: rows in the sample (1.0 = balanced)
        self.last_imbalance = 1.0

    # --------------------------------------------------------------- helpers

    def _clamp(self, target: int) -> int:
        target = max(target, self.min_shards)
        if self.max_shards:
            target = min(target, self.max_shards)
        return target

    #: the module-level shared definition (see key_imbalance)
    imbalance = staticmethod(key_imbalance)

    def in_cooldown(self, now: Optional[float] = None) -> bool:
        if self._last_rescale is None:
            return False
        now = self._clock() if now is None else now
        return (now - self._last_rescale) < self.cooldown_s

    def mark_rescaled(self, now: Optional[float] = None) -> None:
        """The controller APPLIED a rescale — start the cooldown."""
        self._last_rescale = self._clock() if now is None else now

    # ---------------------------------------------------------------- decide

    def decide(self, inp: PolicyInput,
               now: Optional[float] = None) -> Decision:
        now = self._clock() if now is None else now
        cur = max(int(inp.current_shards), 1)
        if len(inp.shard_resident_rows):
            self.last_imbalance = self.imbalance(inp.shard_resident_rows)

        # hard bounds win over everything except cooldown: a job
        # deployed outside [min, max] converges on the next tick
        bounded = self._clamp(cur)
        if bounded != cur:
            if self.in_cooldown(now):
                return Decision(cur, "cooldown")
            return Decision(bounded, "bounds")

        # fire-latency signal: independent of the rate signal (fires can
        # miss their deadline while throughput keeps up — the queueing
        # problem the latency tier exists for)
        if self.fire_deadline_ms > 0.0:
            if inp.fire_latency_p99_ms > self.fire_deadline_ms:
                self._fire_breaches += 1
            else:
                self._fire_breaches = 0
            if self._fire_breaches >= self.fire_breach_ticks:
                target = self._clamp(cur + max(cur // 2, 1))
                if target > cur:
                    if self.in_cooldown(now):
                        return Decision(cur, "cooldown")
                    self._fire_breaches = 0
                    return Decision(target, "fire-latency")

        if inp.processing_rate <= 0.0 or inp.busy_fraction <= 0.0:
            return Decision(cur, "no-signal")

        # DS2 core: true rate = what the operator COULD process at 100%
        # busy; required rate = what is arriving, plus enough to drain
        # the standing backlog within the horizon
        busy = min(max(inp.busy_fraction, 1e-6), 1.0)
        true_rate = inp.processing_rate / busy
        per_shard_rate = true_rate / cur
        required = inp.processing_rate + max(inp.backlog_growth, 0.0)
        if inp.backlog > self.backlog_threshold:
            required += inp.backlog / self.backlog_drain_s
        raw_target = math.ceil(
            required / (per_shard_rate * self.utilization_target))
        target = self._clamp(max(raw_target, 1))

        if target == cur:
            return Decision(cur, "steady")
        # hysteresis band: a relative change this small is noise
        if abs(target - cur) / cur <= self.hysteresis:
            return Decision(cur, "hysteresis")
        if self.in_cooldown(now):
            return Decision(cur, "cooldown")
        if target < cur:
            if self._fire_breaches > 0:
                # fires are missing their deadline: the operator is not
                # overprovisioned, whatever the rate math says
                return Decision(cur, "fire-latency-hold")
            imb = self.imbalance(inp.shard_resident_rows)
            if imb > self.imbalance_limit:
                # the hot shard explains the load: scaling down would
                # concentrate the skew, not shed capacity — counted (not
                # silent) so the rebalance hand-off can observe it
                self.skew_guard_refusals += 1
                return Decision(cur, "imbalance")
            return Decision(target, "scale-down")
        return Decision(target, "scale-up")
