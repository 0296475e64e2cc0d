"""Autoscale controller (port of ``flink_tpu/autoscale/controller.py``):
drive policy decisions into a rescale path.

- **live**: a mesh engine migrates its key groups in place through
  ``engine.reshard(target)`` — the logical shards of one card;
- **cold**: a MiniCluster job redeploys at the new parallelism from its
  latest checkpoint through ``request_rescale(target)``.

The controller differentiates cumulative signal samples into the rates
the :class:`ScalingPolicy` reads, applies decisions, starts the policy's
cooldown, and reports through an ``autoscale`` metric group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from flink_tpu_torch.autoscale.policy import Decision, PolicyInput, ScalingPolicy


@dataclasses.dataclass
class SignalSample:
    """Raw CUMULATIVE counters + instantaneous gauges; the controller
    differentiates successive samples into rates."""

    records_total: float = 0.0
    busy_ms_total: float = 0.0
    backlog: float = 0.0
    shard_resident_rows: Sequence[int] = ()
    #: recent window-fire p99 (ms) — instantaneous like backlog, passed
    #: through to the policy's fire-latency signal (0 = no fires yet)
    fire_latency_p99_ms: float = 0.0


@dataclasses.dataclass
class RescaleEvent:
    at: float
    source: int
    target: int
    reason: str
    mode: str  # "live" | "cold"
    handoff_s: float = 0.0
    rows_moved: int = 0


class AutoscaleController:
    """One controller per elastic operator (or per job on the cold path).

    ``sample_fn`` returns a :class:`SignalSample`;
    ``current_shards_fn`` reads the operator's live shard count;
    exactly one of ``engine`` / ``job`` / ``apply_fn`` provides the
    rescale mechanism. ``clock`` is injectable for deterministic tests
    and shared with the policy's cooldown tracking.
    """

    def __init__(
        self,
        policy: ScalingPolicy,
        sample_fn: Callable[[], SignalSample],
        engine=None,
        job=None,
        apply_fn: Optional[Callable[[int], Optional[dict]]] = None,
        current_shards_fn: Optional[Callable[[], int]] = None,
        interval_s: float = 1.0,
        clock=None,
        metrics_group=None,
        on_imbalance: Optional[Callable[[PolicyInput], None]] = None,
    ) -> None:
        import time as _time

        mechanisms = sum(x is not None for x in (engine, job, apply_fn))
        if mechanisms != 1:
            raise ValueError(
                "exactly one of engine / job / apply_fn must be given "
                f"(got {mechanisms})")
        if engine is not None and not hasattr(engine, "reshard"):
            raise TypeError(
                f"{type(engine).__name__} has no reshard() — the live "
                "path needs a mesh engine; use job= for the "
                "checkpoint-redeploy path")
        self.policy = policy
        self.sample_fn = sample_fn
        self.engine = engine
        self.job = job
        self.apply_fn = apply_fn
        self._shards_fn = current_shards_fn
        self.interval_s = max(float(interval_s), 0.0)
        self._clock = clock or _time.monotonic
        self.events: List[RescaleEvent] = []
        self.last_decision: Optional[Decision] = None
        self._last_sample: Optional[SignalSample] = None
        self._last_sample_t: Optional[float] = None
        self._last_tick: Optional[float] = None
        self._handoff_hist = None
        #: called (with the PolicyInput) whenever the skew guard refuses
        #: a scale-down — the hand-off hook a rebalancer (e.g.
        #: autoscale.rebalance.SkewResponder) hangs off so "imbalance"
        #: triggers a key-group MOVE instead of merely holding P
        self.on_imbalance = on_imbalance
        if metrics_group is not None:
            self.register_metrics(metrics_group)

    # --------------------------------------------------------------- metrics

    def register_metrics(self, group) -> None:
        """Expose the decision loop on the job metric tree
        (job.<name>.autoscale.*)."""
        g = group.add_group("autoscale")
        g.gauge("current_shards", self.current_shards)
        g.gauge("rescales", lambda: len(self.events))
        g.gauge("live_handoffs",
                lambda: sum(1 for e in self.events if e.mode == "live"))
        g.gauge("last_target",
                lambda: self.events[-1].target if self.events else 0)
        g.gauge("last_decision",
                lambda: (self.last_decision.reason
                         if self.last_decision else ""))
        g.gauge("skew_guard_refusals",
                lambda: self.policy.skew_guard_refusals)
        g.gauge("key_imbalance", lambda: self.policy.last_imbalance)
        self._handoff_hist = g.histogram("handoff_ms")

    # ---------------------------------------------------------------- state

    def current_shards(self) -> int:
        if self._shards_fn is not None:
            return int(self._shards_fn())
        if self.engine is not None:
            return int(self.engine.P)
        if self.job is not None:
            return int(getattr(self.job, "current_parallelism", 1))
        return 1

    @property
    def live_handoffs(self) -> int:
        return sum(1 for e in self.events if e.mode == "live")

    # ----------------------------------------------------------------- tick

    def _differentiate(self, now: float) -> Optional[PolicyInput]:
        sample = self.sample_fn()
        prev, prev_t = self._last_sample, self._last_sample_t
        self._last_sample, self._last_sample_t = sample, now
        if prev is None or prev_t is None or now <= prev_t:
            return None
        dt = now - prev_t
        return PolicyInput(
            current_shards=self.current_shards(),
            processing_rate=max(
                sample.records_total - prev.records_total, 0.0) / dt,
            busy_fraction=max(
                sample.busy_ms_total - prev.busy_ms_total, 0.0)
            / 1000.0 / dt,
            backlog=sample.backlog,
            backlog_growth=(sample.backlog - prev.backlog) / dt,
            shard_resident_rows=sample.shard_resident_rows,
            fire_latency_p99_ms=sample.fire_latency_p99_ms,
        )

    def tick(self, now: Optional[float] = None) -> Optional[RescaleEvent]:
        """Sample -> decide -> (maybe) rescale. Returns the event when a
        rescale was applied, else None. Call from the owning task loop —
        the live path mutates engine state and MUST run single-owner."""
        now = self._clock() if now is None else now
        if self._last_tick is not None and \
                now - self._last_tick < self.interval_s:
            return None
        self._last_tick = now
        inp = self._differentiate(now)
        if inp is None:
            return None
        decision = self.policy.decide(inp, now=now)
        self.last_decision = decision
        if decision.reason == "imbalance" and self.on_imbalance is not None:
            # the guard refused a scale-down because one shard is hot:
            # hand the sample to the rebalancer — moving hot key groups
            # is the fix a shard-count change cannot provide
            self.on_imbalance(inp)
        if not decision.rescale or decision.target == inp.current_shards:
            return None
        return self._apply(decision, inp.current_shards, now)

    def _apply(self, decision: Decision, source: int,
               now: float) -> Optional[RescaleEvent]:
        handoff_s = 0.0
        rows_moved = 0
        if self.engine is not None:
            report = self.engine.reshard(decision.target)
            mode = "live"
            handoff_s = float(report.get("seconds", 0.0))
            rows_moved = int(report.get("rows_moved", 0))
        elif self.job is not None:
            accepted = self.job.request_rescale(decision.target)
            if not accepted:
                # the job cannot rescale right now (no checkpointing /
                # not running) — do not burn the cooldown on a no-op
                return None
            mode = "cold"
        else:
            report = self.apply_fn(decision.target) or {}
            mode = report.get("mode", "live")
            handoff_s = float(report.get("seconds", 0.0))
            rows_moved = int(report.get("rows_moved", 0))
        self.policy.mark_rescaled(now)
        event = RescaleEvent(at=now, source=source,
                             target=decision.target,
                             reason=decision.reason, mode=mode,
                             handoff_s=handoff_s, rows_moved=rows_moved)
        self.events.append(event)
        if self._handoff_hist is not None and mode == "live":
            self._handoff_hist.update(handoff_s * 1000.0)
        return event
