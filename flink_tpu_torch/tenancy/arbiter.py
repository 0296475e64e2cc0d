"""Cross-job shard arbitration: the autoscaler lifted one level (port of
``flink_tpu/tenancy/arbiter.py``; pure policy, host code).

The single-job controller scales ONE job's mesh to its own load. With N
jobs on one device the question changes: given a fixed shard budget, who
deserves how many? The arbiter answers with weighted proportional
shares: each job's demand is its backlog (records queued upstream,
normalized) plus its quota pressure (resident rows / quota), shares are
clamped to per-job [min, max] bounds, and largest-remainder rounding
keeps the total at the budget. A hysteresis band suppresses one-shard
flapping and a cooldown bounds migration churn.

The arbiter only decides WHO gets shards. Acting on a decision is a live
``reshard`` posted as a ``RescaleRequest`` that the job's executor serves
at its next batch boundary (``SessionCluster(arbiter=...,
arbitrate_every_s > 0)``). The port's shards are logical (``parallel/mesh.py``), so the budget is a
count of logical shards, never ``torch.cuda.device_count()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class JobDemand:
    """One job's arbitration inputs for a tick."""

    job: str
    current_shards: int
    #: records queued upstream (sourceBacklogRecordsEstimate)
    backlog: float = 0.0
    #: resident rows / quota rows (0 when unbounded)
    quota_pressure: float = 0.0
    min_shards: int = 1
    #: 0 = bounded only by the budget / key-group span
    max_shards: int = 0


class ShardArbiter:
    """Weighted proportional-share allocator over a shard budget."""

    def __init__(self, total_shards: int, hysteresis: int = 0,
                 cooldown_ticks: int = 2,
                 backlog_norm: float = 65536.0):
        #: total shards the cluster hands out per tick (each job's mesh
        #: is its own [n_j, cap] plane; the budget bounds the SUM so the
        #: per-chip working sets of co-resident jobs stay bounded)
        self.total_shards = int(total_shards)
        #: suppress reallocations smaller than this many shards
        self.hysteresis = int(hysteresis)
        self.cooldown_ticks = int(cooldown_ticks)
        self.backlog_norm = float(backlog_norm)
        self._since_change = self.cooldown_ticks  # first tick may act

    def decide(self, demands: List[JobDemand],
               dead_shards: int = 0) -> Dict[str, int]:
        """Per-job shard allocation for this tick (== current when the
        tick should not act). Deterministic in its inputs.

        ``dead_shards``: devices the watchdog has quarantined — a dead
        shard changes the budget, so the arbiter divides what actually
        answers, not the nameplate mesh size."""
        if not demands:
            return {}
        current = {d.job: int(d.current_shards) for d in demands}
        if self._since_change < self.cooldown_ticks:
            # still cooling down: cooldown_ticks=N suppresses exactly N
            # ticks after a reallocation (increment AFTER the compare —
            # before it, N suppressed only N-1 and 1 suppressed none)
            self._since_change += 1
            return current
        budget = max(self.total_shards - max(int(dead_shards), 0), 1)
        floor_sum = sum(max(d.min_shards, 1) for d in demands)
        if floor_sum > budget:
            # over-subscribed floors: everyone gets their floor (the
            # budget is advisory; correctness never depends on it)
            return {d.job: max(d.min_shards, 1) for d in demands}
        weights = {
            d.job: 1.0 + d.backlog / self.backlog_norm
            + max(d.quota_pressure, 0.0)
            for d in demands
        }
        total_w = sum(weights.values())
        # ideal shares, then clamp to [min, max]; redistribute the slack
        # by largest remainder among unclamped jobs
        alloc: Dict[str, int] = {}
        remainders: List = []
        spent = 0
        for d in demands:
            ideal = budget * weights[d.job] / total_w
            lo = max(d.min_shards, 1)
            hi = d.max_shards or budget
            share = min(max(int(math.floor(ideal)), lo), hi)
            alloc[d.job] = share
            spent += share
            if share < hi:
                remainders.append((ideal - math.floor(ideal), d.job, hi))
        remainders.sort(reverse=True)
        for _, job, hi in remainders:
            if spent >= budget:
                break
            if alloc[job] < hi:
                alloc[job] += 1
                spent += 1

        def shed_excess() -> None:
            # lo clamps (and the hysteresis re-pin below) can push the
            # sum past the budget. Shed one shard at a time from the
            # job whose allocation most exceeds its ideal share and is
            # still above its floor; floor_sum <= budget (the
            # over-subscribed case returned earlier) guarantees
            # termination.
            spent = sum(alloc.values())
            while spent > budget:
                cand = max(
                    (d for d in demands
                     if alloc[d.job] > max(d.min_shards, 1)),
                    key=lambda d: (
                        alloc[d.job] - budget * weights[d.job] / total_w,
                        d.job),
                    default=None)
                if cand is None:  # pragma: no cover - floors <= budget
                    break
                alloc[cand.job] -= 1
                spent -= 1

        shed_excess()
        # hysteresis: ignore sub-band moves (migration is not free)
        for d in demands:
            if abs(alloc[d.job] - current[d.job]) <= self.hysteresis:
                alloc[d.job] = current[d.job]
        # the re-pin hands pinned jobs back the shards the shed pass
        # (or the remainder pass) took from them, so the sum can climb
        # over the budget again — shed once more; the budget invariant
        # beats the flap band
        shed_excess()
        if any(alloc[d.job] != current[d.job] for d in demands):
            self._since_change = 0
        return alloc
