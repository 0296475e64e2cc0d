"""Load-driven key-group rebalancing (port of
``flink_tpu/autoscale/rebalance.py``): the *rebalance* and *split* stages
of the skew ladder (detect -> rebalance -> split).

A shard-count change cannot fix skew (the contiguous formula puts the
same hot groups on whichever shard inherits them), so the fix changes
the *assignment*:

- :class:`RebalancePolicy` scores greedy hottest-group-to-coldest-shard
  moves against the ``ShardLoadAccountant``'s per-group loads, with
  hysteresis and a cooldown;
- a key that dominates its group cannot be fixed by moving groups: it is
  flagged as a split candidate;
- :class:`SkewResponder` applies both to a live mesh engine
  (``engine.reassign_key_groups`` and ``engine.register_hot_key``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.parallel.load import ShardLoadAccountant
from flink_tpu_torch.state.keygroups import KeyGroupAssignment

__all__ = ["RebalancePlan", "RebalancePolicy", "SkewResponder"]


@dataclasses.dataclass
class RebalancePlan:
    """What the policy wants done; ``assignment`` is None when no move
    set clears the hysteresis bar."""

    assignment: Optional[KeyGroupAssignment]
    moves: List[Tuple[int, int, int]]  # (global group, src, dst)
    imbalance_before: float
    imbalance_after: float
    #: keys whose single-key load dominates their group — moving the
    #: group cannot help; split these instead
    split_candidates: List[int]
    reason: str


class RebalancePolicy:
    """Greedy move planner over per-group load estimates.

    - **imbalance_trigger**: plan only while measured imbalance
      (max-shard-load * P / total) exceeds this.
    - **hysteresis**: a plan must cut imbalance by at least this
      relative margin (plan.after <= before * (1 - hysteresis)) or it
      is discarded — churn guard, same role as the scaling policy's
      band.
    - **cooldown_s**: minimum time between applied plans; call
      :meth:`mark_rebalanced` after actually applying one.
    - **max_moves**: cap on groups moved per plan (each moved group is
      handoff traffic at the batch boundary).
    - **dominance_share**: a key carrying more than this fraction of
      its group's load makes the group unsplittable by moves — the key
      is reported as a split candidate instead.
    """

    def __init__(self, imbalance_trigger: float = 1.5,
                 hysteresis: float = 0.1, cooldown_s: float = 10.0,
                 max_moves: int = 8, dominance_share: float = 0.5,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if imbalance_trigger < 1.0:
            raise ValueError(
                f"imbalance_trigger must be >= 1.0, got "
                f"{imbalance_trigger}")
        self.imbalance_trigger = float(imbalance_trigger)
        self.hysteresis = max(float(hysteresis), 0.0)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.max_moves = max(int(max_moves), 1)
        self.dominance_share = float(dominance_share)
        self._clock = clock if clock is not None else time.monotonic
        self._last_rebalance: Optional[float] = None

    def in_cooldown(self, now: Optional[float] = None) -> bool:
        if self._last_rebalance is None:
            return False
        now = self._clock() if now is None else now
        return (now - self._last_rebalance) < self.cooldown_s

    def mark_rebalanced(self, now: Optional[float] = None) -> None:
        self._last_rebalance = self._clock() if now is None else now

    def plan(self, accountant: ShardLoadAccountant,
             current: KeyGroupAssignment,
             now: Optional[float] = None) -> RebalancePlan:
        """Propose a better assignment (or None). Pure scoring — the
        caller applies ``plan.assignment`` via
        ``engine.reassign_key_groups`` and then calls
        :meth:`mark_rebalanced`."""
        now = self._clock() if now is None else now
        before = accountant.imbalance(current)
        split = [k for k, _g, share in accountant.hot_key_candidates()
                 if share >= self.dominance_share]
        if before <= self.imbalance_trigger:
            return RebalancePlan(None, [], before, before, split,
                                 "balanced")
        if self.in_cooldown(now):
            return RebalancePlan(None, [], before, before, split,
                                 "cooldown")
        loads = accountant.group_load()
        table = current.table.copy()
        P = current.num_shards
        shard_load = np.bincount(table, weights=loads, minlength=P)
        total = float(shard_load.sum())
        if total <= 0.0:
            return RebalancePlan(None, [], before, before, split,
                                 "no-signal")
        moves: List[Tuple[int, int, int]] = []
        # greedy: repeatedly move the hottest shard's hottest movable
        # group to the coldest shard, while each move improves the max
        for _ in range(self.max_moves):
            src = int(np.argmax(shard_load))
            dst = int(np.argmin(shard_load))
            if src == dst:
                break
            local = np.nonzero(table == src)[0]
            if len(local) <= 1:
                break  # a one-group shard is skew moves cannot fix
            cand = local[np.argsort(-loads[local])]
            applied = False
            for g in cand.tolist():
                w = float(loads[g])
                if w <= 0.0:
                    break  # remaining candidates are colder still
                # only move if it lowers the CURRENT max (src load);
                # never just swap the hot spot onto dst
                if shard_load[dst] + w >= shard_load[src]:
                    continue
                table[g] = dst
                shard_load[src] -= w
                shard_load[dst] += w
                moves.append((int(g) + current.first, src, dst))
                applied = True
                break
            if not applied:
                break
        if not moves:
            return RebalancePlan(None, [], before, before, split,
                                 "no-improving-move")
        proposed = KeyGroupAssignment(current.first, P, table)
        after = accountant.imbalance(proposed)
        if after > before * (1.0 - self.hysteresis):
            return RebalancePlan(None, moves, before, after, split,
                                 "hysteresis")
        return RebalancePlan(proposed, moves, before, after, split,
                             "rebalance")


class SkewResponder:
    """Wires detect -> rebalance -> split onto one live mesh engine.

    Feed it routed key columns (:meth:`note_batch`, cheap) and call
    :meth:`maybe_respond` at batch boundaries — or pass
    ``responder.on_imbalance`` as the
    :class:`~flink_tpu_torch.autoscale.controller.AutoscaleController`'s
    ``on_imbalance`` hook so the skew guard's refusal drives it. It
    ticks the accountant, asks the policy for a plan, applies group
    moves via ``engine.reassign_key_groups`` and splits dominant keys
    via ``engine.register_hot_key``.

    ``salts``/``hot_key_share``/``allow_inexact`` parameterize the
    split stage; ``max_hot_keys`` bounds how many keys may be split at
    once (each costs fold work at every fire).
    """

    def __init__(self, engine, accountant: ShardLoadAccountant,
                 policy: Optional[RebalancePolicy] = None,
                 salts: int = 8, hot_key_share: float = 0.5,
                 allow_inexact: bool = False,
                 max_hot_keys: int = 4) -> None:
        if not hasattr(engine, "reassign_key_groups"):
            raise TypeError(
                f"{type(engine).__name__} has no reassign_key_groups() "
                "— the responder needs a live mesh engine")
        self.engine = engine
        self.accountant = accountant
        self.policy = policy if policy is not None else RebalancePolicy()
        self.policy.dominance_share = float(hot_key_share)
        self.salts = int(salts)
        self.allow_inexact = bool(allow_inexact)
        self.max_hot_keys = int(max_hot_keys)
        self.rebalances = 0
        self.groups_moved = 0
        self.keys_split = 0
        self.last_plan: Optional[RebalancePlan] = None

    # ------------------------------------------------------------ feed

    def note_batch(self, key_ids) -> None:
        self.accountant.note_batch(key_ids)

    def on_imbalance(self, _policy_input) -> None:
        """AutoscaleController ``on_imbalance`` adapter (the sampled
        PolicyInput is redundant — the accountant holds finer state)."""
        self.maybe_respond()

    # ------------------------------------------------------------ act

    def maybe_respond(self, now: Optional[float] = None) -> Optional[dict]:
        """Tick, plan, apply. Returns the engine's handoff report when
        a rebalance ran (None otherwise). Split registration happens
        independently of group moves — a dominant key needs splitting
        even when no move clears the bar."""
        self.accountant.tick(
            shard_resident_rows=self.engine.shard_resident_rows())
        plan = self.policy.plan(self.accountant,
                                self.engine.key_group_assignment,
                                now=now)
        self.last_plan = plan
        can_split = getattr(self.engine, "register_hot_key", None)
        if can_split is not None and plan.imbalance_before \
                > self.policy.imbalance_trigger:
            already = getattr(self.engine, "_hot_keys", {})
            for key in plan.split_candidates:
                if len(already) >= self.max_hot_keys:
                    break
                if key not in already:
                    can_split(key, salts=self.salts,
                              allow_inexact=self.allow_inexact)
                    self.keys_split += 1
        if plan.assignment is None:
            return None
        report = self.engine.reassign_key_groups(plan.assignment)
        self.policy.mark_rebalanced(now)
        self.rebalances += 1
        self.groups_moved += int(report.get("groups_moved", 0))
        return report
