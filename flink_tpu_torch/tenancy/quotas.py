"""Per-job state-plane quotas: a bounded slice of resident rows per job
(port of ``flink_tpu/tenancy/quotas.py``; host code).

Tenant isolation on the state plane has two halves:

1. **Structural** — each job's engines own their OWN [P, capacity]
   device arrays, host indexes, and spill tiers (per-job page
   directories under ``<spill_root>/job-<name>/``). Eviction machinery
   only ever walks the engine it runs on, so a job spilling under
   pressure can only evict its *own* cold rows — cross-job reclaim has
   no code path (pinned by tests/test_torch_tenancy.py).
2. **Budgeted** — the quota bounds how many of a job's rows may stay
   device-resident. Size the env's ``state.slot-table.max-device-slots``
   with :meth:`TenantQuota.per_shard_slots` so steady-state eviction
   keeps each shard under its slice, and :class:`QuotaLedger.enforce`
   is the backstop at every scheduling quantum: an engine found over
   budget sheds its own cold rows through
   ``MeshSpillSupport.enforce_resident_budget``; a job STILL over
   budget after shedding (no spill tier, tier full, every row pinned)
   counts a ``quota_violations`` — the serving benchmark fails on any.

reference: fine-grained resource management (slot sharing groups with
explicit resource profiles) — here the scarce resource is device-resident
state rows, and "preemption" is spilling to the job's own tier.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TenantQuota:
    """A job's state-plane budget.

    ``max_resident_rows`` bounds device-resident state rows summed over
    the job's engines and shards (0 = unbounded). ``spill_dir`` is the
    job-private spill directory root — pages of different jobs never
    share a directory, so a corrupt / reclaimed tier is contained."""

    max_resident_rows: int = 0
    spill_dir: Optional[str] = None
    #: arbitration bounds for the cross-job shard arbiter
    min_shards: int = 1
    max_shards: int = 0  # 0 = devices

    def per_shard_slots(self, shards: int) -> int:
        """The per-shard ``max_device_slots`` this quota implies (the
        engine floor of 1024 is applied by the engine itself)."""
        if not self.max_resident_rows:
            return 0
        return max(self.max_resident_rows // max(int(shards), 1), 1024)


@dataclass
class QuotaLedger:
    """Runtime accounting of one job against its quota."""

    job: str
    quota: TenantQuota
    #: engines (windowers) bound at job open
    engines: List[object] = field(default_factory=list)
    #: times an over-budget engine could not shed (no spill tier)
    quota_violations: int = 0
    #: rows shed by enforce() (the backstop path, not steady-state
    #: eviction — steady state stays under budget via max_device_slots)
    rows_shed: int = 0

    def bind(self, operators) -> None:
        """Attach the job's stateful operators' engines (mesh engines
        expose ``shard_resident_rows``; others are counted read-only)."""
        for op in operators:
            eng = getattr(op, "windower", op)
            if not hasattr(eng, "shard_resident_rows"):
                # single-device layouts count through the OPERATOR's
                # shard_resident_rows fallback (slot-table index walk)
                # — unwrapping to the bare engine would silently make
                # the quota a no-op: resident 0 forever, never
                # enforced, never reported violated
                eng = op
            if eng not in self.engines:
                self.engines.append(eng)

    def resident_rows(self) -> int:
        total = 0
        for eng in self.engines:
            fn = getattr(eng, "shard_resident_rows", None)
            if fn is not None:
                total += int(sum(fn()))
        return total

    def pressure(self) -> float:
        """resident / budget in [0, ...]; 0.0 when unbounded — the
        arbiter's quota-pressure demand term."""
        if not self.quota.max_resident_rows:
            return 0.0
        return self.resident_rows() / float(self.quota.max_resident_rows)

    def enforce(self) -> int:
        """Backstop: shed the job's own cold rows until the job is back
        under budget. Returns rows shed; counts a violation per engine
        that cannot shed. Never touches another job's engines — the
        ledger only holds this job's."""
        budget = self.quota.max_resident_rows
        if not budget:
            return 0
        over = self.resident_rows() - budget
        if over <= 0:
            return 0
        shed = 0
        for eng in self.engines:
            if shed >= over:
                break
            shrink = getattr(eng, "enforce_resident_budget", None)
            rows = getattr(eng, "shard_resident_rows", None)
            if shrink is None or rows is None:
                continue
            if not getattr(eng, "_spill_active", False):
                # nowhere to shed to: the re-check below records the
                # violation. Pre-checking (rather than catching the
                # engine's RuntimeError) keeps genuine eviction
                # failures loud instead of silently swallowed
                continue
            total = int(sum(rows()))
            want = max(total - (over - shed), 0)
            shed += shrink(want)
        if self.resident_rows() > budget:
            # STILL over after shedding — whether because an engine has
            # no tier, its tier is full, or every row is pinned: the
            # budget is being violated and the gauge (and the serving
            # smoke's gate) must say so
            self.quota_violations += 1
        self.rows_shed += shed
        return shed

    def metrics(self) -> Dict[str, float]:
        return {
            "resident_rows": self.resident_rows(),
            "quota_rows": self.quota.max_resident_rows,
            "quota_pressure": self.pressure(),
            "quota_violations": self.quota_violations,
            "rows_shed": self.rows_shed,
        }
