"""Deficit-round-robin over per-job ready queues (port of
``flink_tpu/tenancy/fairness.py``; host code).

The session cluster's scheduling law: every round, each live job's
deficit counter grows by its quantum (records); a job may run scheduling
steps while its deficit is positive, paying the records it actually
processed. A hot job that burns its quantum yields to the next job — it
cannot starve the rest — while an idle job's unused credit is CAPPED
(classic DRR: deficit resets when the queue is empty), so a quiet job
cannot hoard credit and then monopolize the loop in a burst.

reference: network-scheduler DRR (Shreedhar & Varghese) as used by the
reference's mailbox-fairness discussions; here the "packet cost" is
source records per step and the per-job ``busyTimeMsTotal`` gauge makes
the achieved shares observable.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class DeficitRoundRobin:
    """Deficit scheduler over named queues (jobs).

    ``quantum`` — credit (records) added per job per round; a job whose
    weight differs scales its quantum (weight 2.0 = twice the share).
    """

    def __init__(self, quantum: int = 8192):
        self.quantum = int(quantum)
        self._deficit: Dict[str, float] = {}
        self._weight: Dict[str, float] = {}
        self._order: List[str] = []

    def add(self, name: str, weight: float = 1.0) -> None:
        if name not in self._deficit:
            self._order.append(name)
        self._deficit[name] = 0.0
        self._weight[name] = float(weight)

    def remove(self, name: str) -> None:
        self._deficit.pop(name, None)
        self._weight.pop(name, None)
        if name in self._order:
            self._order.remove(name)

    def begin_round(self) -> List[str]:
        """Credit every job its (weighted) quantum; returns the service
        order for this round."""
        for name in self._order:
            self._deficit[name] += self.quantum * self._weight[name]
        return list(self._order)

    def can_run(self, name: str) -> bool:
        return self._deficit.get(name, 0.0) > 0.0

    def charge(self, name: str, records: int) -> None:
        """Pay for work actually done. A zero-record step charges a
        token cost of 1 so a spinning-but-idle job still cycles out."""
        if name in self._deficit:
            self._deficit[name] -= max(int(records), 1)

    def reset_idle(self, name: str) -> None:
        """DRR empty-queue rule: a job with nothing ready forfeits its
        accumulated credit (no hoard-then-burst)."""
        if name in self._deficit:
            self._deficit[name] = 0.0

    def deficit(self, name: str) -> Optional[float]:
        return self._deficit.get(name)
