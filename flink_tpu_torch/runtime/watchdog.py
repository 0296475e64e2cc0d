"""Device watchdog: deadline-tracked device interactions and shard
quarantine, the detection half of partial failover (port of
``flink_tpu/runtime/watchdog.py``, host code with the same behaviour).

The mesh engines' analog of a TaskManager is a SHARD (one key-group range
of the ``[P, capacity]`` planes and its host-side slice of state); its
"heartbeats" are the device interactions the engine performs anyway:
dispatch-fence waits and device-to-host harvests. On one card the P
shards are the logical shards of ``parallel/mesh.py``'s ``LogicalMesh``,
so a shard's identity is its ORIGINAL logical index (``device_ids``), not
the card's ordinal: every loss would otherwise collapse into one.

- **Sections** (:meth:`DeviceWatchdog.section`) time one interaction. A
  section past ``deadline_ms`` records a MISS; it never raises
  mid-interaction. On CUDA a section around an asynchronous launch times
  only the enqueue, so the engines put sections where the work
  synchronises (fence waits, harvests), never adding a synchronisation to
  time one.
- **Boundary probes** (:meth:`DeviceWatchdog.boundary_probe`) run at
  batch boundaries (the top of ``process_batch`` / ``on_watermark``),
  where the engine is consistent at a known source position. The probe
  fires the chaos ``device.lost`` point once per live shard, and
  escalates accumulated misses: a shard past ``max_misses`` is declared
  dead, which quarantines it and raises :class:`ShardFailedError` — the
  signal ``chaos.harness.run_shard_loss_verify`` consumes.

The heartbeat gauges sit under ``<scope>.watchdog``
(``register_metrics``), and every missed section lands a
``watchdog.miss`` instant in the flight recorder's timeline.

Not carried: the pod's host topology (``set_topology`` with a topology,
``HostFailedError`` escalation, the ``host.lost`` point; ROADMAP.md
Queue A item 12h), so ``hosts_declared_dead`` reads 0.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.runtime.pending import NULL_SECTION, harvest_to_host
from flink_tpu_torch.state.slot_table import _not_ported


class ShardFailedError(RuntimeError):
    """A mesh shard was declared dead (device lost or persistently past
    its deadline). Recovery is SHARD-GRANULAR: survivors keep their live
    state; only the failed shard's key groups restore from its checkpoint
    unit and replay their range of the stream."""

    def __init__(self, shard: int, reason: str) -> None:
        super().__init__(
            f"shard {shard} declared dead: {reason} — partial failover "
            "(restore only that shard's key groups, replay only its "
            "range)")
        self.shard = int(shard)
        self.reason = reason


class MeshStalledError(RuntimeError):
    """EVERY live shard is past its deadline-miss budget at once. Whole-
    mesh sections charge a miss to every shard, so a uniform streak
    carries no shard attribution; quarantining an arbitrary shard would
    evacuate a healthy one. The escalation is a WHOLE-JOB failure."""


class _Section:
    """One timed device interaction."""

    __slots__ = ("_wd", "_op", "_shard", "_t0")

    def __init__(self, wd: "DeviceWatchdog", op: str, shard: int) -> None:
        self._wd = wd
        self._op = op
        self._shard = shard

    def __enter__(self) -> "_Section":
        self._t0 = self._wd._clock()
        # an injected slow device: a `delay` rule here stretches the
        # section past its deadline, as a wedged program would (no
        # exception, only time)
        chaos.fault_point("watchdog.deadline", op=self._op,
                          shard=self._shard)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._wd._observe(self._op, self._shard,
                          self._wd._clock() - self._t0,
                          failed=exc_type is not None)


class DeviceWatchdog:
    """Deadline policy and shard health for one engine's mesh.

    ``deadline_ms``: a section slower than this records a miss (0
    disables deadline tracking; sections still heartbeat).
    ``max_misses``: consecutive misses a shard survives before the next
    boundary probe declares it dead. An in-deadline section resets the
    streak. ``device_ids``: the shard -> identity map (the engines pass
    each shard's original logical index)."""

    def __init__(self, num_shards: int, deadline_ms: float = 0.0,
                 max_misses: int = 3,
                 clock: Callable[[], float] = time.perf_counter,
                 device_ids: Optional[List[int]] = None) -> None:
        self.deadline_ms = float(deadline_ms)
        self.max_misses = max(int(max_misses), 1)
        self._clock = clock
        self.quarantined: set = set()
        #: identities ever quarantined: several watchdogs over the same
        #: shards each quarantine the same dead one, counted once
        self.quarantined_devices: set = set()
        self.sections_timed = 0
        self.deadline_misses = 0
        self.declared_dead = 0
        self.rebind(num_shards, device_ids)

    # ----------------------------------------------------------- lifecycle

    def rebind(self, num_shards: int,
               device_ids: Optional[List[int]] = None) -> None:
        """Point the watchdog at a rebuilt mesh of ``num_shards`` shards
        (after a partial failover the survivors renumber 0..P-2).
        Cumulative counters and the quarantine history survive; per-shard
        streaks reset with the new numbering."""
        self.num_shards = int(num_shards)
        now = self._clock()
        self._misses: List[int] = [0] * self.num_shards
        self._last_beat: List[float] = [now] * self.num_shards
        self._device_ids = (list(device_ids)
                            if device_ids is not None else None)
        self.quarantined = set()

    def set_topology(self, topology) -> None:
        """Host-granular escalation needs the pod's host topology; a
        single-card mesh has none (``None`` is accepted and ignored)."""
        if topology is not None:
            raise _not_ported("host-granular failover (HostTopology)", "12h")

    # ------------------------------------------------------------ sections

    def section(self, op: str, shard: int = -1) -> _Section:
        """Context manager timing one device interaction. ``shard=-1`` for
        whole-mesh programs (a miss counts against every live shard)."""
        return _Section(self, op, shard)

    def _observe(self, op: str, shard: int, seconds: float,
                 failed: bool = False) -> None:
        self.sections_timed += 1
        now = self._clock()
        targets = ([shard] if 0 <= shard < self.num_shards
                   else range(self.num_shards))
        missed = (self.deadline_ms > 0
                  and seconds * 1000.0 > self.deadline_ms)
        for p in targets:
            if missed:
                self._misses[p] += 1
                self.deadline_misses += 1
            elif not failed:
                self._misses[p] = 0
                self._last_beat[p] = now
        if missed:
            # one instant per missed section, beside the batch and fire
            # spans that were open when the device went quiet
            flight.instant("watchdog.miss",
                           shard=shard if 0 <= shard < self.num_shards
                           else -1)

    # ------------------------------------------------------------- boundary

    def boundary_probe(self) -> None:
        """The batch-boundary health check — the ONLY place a shard is
        declared dead, so the raise always leaves an engine consistent at
        a known source position."""
        if chaos.armed():
            for p in range(self.num_shards):
                if p in self.quarantined:
                    continue
                try:
                    chaos.fault_point("device.lost", shard=p)
                except chaos.InjectedFault as f:
                    self.declare_dead(p, f"device.lost injected ({f})")
        live = [p for p in range(self.num_shards)
                if p not in self.quarantined]
        offenders = [p for p in live
                     if self._misses[p] >= self.max_misses]
        if not offenders:
            return
        if len(offenders) == len(live) and len(live) > 1:
            raise MeshStalledError(
                f"all {len(live)} live shards are past the deadline-"
                f"miss budget ({self.max_misses} misses at "
                f"{self.deadline_ms} ms) — mesh-wide stall, no shard "
                "attribution: whole-job restart")
        p = offenders[0]
        self.declare_dead(
            p, f"{self._misses[p]} consecutive deadline misses "
               f"(budget {self.max_misses}, deadline "
               f"{self.deadline_ms} ms)")

    def declare_dead(self, shard: int, reason: str) -> None:
        self.quarantined.add(int(shard))
        if self._device_ids is not None \
                and 0 <= int(shard) < len(self._device_ids):
            self.quarantined_devices.add(self._device_ids[int(shard)])
        self.declared_dead += 1
        raise ShardFailedError(int(shard), reason)

    # -------------------------------------------------------------- signals

    def available(self, total_devices: int) -> int:
        """Shards usable for (re)scaling: a quarantined shard is out of
        the budget until it is replaced."""
        return max(int(total_devices) - len(self.quarantined), 1)

    def heartbeat_age_s(self) -> float:
        """Age of the STALEST live shard's last healthy interaction."""
        now = self._clock()
        ages = [now - self._last_beat[p] for p in range(self.num_shards)
                if p not in self.quarantined]
        return max(ages) if ages else 0.0

    def misses_by_shard(self) -> Dict[int, int]:
        return {p: m for p, m in enumerate(self._misses) if m}

    def counters(self) -> Dict[str, float]:
        """The numbers the reference's heartbeat gauges read."""
        return {"sections_timed": self.sections_timed,
                "deadline_misses": self.deadline_misses,
                "shards_quarantined": len(self.quarantined),
                "declared_dead": self.declared_dead,
                "heartbeat_age_s": self.heartbeat_age_s()}

    def register_metrics(self, group) -> None:
        """Heartbeat/health gauges under ``<scope>.watchdog``."""
        g = group.add_group("watchdog")
        g.gauge("sections_timed", lambda: self.sections_timed)
        g.gauge("deadline_misses", lambda: self.deadline_misses)
        g.gauge("shards_quarantined", lambda: len(self.quarantined))
        g.gauge("declared_dead", lambda: self.declared_dead)
        # no host topology in the port (item 12h): no host is declared
        g.gauge("hosts_declared_dead", lambda: 0)
        g.gauge("heartbeat_age_s", lambda: self.heartbeat_age_s())


class WatchdogHooks:
    """The hooks a mesh engine gives its watchdog: hosts provide ``P``
    (and may override :meth:`_shard_ids`, the shards' identities)."""

    #: None keeps every hook one attribute check
    _watchdog = None

    def _shard_ids(self) -> List[int]:
        return list(range(self.P))

    def attach_watchdog(self, wd) -> None:
        """Time this engine's synchronising device interactions (fence
        waits, eviction, fire and snapshot harvests) in the watchdog's
        deadline-tracked sections, and probe shard health at batch
        boundaries."""
        self._watchdog = wd
        if wd is not None:
            wd.rebind(self.P, self._shard_ids())
            wd.set_topology(None)

    def _wd_section(self, op: str, shard: int = -1):
        wd = self._watchdog
        if wd is None:
            return NULL_SECTION
        return wd.section(op, shard)

    def _wd_boundary(self) -> None:
        """Batch-boundary health probe: the one point a shard may be
        DECLARED dead (the engine is consistent at a known source
        position there)."""
        wd = self._watchdog
        if wd is not None:
            wd.boundary_probe()

    def _harvest_get(self, tensors, op: str = "fire_harvest"
                     ) -> List[np.ndarray]:
        """``harvest_to_host`` (one device-to-host copy) as a section: the
        copy synchronises, so the section times the device."""
        with flight.span("fire.harvest"), self._wd_section(op):
            return harvest_to_host(tensors)


def watchdog_from_config(config, num_shards: int
                         ) -> Optional[DeviceWatchdog]:
    """A watchdog from the ``watchdog.*`` keys, or None when disabled (the
    default: every engine hook is then one attribute check)."""
    from flink_tpu_torch.core.config import WatchdogOptions

    if not config.get(WatchdogOptions.ENABLED):
        return None
    return DeviceWatchdog(
        num_shards,
        deadline_ms=config.get(WatchdogOptions.DEADLINE_MS),
        max_misses=config.get(WatchdogOptions.MAX_MISSES))
