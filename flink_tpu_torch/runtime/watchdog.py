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

- **Hosts** (:meth:`DeviceWatchdog.set_topology`): given the mesh's
  ``(hosts, local)`` factorization, the probe also fires the chaos
  ``host.lost`` point once per live host, and escalates a miss streak
  that covers exactly one host's live shards (and nothing else) to
  :class:`HostFailedError`: a lost process, recovered host-granular.

The heartbeat gauges sit under ``<scope>.watchdog``
(``register_metrics``), and every missed section lands a
``watchdog.miss`` instant in the flight recorder's timeline.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.runtime.pending import NULL_SECTION, harvest_to_host


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


class HostFailedError(ShardFailedError):
    """A whole host (one process's slice of the mesh: ``local_devices``
    shards, one contiguous key-group range) was declared dead: the chaos
    ``host.lost`` point fired, or every one of its shards ran past the
    miss budget while the other hosts stayed healthy. Recovery is
    host-granular: the survivors evacuate, the host's shard units
    restore, and its contiguous range replays."""

    def __init__(self, host: int, shards, reason: str) -> None:
        self.host = int(host)
        self.shards = tuple(int(s) for s in shards)
        RuntimeError.__init__(
            self,
            f"host {host} declared dead (shards "
            f"{list(self.shards)}): {reason} — host failover (restore "
            "that host's key-group ranges, replay only its span)")
        # a shard-granular consumer still reads one member
        self.shard = self.shards[0] if self.shards else -1
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
        t = self._topology
        if t is not None and t.num_shards != self.num_shards:
            # a failover or reshard renumbered the shards: the (hosts,
            # local) map no longer applies until an engine declares one
            self._topology = None

    #: HostTopology for host-granular escalation (None: shards only)
    _topology = None
    #: hosts declared dead over the watchdog's lifetime
    hosts_declared_dead = 0

    def set_topology(self, topology) -> None:
        """Teach the watchdog the mesh's ``(hosts, local)``
        factorization: the boundary probe then fires ``host.lost`` once
        per live host and escalates a miss streak that uniformly covers
        exactly one host's shards to :class:`HostFailedError`."""
        if topology is not None:
            topology.check_covers(self.num_shards)
        self._topology = topology

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
        topo = self._topology
        if chaos.armed():
            if topo is not None:
                for h in range(topo.num_hosts):
                    members = [p for p in topo.shards_of_host(h)
                               if p not in self.quarantined]
                    if not members:
                        continue
                    try:
                        chaos.fault_point("host.lost", host=h)
                    except chaos.InjectedFault as f:
                        self.declare_host_dead(
                            h, members, f"host.lost injected ({f})")
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
        if topo is not None:
            # a streak that covers EXACTLY one host's live shards, and no
            # other shard, is a lost process: declare the host. A streak
            # that spills outside one host stays shard-granular below.
            off = set(offenders)
            for h in range(topo.num_hosts):
                members = {p for p in topo.shards_of_host(h) if p in live}
                if members and off == members:
                    self.declare_host_dead(
                        h, sorted(members),
                        f"uniform deadline-miss streak across all "
                        f"{len(members)} live shards of host {h} "
                        f"(budget {self.max_misses}, deadline "
                        f"{self.deadline_ms} ms)")
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

    def declare_host_dead(self, host: int, shards, reason: str) -> None:
        """Quarantine every shard of ``host`` at once and raise the
        host-granular failure."""
        for p in shards:
            self.quarantined.add(int(p))
            if self._device_ids is not None \
                    and 0 <= int(p) < len(self._device_ids):
                self.quarantined_devices.add(self._device_ids[int(p)])
        self.declared_dead += 1
        self.hosts_declared_dead += 1
        raise HostFailedError(int(host), shards, reason)

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
                "hosts_declared_dead": self.hosts_declared_dead,
                "heartbeat_age_s": self.heartbeat_age_s()}

    def register_metrics(self, group) -> None:
        """Heartbeat/health gauges under ``<scope>.watchdog``."""
        g = group.add_group("watchdog")
        g.gauge("sections_timed", lambda: self.sections_timed)
        g.gauge("deadline_misses", lambda: self.deadline_misses)
        g.gauge("shards_quarantined", lambda: len(self.quarantined))
        g.gauge("declared_dead", lambda: self.declared_dead)
        g.gauge("hosts_declared_dead", lambda: self.hosts_declared_dead)
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
            # host-granular escalation needs the (hosts, local) map
            wd.set_topology(getattr(self, "host_topology", None))

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
