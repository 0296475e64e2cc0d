"""Crash-restore-verify: the executable exactly-once claim (port of
``flink_tpu/chaos/harness.py``).

Drives a keyed-window engine (mesh or single-device) through a seeded event
stream with periodic checkpoints while a :class:`FaultPlan` is armed. Every
injected crash KILLS the engine (the object is discarded, like a preempted
worker), a fresh engine restores from the latest *complete* checkpoint
(``latest_checkpoint_id(verify=True)`` skips torn or corrupt snapshots by
their manifest CRCs), and the source replays from the position recorded in
that checkpoint's manifest. The committed output is diffed window by
window against a fault-free oracle run.

Sink model: a keyed idempotent upsert committed per checkpoint epoch.
Output produced since the last completed checkpoint is buffered and
DISCARDED on a crash; the replay produces it again. A replayed fire lands
on the same ``(key, window_start, window_end)`` cell, so the diff catches
any lost, duplicated or corrupted record as a wrong final value.

:func:`run_shard_loss_verify` is the partial-failover form: the unit of
failure and recovery is the SHARD (key-group range), not the job.

``ChaosReport.register_metrics`` puts the report's restore-path counters
on a job metric tree, and each shard failover is a ``failover.replay``
span in the flight recorder's timeline.

:func:`run_crash_restore_verify_multi` is the multi-tenant form: N jobs'
engines advance interleaved, one step each per round, and a crash in one
job restores THAT job only.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.observe import flight_recorder as flight
from flink_tpu_torch.chaos.injection import FaultPlan, InjectedFault

#: end-of-stream watermark (the test-suite flush convention)
FINAL_WATERMARK = 1 << 60

_WindowKey = Tuple[int, int, int]


class ChaosDivergenceError(AssertionError):
    """Committed output diverged from the fault-free oracle."""


@dataclasses.dataclass
class ChaosReport:
    events: int = 0
    windows: int = 0
    crashes: int = 0
    restores: int = 0
    cold_restarts: int = 0
    checkpoints_written: int = 0
    corrupt_checkpoints_skipped: int = 0
    faults_injected: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    points_hit: Dict[str, int] = dataclasses.field(default_factory=dict)
    retries: int = 0
    recoveries: int = 0
    #: completed LIVE key-group migrations (``rescales=``)
    live_handoffs: int = 0
    #: shard-granular failovers (run_shard_loss_verify): shards declared
    #: dead, key-group ranges restored from their checkpoint units, and
    #: records fed again to rebuild those ranges — the bounded-replay
    #: claim is ``records_replayed <= events/shards``
    shards_lost: int = 0
    shard_restores: int = 0
    records_replayed: int = 0
    shard_loss_recovery_ms: float = 0.0
    #: host-granular failovers (a HostFailedError: one per lost host)
    hosts_lost: int = 0
    divergences: List[str] = dataclasses.field(default_factory=list)
    #: measurements, not part of the signature: events fed again after
    #: restores (from each restored checkpoint's position up to the
    #: furthest step reached), the bytes and write ms of every checkpoint,
    #: and the ms of every restore (read + engine restore)
    events_replayed: int = 0
    checkpoint_bytes: List[int] = dataclasses.field(default_factory=list)
    checkpoint_write_ms: List[float] = dataclasses.field(
        default_factory=list)
    restore_ms: List[float] = dataclasses.field(default_factory=list)
    #: the committed output, ``{(key, window_start, window_end): {field:
    #: value}}``, for callers that hold it against an oracle of their own
    committed: Dict[_WindowKey, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: run_shard_loss_verify: the recovery's wall ms by part, summed over
    #: losses — "evacuate" (fences, the survivors' lift), "rebuild" (the
    #: P-k planes and everything sized by P), "land" (the survivors' put),
    #: "unit_read" (the covering units, CRC-verified), "unit_restore"
    #: (merge and restore_key_groups) and "replay"
    shard_loss_parts_ms: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def diverged(self) -> bool:
        return bool(self.divergences)

    def register_metrics(self, group) -> None:
        """The restore-path counters on a job metric tree
        (``<scope>.chaos.*``): gauges read the live report, so a group
        registered before the run sees every later restore."""
        g = group.add_group("chaos")
        for name in ("restores", "cold_restarts",
                     "corrupt_checkpoints_skipped", "crashes",
                     "shards_lost", "hosts_lost", "shard_restores",
                     "records_replayed", "checkpoints_written"):
            g.gauge(name, lambda self=self, n=name: getattr(self, n))

    def signature(self) -> Dict[str, Any]:
        """The determinism fingerprint: two runs with the same (plan, seed,
        steps) produce identical signatures."""
        return {
            "crashes": self.crashes,
            "restores": self.restores,
            "cold_restarts": self.cold_restarts,
            "checkpoints_written": self.checkpoints_written,
            "faults_injected": dict(self.faults_injected),
            "windows": self.windows,
            "live_handoffs": self.live_handoffs,
            "shards_lost": self.shards_lost,
            "hosts_lost": self.hosts_lost,
            "shard_restores": self.shard_restores,
            "records_replayed": self.records_replayed,
            "diverged": self.diverged,
        }


def _keyed_batch(keys, values, ts):
    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch

    return RecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(values, dtype=np.float32)},
        timestamps=np.asarray(ts, dtype=np.int64))


def _collect(fired, out: Dict[_WindowKey, Dict[str, float]]) -> None:
    """Fold fired batches (or PendingFire handles) into the keyed upsert
    store: one ``(key, window_start, window_end) -> {field: float}`` cell
    per row, built column-wise (the values are the rows' ``float(v)``)."""
    from flink_tpu_torch.core.records import KEY_ID_FIELD, TIMESTAMP_FIELD
    from flink_tpu_torch.windowing.windower import (
        WINDOW_END_FIELD,
        WINDOW_START_FIELD,
    )

    skip = (KEY_ID_FIELD, WINDOW_START_FIELD, WINDOW_END_FIELD,
            TIMESTAMP_FIELD)
    for b in fired:
        if b is None:
            continue
        if hasattr(b, "harvest"):  # PendingFire (async dispatch-ahead)
            b = b.harvest()
            if b is None:
                continue
        cols = b.columns
        cells = zip(np.asarray(cols[KEY_ID_FIELD], np.int64).tolist(),
                    np.asarray(cols[WINDOW_START_FIELD], np.int64).tolist(),
                    np.asarray(cols[WINDOW_END_FIELD], np.int64).tolist())
        names = [n for n in cols if n not in skip]
        vals = [np.asarray(cols[n]).astype(np.float64).tolist()
                for n in names]
        out.update(zip(cells, (dict(zip(names, row))
                               for row in zip(*vals))
                       if vals else ({} for _ in range(len(b)))))


def _diff(expected: Dict[_WindowKey, Dict[str, float]],
          got: Dict[_WindowKey, Dict[str, float]],
          rel_tol: float, abs_tol: float,
          max_report: int = 20) -> List[str]:
    if expected == got:
        return []  # equal cells (NaN-free): nothing to walk
    divs: List[str] = []
    for k in sorted(set(expected) | set(got)):
        if len(divs) >= max_report:
            divs.append("... (truncated)")
            break
        if k not in got:
            divs.append(f"missing window {k}: expected {expected[k]}")
        elif k not in expected:
            divs.append(f"spurious window {k}: got {got[k]}")
        else:
            for name, want in expected[k].items():
                have = got[k].get(name)
                if have is None or abs(have - want) > max(
                        abs_tol, rel_tol * abs(want)):
                    divs.append(
                        f"window {k} field {name}: expected {want}, "
                        f"got {have}")
    return divs


def _restore_latest(storage, ckpt_dir: str, engine,
                    report: ChaosReport) -> Optional[int]:
    """Restore ``engine`` from the newest VERIFIED checkpoint, counting a
    ``corrupt_checkpoints_skipped`` whenever verification fell back past a
    newer torn or corrupt snapshot. Returns the restored source position,
    or None for a cold restart (no usable checkpoint: the caller resets
    its committed output and replays from 0)."""
    from flink_tpu_torch.checkpoint.storage import read_manifest

    newest = storage.latest_checkpoint_id()
    best = storage.latest_checkpoint_id(verify=True)
    if newest is not None and (best is None or best < newest):
        report.corrupt_checkpoints_skipped += 1
    if best is None:
        report.cold_restarts += 1
        return None
    t0 = time.perf_counter()
    # verify=False: latest_checkpoint_id just CRC-passed this id
    states = storage.read_checkpoint(best, verify=False)
    engine.restore(states["engine"])
    report.restore_ms.append((time.perf_counter() - t0) * 1e3)
    manifest = read_manifest(os.path.join(ckpt_dir, f"chk-{best}"))
    report.restores += 1
    return int(manifest["extra"]["source_pos"])


def run_crash_restore_verify(
    make_engine: Callable[[], Any],
    make_oracle: Callable[[], Any],
    steps: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    plan: FaultPlan,
    seed: int,
    ckpt_root: str,
    checkpoint_every: int = 2,
    job_name: str = "chaos-harness",
    max_crashes: int = 32,
    async_fires: bool = False,
    rel_tol: float = 1e-4,
    abs_tol: float = 1e-3,
    check: bool = True,
    rescales: Optional[Dict[int, int]] = None,
    rebalances: Optional[Dict[int, Any]] = None,
) -> ChaosReport:
    """Run ``steps`` (a list of ``(keys, values, timestamps, watermark)``)
    through a chaotic engine with periodic checkpoints and through a
    fault-free oracle; crash, restore, replay; diff the committed output.
    Raises :class:`ChaosDivergenceError` on any divergence (``check=False``
    returns the report instead — for tests that prove the harness catches
    lossy faults).

    ``rescales``: {step position -> shard count} — before that step the
    engine LIVE-migrates its key groups (``engine.reshard``), optionally
    crashed by a ``rescale.handoff`` fault; after a restore the replayed
    engine reshards again when it reaches a scheduled position.

    ``rebalances``: {step position -> ``KeyGroupAssignment``, or a
    callable ``engine -> assignment``} — before that step the engine
    live-MOVES key groups between shards at unchanged P
    (``engine.reassign_key_groups``), optionally crashed by a
    ``rebalance.handoff`` fault. The assignment is routing state, not
    checkpointed: a restored engine comes back contiguous and re-applies
    the move when the replay reaches the position again."""
    from flink_tpu_torch.checkpoint.storage import CheckpointStorage

    if chaos.armed():
        raise RuntimeError(
            "run_crash_restore_verify arms its own controller — disarm "
            "the ambient one first (the oracle must run fault-free)")

    report = ChaosReport()
    report.events = int(sum(len(s[0]) for s in steps))

    # ---- fault-free oracle ----
    expected: Dict[_WindowKey, Dict[str, float]] = {}
    oracle = make_oracle()
    for keys, vals, ts, wm in steps:
        oracle.process_batch(_keyed_batch(keys, vals, ts))
        _collect(oracle.on_watermark(int(wm)), expected)
    _collect(oracle.on_watermark(FINAL_WATERMARK), expected)

    # ---- chaotic run: process / checkpoint / crash / restore ----
    storage = CheckpointStorage(ckpt_root)
    committed: Dict[_WindowKey, Dict[str, float]] = {}
    epoch: Dict[_WindowKey, Dict[str, float]] = {}
    n_steps = len(steps)
    # the furthest step any incarnation reached: steps below it that run
    # again after a restore are the replay
    high_water = 0
    with chaos.chaos_active(plan, seed) as ctl:
        engine = make_engine()
        pos = 0
        cid = 0
        need_restore = False
        while pos <= n_steps:
            try:
                if need_restore:
                    # a crash here (e.g. an injected checkpoint.read fault)
                    # loops back through the except arm again
                    engine = make_engine()
                    restored = _restore_latest(storage, ckpt_root,
                                               engine, report)
                    if restored is None:
                        committed = {}
                        pos = 0
                    else:
                        pos = restored
                    need_restore = False
                    continue
                if rescales and pos in rescales and \
                        int(getattr(engine, "P", 0)) != rescales[pos]:
                    engine.reshard(rescales[pos])
                    report.live_handoffs += 1
                if rebalances and pos in rebalances:
                    target = rebalances[pos]
                    if callable(target):
                        target = target(engine)
                    rep = engine.reassign_key_groups(target)
                    if rep.get("groups_moved", 0):
                        report.live_handoffs += 1
                if pos == n_steps:
                    # end of input: flush every remaining window
                    _collect(engine.on_watermark(
                        FINAL_WATERMARK,
                        **({"async_ok": True} if async_fires else {})),
                        epoch)
                else:
                    keys, vals, ts, wm = steps[pos]
                    if pos < high_water:
                        report.events_replayed += len(keys)
                    engine.process_batch(_keyed_batch(keys, vals, ts))
                    _collect(engine.on_watermark(
                        int(wm),
                        **({"async_ok": True} if async_fires else {})),
                        epoch)
                next_pos = pos + 1
                high_water = max(high_water, next_pos)
                if next_pos % checkpoint_every == 0 or next_pos > n_steps:
                    cid += 1
                    t0 = time.perf_counter()
                    new_dir = storage.write_checkpoint(
                        cid, job_name, {"engine": engine.snapshot()},
                        extra={"source_pos": next_pos})
                    report.checkpoint_write_ms.append(
                        (time.perf_counter() - t0) * 1e3)
                    report.checkpoint_bytes.append(sum(
                        e.stat().st_size for e in os.scandir(new_dir)
                        if e.is_file()))
                    report.checkpoints_written += 1
                    # checkpoint complete => the epoch's output commits
                    # (two-phase: pre-commit buffered, commit on ack)
                    committed.update(epoch)
                    epoch = {}
                pos = next_pos
            except InjectedFault:
                report.crashes += 1
                if report.crashes > max_crashes:
                    raise
                # KILL: discard the engine and all uncommitted output
                epoch = {}
                need_restore = True

        report.faults_injected = dict(ctl.faults_injected)
        report.points_hit = dict(ctl.points_hit)
        report.retries = ctl.retries
        report.recoveries = ctl.recoveries

    report.windows = len(committed)
    report.committed = committed
    report.divergences = _diff(expected, committed, rel_tol, abs_tol)
    if check and report.divergences:
        raise ChaosDivergenceError(
            f"crash-restore output diverged from the fault-free oracle "
            f"({len(report.divergences)} differences):\n  "
            + "\n  ".join(report.divergences))
    return report


def run_crash_restore_verify_multi(
    make_engines: Dict[str, Callable[[], Any]],
    make_oracles: Dict[str, Callable[[], Any]],
    steps_by_job: Dict[str, Sequence[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, int]]],
    plan: FaultPlan,
    seed: int,
    ckpt_root: str,
    checkpoint_every: int = 2,
    max_crashes: int = 32,
    serve_keys: Optional[Dict[str, Sequence[int]]] = None,
    rel_tol: float = 1e-4,
    abs_tol: float = 1e-3,
    check: bool = True,
) -> Dict[str, ChaosReport]:
    """Multi-tenant form of :func:`run_crash_restore_verify`: N jobs'
    engines share the process (and the mesh, and the compiled-program
    cache) and advance INTERLEAVED, one step per job per round — the
    tenancy session cluster's schedule, collapsed to its essence. Each
    job checkpoints into its own subdirectory of ``ckpt_root``; a crash
    in one job's step kills and restores THAT job only, its siblings'
    engines untouched (independent failure domains — the claim under
    test). Each job's committed output is diffed against its own
    fault-free oracle.

    ``serve_keys``: {job -> key ids} — after every step the job serves a
    batched queryable-state lookup (``engine.query_batch``) through the
    ``serving.lookup`` fault point with the site-local retry wrapper, so
    a plan can (a) inject transient serving faults that must retry
    without corrupting engine state, and (b) crash a job MID-SERVING-
    BURST and still restore oracle-identical."""
    from flink_tpu_torch.checkpoint.storage import CheckpointStorage

    if chaos.armed():
        raise RuntimeError(
            "run_crash_restore_verify_multi arms its own controller — "
            "disarm the ambient one first (oracles must run fault-free)")
    jobs = list(make_engines)
    reports = {j: ChaosReport() for j in jobs}
    expected: Dict[str, Dict[_WindowKey, Dict[str, float]]] = {}
    for j in jobs:
        reports[j].events = int(sum(len(s[0]) for s in steps_by_job[j]))
        exp: Dict[_WindowKey, Dict[str, float]] = {}
        oracle = make_oracles[j]()
        for keys, vals, ts, wm in steps_by_job[j]:
            oracle.process_batch(_keyed_batch(keys, vals, ts))
            _collect(oracle.on_watermark(int(wm)), exp)
        _collect(oracle.on_watermark(FINAL_WATERMARK), exp)
        expected[j] = exp

    storages = {j: CheckpointStorage(os.path.join(ckpt_root, j))
                for j in jobs}
    committed: Dict[str, Dict[_WindowKey, Dict[str, float]]] = {
        j: {} for j in jobs}
    epoch: Dict[str, Dict[_WindowKey, Dict[str, float]]] = {
        j: {} for j in jobs}
    state = {j: {"pos": 0, "cid": 0, "restore": False, "done": False}
             for j in jobs}

    def _serve(job: str, engine) -> None:
        if not serve_keys or job not in serve_keys:
            return

        def _lookup():
            chaos.fault_point("serving.lookup", job=job,
                              keys=len(serve_keys[job]))
            return engine.query_batch(
                np.asarray(serve_keys[job], dtype=np.int64))

        chaos.run_recoverable("serving.lookup", _lookup)

    #: per-job deltas of the controller-global counters, taken around
    #: each job's step — a plan targeting one tenant must show up in
    #: THAT job's report only
    job_faults: Dict[str, Dict[str, int]] = {j: {} for j in jobs}
    job_hits: Dict[str, Dict[str, int]] = {j: {} for j in jobs}
    job_retries = {j: 0 for j in jobs}
    job_recoveries = {j: 0 for j in jobs}
    with chaos.chaos_active(plan, seed) as ctl:
        engines = {j: make_engines[j]() for j in jobs}
        while not all(state[j]["done"] for j in jobs):
            for j in jobs:
                st = state[j]
                if st["done"]:
                    continue
                steps = steps_by_job[j]
                n_steps = len(steps)
                storage = storages[j]
                pre_faults = dict(ctl.faults_injected)
                pre_hits = dict(ctl.points_hit)
                pre_retries, pre_recoveries = ctl.retries, ctl.recoveries
                try:
                    if st["restore"]:
                        engines[j] = make_engines[j]()
                        restored = _restore_latest(
                            storage, os.path.join(ckpt_root, j),
                            engines[j], reports[j])
                        if restored is None:
                            committed[j] = {}
                            st["pos"] = 0
                        else:
                            st["pos"] = restored
                        st["restore"] = False
                        continue
                    pos = st["pos"]
                    if pos == n_steps:
                        _collect(engines[j].on_watermark(FINAL_WATERMARK),
                                 epoch[j])
                    else:
                        keys, vals, ts, wm = steps[pos]
                        engines[j].process_batch(
                            _keyed_batch(keys, vals, ts))
                        _collect(engines[j].on_watermark(int(wm)),
                                 epoch[j])
                    _serve(j, engines[j])
                    next_pos = pos + 1
                    if next_pos % checkpoint_every == 0 \
                            or next_pos > n_steps:
                        st["cid"] += 1
                        storage.write_checkpoint(
                            st["cid"], j,
                            {"engine": engines[j].snapshot()},
                            extra={"source_pos": next_pos})
                        reports[j].checkpoints_written += 1
                        committed[j].update(epoch[j])
                        epoch[j] = {}
                    st["pos"] = next_pos
                    if next_pos > n_steps:
                        st["done"] = True
                except InjectedFault:
                    reports[j].crashes += 1
                    if reports[j].crashes > max_crashes:
                        raise
                    epoch[j] = {}
                    st["restore"] = True
                finally:
                    for point, count in ctl.faults_injected.items():
                        d = count - pre_faults.get(point, 0)
                        if d:
                            job_faults[j][point] = \
                                job_faults[j].get(point, 0) + d
                    # points_hit attributed per job like the fault
                    # counters — a global copy claimed other tenants'
                    # hits in every report
                    for point, count in ctl.points_hit.items():
                        d = count - pre_hits.get(point, 0)
                        if d:
                            job_hits[j][point] = \
                                job_hits[j].get(point, 0) + d
                    job_retries[j] += ctl.retries - pre_retries
                    job_recoveries[j] += ctl.recoveries - pre_recoveries
        for j in jobs:
            reports[j].faults_injected = job_faults[j]
            reports[j].points_hit = job_hits[j]
            reports[j].retries = job_retries[j]
            reports[j].recoveries = job_recoveries[j]

    for j in jobs:
        reports[j].windows = len(committed[j])
        reports[j].divergences = _diff(expected[j], committed[j],
                                       rel_tol, abs_tol)
        if check and reports[j].divergences:
            raise ChaosDivergenceError(
                f"job {j!r}: crash-restore output diverged from its "
                f"fault-free oracle ({len(reports[j].divergences)} "
                "differences):\n  "
                + "\n  ".join(reports[j].divergences))
    return reports


def run_shard_loss_verify(
    make_engine: Callable[[], Any],
    make_oracle: Callable[[], Any],
    steps: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    plan: FaultPlan,
    seed: int,
    ckpt_root: str,
    checkpoint_every: int = 2,
    job_name: str = "shard-loss-harness",
    max_shard_losses: int = 4,
    max_crashes: int = 8,
    watchdog_deadline_ms: float = 0.0,
    watchdog_max_misses: int = 3,
    rel_tol: float = 1e-4,
    abs_tol: float = 1e-3,
    check: bool = True,
) -> ChaosReport:
    """Partial-failover form of :func:`run_crash_restore_verify`: the unit
    of failure and recovery is the SHARD (key-group range).

    A :class:`~flink_tpu_torch.runtime.watchdog.DeviceWatchdog` wraps the
    engine's device interactions; a chaos ``device.lost`` fault (or an
    escalated ``watchdog.deadline`` miss streak) declares one shard dead
    at a batch boundary. Recovery then

    1. evacuates the SURVIVORS' rows and rebuilds the mesh over the
       remaining shards (``engine.lose_shards``),
    2. restores ONLY the dead shard's key groups from their newest
       verified checkpoint unit (``ShardedCheckpointStorage``: a torn
       unit falls back to that RANGE's unit in an older checkpoint), and
    3. replays ONLY that range's records from the unit's source position
       (``records_replayed``: about ``events/shards`` per loss).

    Checkpoints are written per shard (``engine.snapshot_sharded``, per-
    unit source positions). Any other injected fault takes the whole-job
    path: a fresh engine restores ALL units with per-unit fallback, and
    ranges whose unit is ahead of the replay start are GATED during the
    catch-up so they never absorb a record twice.

    The committed output is held to the fault-free oracle, and the whole
    run is reproducible from ``(plan, seed)``."""
    from flink_tpu_torch.checkpoint.sharded import ShardedCheckpointStorage
    from flink_tpu_torch.runtime.watchdog import (
        DeviceWatchdog,
        HostFailedError,
        MeshStalledError,
        ShardFailedError,
    )
    from flink_tpu_torch.state.keygroups import assign_key_groups

    if chaos.armed():
        raise RuntimeError(
            "run_shard_loss_verify arms its own controller — disarm the "
            "ambient one first (the oracle must run fault-free)")

    report = ChaosReport()
    report.events = int(sum(len(s[0]) for s in steps))

    # ---- fault-free oracle ----
    expected: Dict[_WindowKey, Dict[str, float]] = {}
    oracle = make_oracle()
    for keys, vals, ts, wm in steps:
        oracle.process_batch(_keyed_batch(keys, vals, ts))
        _collect(oracle.on_watermark(int(wm)), expected)
    _collect(oracle.on_watermark(FINAL_WATERMARK), expected)
    del oracle

    # ---- chaotic run ----
    storage = ShardedCheckpointStorage(ckpt_root)
    committed: Dict[_WindowKey, Dict[str, float]] = {}
    epoch: Dict[_WindowKey, Dict[str, float]] = {}
    n_steps = len(steps)
    parts = report.shard_loss_parts_ms

    def _part(name: str, seconds: float) -> None:
        parts[name] = parts.get(name, 0.0) + seconds * 1e3

    def _attach(engine):
        engine.attach_watchdog(DeviceWatchdog(
            engine.P, deadline_ms=watchdog_deadline_ms,
            max_misses=watchdog_max_misses))
        return engine

    def _range_mask(keys, g0: int, g1: int) -> np.ndarray:
        kg = assign_key_groups(np.asarray(keys, dtype=np.int64),
                               engine.max_parallelism)
        return (kg >= g0) & (kg <= g1)

    with chaos.chaos_active(plan, seed) as ctl:
        engine = _attach(make_engine())
        pos = 0
        cid = 0
        phase = 0             # 0: the batch is next, 1: the watermark
        need_restore = False
        pending_loss: Optional[Tuple[tuple, int]] = None  # (shards, phase)
        #: (g0, g1, pos_r): a range already absorbed up to pos_r — its
        #: records are skipped while pos < pos_r (mixed-age units)
        gates: List[Tuple[int, int, int]] = []
        while pos <= n_steps:
            try:
                if need_restore:
                    engine = _attach(make_engine())
                    found = storage.read_all_units_with_fallback()
                    if found is None:
                        report.cold_restarts += 1
                        committed, epoch = {}, {}
                        pos, phase, gates = 0, 0, []
                        need_restore = False
                        continue
                    newest, units, skipped = found
                    report.corrupt_checkpoints_skipped += skipped
                    states = [state for _, state, _ in units]
                    if len(units) < len(storage.unit_ranges(newest)):
                        # a range with NO restorable unit replays cold
                        # from 0: its guards roll all the way back (an
                        # empty pseudo-unit takes the merge's defaults)
                        states = states + [{}]
                    engine.restore(engine.merge_unit_snapshots(states))
                    report.restores += 1
                    positions = {r: p for r, _, p in units}
                    pos = min(positions.values()) \
                        if len(units) == len(
                            storage.unit_ranges(newest)) else 0
                    gates = [(r[0], r[1], p)
                             for r, p in positions.items() if p > pos]
                    phase = 0
                    need_restore = False
                    continue
                if pending_loss is not None:
                    dead_shards, at_phase = pending_loss
                    t0 = time.perf_counter()
                    # the recovery in the flight recorder's timeline
                    with flight.span("failover.replay",
                                     shard=int(dead_shards[0])):
                        g0, g1 = engine.lose_shards(list(dead_shards))
                        loss = engine.last_shard_loss
                        _part("evacuate", loss["evacuate_seconds"])
                        _part("rebuild", loss["rebuild_seconds"])
                        _part("land", loss["land_seconds"])
                        groups = range(g0, g1 + 1)
                        # gates SPLIT around the dead range: its overlap is
                        # rebuilt from its unit, but a partly overlapping
                        # gate's outside sub-ranges are still ahead of pos
                        split: List[Tuple[int, int, int]] = []
                        for a, b, p_r in gates:
                            if b < g0 or a > g1:
                                split.append((a, b, p_r))
                                continue
                            if a < g0:
                                split.append((a, g0 - 1, p_r))
                            if b > g1:
                                split.append((g1 + 1, b, p_r))
                        gates = split
                        t1 = time.perf_counter()
                        found = storage.latest_units_for_groups(groups)
                        t2 = time.perf_counter()
                        if found is None:
                            unit_pos = 0
                            # a cold range: its guards roll back to the start
                            engine.restore_key_groups({"table": {}}, groups)
                        else:
                            _ucid, states, unit_pos = found
                            engine.restore_key_groups(
                                engine.merge_unit_snapshots(states), groups)
                            report.shard_restores += 1
                        t3 = time.perf_counter()
                        _part("unit_read", t2 - t1)
                        _part("unit_restore", t3 - t2)
                        # the range's uncommitted output rolls back with its
                        # state; the replay produces it again
                        if epoch:
                            ekeys = np.asarray([k[0] for k in epoch],
                                               dtype=np.int64)
                            drop = _range_mask(ekeys, g0, g1)
                            epoch = {k: v for k, v, d in zip(
                                epoch, epoch.values(), drop) if not d}
                        # bounded replay: ONLY the range's records, from the
                        # unit's position; a step interrupted mid-watermark
                        # (at_phase=1) already absorbed pos's batch on the
                        # survivors, so the range absorbs through pos
                        # INCLUSIVE and the main flow fires pos's watermark
                        # for everyone. The watchdog is detached for the
                        # replay: a second loss declared mid-replay would
                        # abandon this range's rebuild (a dead second shard
                        # is declared at the next main-loop boundary)
                        wd_held = engine._watchdog
                        engine.attach_watchdog(None)
                        try:
                            upto = pos + (1 if at_phase == 1 else 0)
                            for rpos in range(unit_pos, min(upto, n_steps)):
                                keys, vals, ts, _wm = steps[rpos]
                                mask = _range_mask(keys, g0, g1)
                                if mask.any():
                                    engine.process_batch(_keyed_batch(
                                        keys[mask], vals[mask], ts[mask]))
                                    report.records_replayed += int(mask.sum())
                                if rpos < pos:
                                    _collect(engine.on_watermark(
                                        int(steps[rpos][3])), epoch)
                        finally:
                            engine._watchdog = wd_held
                    t4 = time.perf_counter()
                    _part("replay", t4 - t3)
                    report.shard_loss_recovery_ms += (t4 - t0) * 1e3
                    pending_loss = None
                    continue
                if phase == 0:
                    # gates expire first (at the final flush too, where
                    # no batch runs: a stuck gate would defer the final
                    # checkpoint and lose the last epoch)
                    if gates:
                        gates = [g for g in gates if pos < g[2]]
                    if pos < n_steps:
                        keys, vals, ts, _wm = steps[pos]
                        if gates:
                            kg = assign_key_groups(
                                np.asarray(keys, dtype=np.int64),
                                engine.max_parallelism)
                            allow = np.ones(len(keys), dtype=bool)
                            for a, b, _p in gates:
                                allow &= ~((kg >= a) & (kg <= b))
                            if allow.any():
                                engine.process_batch(_keyed_batch(
                                    keys[allow], vals[allow], ts[allow]))
                        else:
                            engine.process_batch(
                                _keyed_batch(keys, vals, ts))
                    phase = 1
                    continue
                # phase 1: the watermark (the FINAL flush at the end)
                wm = FINAL_WATERMARK if pos == n_steps \
                    else int(steps[pos][3])
                _collect(engine.on_watermark(wm), epoch)
                next_pos = pos + 1
                # checkpoints wait while replay gates are active: a gated
                # range's state is already ahead of pos, so recording
                # source_pos=next_pos for its unit would replay records
                # it holds (the gates expire within checkpoint_every)
                if (next_pos % checkpoint_every == 0
                        or next_pos > n_steps) and not gates:
                    cid += 1
                    t0 = time.perf_counter()
                    units = engine.snapshot_sharded()
                    new_dir = storage.write_checkpoint(
                        cid, job_name, units,
                        positions={r: next_pos for r in units})
                    report.checkpoint_write_ms.append(
                        (time.perf_counter() - t0) * 1e3)
                    report.checkpoint_bytes.append(sum(
                        f.stat().st_size
                        for d in os.scandir(new_dir) if d.is_dir()
                        for f in os.scandir(d.path) if f.is_file()))
                    report.checkpoints_written += 1
                    committed.update(epoch)
                    epoch = {}
                pos = next_pos
                phase = 0
            except ShardFailedError as sf:
                # a HostFailedError carries the host's whole slice: every
                # member counts toward the loss budget
                shards = tuple(getattr(sf, "shards", ()) or (sf.shard,))
                report.shards_lost += len(shards)
                if isinstance(sf, HostFailedError):
                    report.hosts_lost += 1
                if report.shards_lost > max_shard_losses:
                    raise
                pending_loss = (shards, phase)
            except (InjectedFault, MeshStalledError):
                # an unattributable mesh-wide stall takes the whole-job
                # path a crash does
                report.crashes += 1
                if report.crashes > max_crashes:
                    raise
                epoch = {}
                pending_loss = None
                need_restore = True

        report.faults_injected = dict(ctl.faults_injected)
        report.points_hit = dict(ctl.points_hit)
        report.retries = ctl.retries
        report.recoveries = ctl.recoveries

    report.windows = len(committed)
    report.committed = committed
    report.divergences = _diff(expected, committed, rel_tol, abs_tol)
    if check and report.divergences:
        raise ChaosDivergenceError(
            f"shard-loss output diverged from the fault-free oracle "
            f"({len(report.divergences)} differences):\n  "
            + "\n  ".join(report.divergences))
    return report
