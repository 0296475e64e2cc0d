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

Not carried: ``rescales=``/``rebalances=`` (live reshard, ROADMAP item
12), ``run_crash_restore_verify_multi`` and ``run_shard_loss_verify``
(shard-granular checkpoints, item 8b), the report's metric gauges and the
trace spans (item 12).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.chaos import injection as chaos
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
    #: the reference's live-rescale and shard-loss counters: they stay 0
    #: here (items 12 and 8b) and keep the signature's keys the same
    live_handoffs: int = 0
    shards_lost: int = 0
    shard_restores: int = 0
    records_replayed: int = 0
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

    @property
    def diverged(self) -> bool:
        return bool(self.divergences)

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
    store."""
    from flink_tpu_torch.core.records import KEY_ID_FIELD, TIMESTAMP_FIELD
    from flink_tpu_torch.windowing.windower import (
        WINDOW_END_FIELD,
        WINDOW_START_FIELD,
    )

    for b in fired:
        if b is None:
            continue
        if hasattr(b, "harvest"):  # PendingFire (async dispatch-ahead)
            b = b.harvest()
            if b is None:
                continue
        for r in b.to_rows():
            key = (int(r[KEY_ID_FIELD]), int(r[WINDOW_START_FIELD]),
                   int(r[WINDOW_END_FIELD]))
            out[key] = {
                name: float(v) for name, v in r.items()
                if name not in (KEY_ID_FIELD, WINDOW_START_FIELD,
                                WINDOW_END_FIELD, TIMESTAMP_FIELD)
            }


def _diff(expected: Dict[_WindowKey, Dict[str, float]],
          got: Dict[_WindowKey, Dict[str, float]],
          rel_tol: float, abs_tol: float,
          max_report: int = 20) -> List[str]:
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
) -> ChaosReport:
    """Run ``steps`` (a list of ``(keys, values, timestamps, watermark)``)
    through a chaotic engine with periodic checkpoints and through a
    fault-free oracle; crash, restore, replay; diff the committed output.
    Raises :class:`ChaosDivergenceError` on any divergence (``check=False``
    returns the report instead — for tests that prove the harness catches
    lossy faults)."""
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

