"""Shard-granular checkpoints: one independently restorable unit per
key-group range — lose one shard, restore one unit (port of
``flink_tpu/checkpoint/sharded.py``, host code in the reference's on-disk
layout, so either package restores the other's units).

Layout::

    <root>/chk-<id>/manifest.json          (top manifest: unit index and
                                            per-unit source positions)
    <root>/chk-<id>/shard-<g0>-<g1>/       (one write_snapshot_dir unit:
        manifest.json + CRCs               its own manifest and per-file
        op-unit.npz / op-unit.meta.pkl     CRC32s)

Every unit rides ``write_snapshot_dir``'s discipline (tmp + atomic
rename, per-file CRC32s, the ``checkpoint.write`` /
``checkpoint.write.torn`` fault points), so a torn write damages ONE unit,
and the read path falls back to that RANGE's unit in an older checkpoint
instead of discarding the whole chk-N.

A delta unit materializes over its base through the port's
``merge_incremental_state``, which replaces data-keyed maps whole
(ROADMAP.md Queue C item R2): a session fired between a base unit and its
delta does not come back. The reference's merge recurses into them.

A write is a ``checkpoint.write`` span and a range's restore lookup a
``checkpoint.restore`` span in the flight recorder's timeline, and each
is a span of the storage's ``TraceCollector`` (``traces=``, the process
default otherwise) with the checkpoint's id.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.checkpoint.storage import (
    CheckpointCorruptedError,
    merge_incremental_state,
    read_manifest,
    read_snapshot_dir,
    retain_verified_anchors,
    verify_snapshot_files,
    write_snapshot_dir,
)
from flink_tpu_torch.observe import flight_recorder as flight

GroupRange = Tuple[int, int]


def _unit_dirname(g0: int, g1: int) -> str:
    return f"shard-{int(g0)}-{int(g1)}"


def _ranges_intersect(a: GroupRange, b: GroupRange) -> bool:
    return a[0] <= b[1] and b[0] <= a[1]


class ShardedCheckpointStorage:
    """Directory-per-checkpoint, unit-per-key-group-range layout. The unit
    of corruption, fallback and restore is the RANGE, never the whole
    checkpoint."""

    def __init__(self, root: str, compress: bool = True, traces=None):
        from flink_tpu_torch.metrics.traces import default_collector

        self.root = root
        self.compress = compress
        #: the TraceCollector of write and restore spans: the process
        #: default unless the owner threads its own
        self.traces = traces or default_collector()
        #: ids whose every unit passed a full CRC verification in this
        #: process (units are immutable after the atomic rename)
        self._verified_ids: set = set()
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ write

    def write_checkpoint(self, checkpoint_id: int, job_name: str,
                         units: Dict[GroupRange, Dict[str, Any]],
                         positions: Dict[GroupRange, int],
                         incremental_base: Optional[int] = None) -> str:
        """Write one checkpoint of per-range units. ``positions`` maps each
        range to ITS source position (they diverge after a fallback or a
        partial failover; restore replays each range from its own).
        ``incremental_base``: record each unit as a delta over the same
        range's unit in chk-<base>."""
        with flight.span("checkpoint.write"), \
                self.traces.span("checkpoint", "sharded-write") as sp:
            sp.set_attribute("checkpointId", int(checkpoint_id))
            sp.set_attribute("units", len(units))
            sp.set_attribute("incremental", incremental_base is not None)
            return self._write_checkpoint_inner(
                checkpoint_id, job_name, units, positions, incremental_base)

    def _write_checkpoint_inner(self, checkpoint_id: int, job_name: str,
                                units, positions,
                                incremental_base: Optional[int]) -> str:
        final_dir = self._dir(checkpoint_id)
        parent = os.path.dirname(os.path.abspath(final_dir)) or "."
        os.makedirs(parent, exist_ok=True)
        if os.path.exists(final_dir) and os.listdir(final_dir) and \
                not os.path.exists(os.path.join(final_dir,
                                                "manifest.json")):
            raise FileExistsError(
                f"refusing to replace non-checkpoint dir {final_dir!r}")
        tmp_dir = tempfile.mkdtemp(prefix=f".schk-{checkpoint_id}-",
                                   dir=parent)
        try:
            index: Dict[str, Dict[str, Any]] = {}
            for (g0, g1), state in units.items():
                extra: Dict[str, Any] = {
                    "source_pos": int(positions[(g0, g1)]),
                    "key_groups": [int(g0), int(g1)],
                }
                if incremental_base is not None:
                    extra["incremental"] = True
                    extra["base"] = int(incremental_base)
                write_snapshot_dir(
                    os.path.join(tmp_dir, _unit_dirname(g0, g1)),
                    checkpoint_id, job_name, {"unit": state},
                    extra=extra, compress=self.compress)
                index[_unit_dirname(g0, g1)] = {
                    "key_groups": [int(g0), int(g1)],
                    "source_pos": int(positions[(g0, g1)]),
                }
            manifest = {
                "checkpoint_id": int(checkpoint_id),
                "job_name": job_name,
                "timestamp_ms": int(time.time() * 1000),
                "sharded": True,
                "units": index,
            }
            with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final_dir):
                shutil.rmtree(final_dir)
            os.rename(tmp_dir, final_dir)
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        return final_dir

    # ------------------------------------------------------------------- read

    def checkpoint_ids(self) -> List[int]:
        ids = []
        for name in os.listdir(self.root):
            if name.startswith("chk-") and name[4:].isdigit() \
                    and os.path.exists(os.path.join(
                        self.root, name, "manifest.json")):
                ids.append(int(name[4:]))
        return sorted(ids)

    def latest_checkpoint_id(self) -> Optional[int]:
        ids = self.checkpoint_ids()
        return ids[-1] if ids else None

    def unit_ranges(self, checkpoint_id: int) -> List[GroupRange]:
        manifest = self._top_manifest(checkpoint_id)
        return sorted(tuple(u["key_groups"])
                      for u in manifest["units"].values())

    def _top_manifest(self, checkpoint_id: int) -> Dict[str, Any]:
        with open(os.path.join(self._dir(checkpoint_id),
                               "manifest.json")) as f:
            return json.load(f)

    def _read_unit_dir(self, path: str, verify: bool
                       ) -> Tuple[Dict[str, Any], int]:
        """(state, source_pos) of one unit dir, materializing its
        per-range incremental chain (each link verified when asked)."""
        states = read_snapshot_dir(path, verify=verify)
        extra = read_manifest(path).get("extra", {})
        state = states["unit"]
        if extra.get("incremental"):
            g0, g1 = extra["key_groups"]
            base_dir = os.path.join(self._dir(int(extra["base"])),
                                    _unit_dirname(g0, g1))
            if not os.path.isdir(base_dir):
                raise CheckpointCorruptedError(
                    f"delta unit {path!r} references missing base "
                    f"chk-{extra['base']} for range {g0}-{g1}")
            base_state, _ = self._read_unit_dir(base_dir, verify)
            state = merge_incremental_state(base_state, state)
        return state, int(extra["source_pos"])

    def read_unit(self, checkpoint_id: int, key_range: GroupRange,
                  verify: bool = True) -> Tuple[Dict[str, Any], int]:
        return self._read_unit_dir(
            os.path.join(self._dir(checkpoint_id),
                         _unit_dirname(*key_range)),
            verify)

    def latest_units_for_groups(
            self, groups) -> Optional[Tuple[int, List[Dict[str, Any]],
                                            int]]:
        """The newest checkpoint whose units COVERING ``groups`` all pass
        verification: ``(checkpoint_id, unit_states, source_pos)`` with
        ``source_pos`` the MIN over the covering units. A torn covering
        unit fails THIS checkpoint for this range only — the search falls
        back to the previous checkpoint's covering units. None when no
        checkpoint covers the groups (a cold start for that range)."""
        gset = [int(g) for g in groups]
        with flight.span("checkpoint.restore"), \
                self.traces.span("recovery", "restore-units") as sp:
            sp.set_attribute("key_groups", [min(gset), max(gset)])
            found = self._latest_units_for_groups(gset)
            sp.set_attribute("checkpointId",
                             found[0] if found is not None else None)
            return found

    def _latest_units_for_groups(self, groups):
        gset = set(int(g) for g in groups)
        lo, hi = min(gset), max(gset)
        for cid in reversed(self.checkpoint_ids()):
            covering = [r for r in self.unit_ranges(cid)
                        if _ranges_intersect(r, (lo, hi))]
            if not covering:
                continue
            try:
                read = [self.read_unit(cid, r, verify=True)
                        for r in covering]
            except (CheckpointCorruptedError, OSError, ValueError):
                continue
            return (cid, [state for state, _ in read],
                    min(pos for _, pos in read))
        return None

    def read_all_units_with_fallback(
            self) -> Optional[Tuple[int, List[Tuple[GroupRange,
                                                    Dict[str, Any],
                                                    int]], int]]:
        """Whole-job restore with PER-UNIT fallback: the newest
        checkpoint's ranges, each range's state from the newest checkpoint
        where ITS unit verifies. Returns ``(newest_id, [(range, state,
        source_pos)], corrupt_units_skipped)``; a range whose every unit
        is corrupt restores cold (absent from the list). None when no
        checkpoint exists."""
        ids = self.checkpoint_ids()
        if not ids:
            return None
        newest = ids[-1]
        out: List[Tuple[GroupRange, Dict[str, Any], int]] = []
        skipped = 0
        for r in self.unit_ranges(newest):
            found = None
            for cid in reversed(ids):
                if r not in set(map(tuple, self.unit_ranges(cid))):
                    continue
                try:
                    state, pos = self.read_unit(cid, r, verify=True)
                except (CheckpointCorruptedError, OSError, ValueError):
                    skipped += 1
                    continue
                found = (r, state, pos)
                break
            if found is not None:
                out.append(found)
        return newest, out, skipped

    # -------------------------------------------------------------- retention

    def _unit_chain(self, cid: int, r: GroupRange) -> List[int]:
        """``cid`` and every checkpoint id range ``r``'s incremental chain
        references, newest first."""
        chain = [cid]
        while True:
            path = os.path.join(self._dir(chain[-1]), _unit_dirname(*r))
            extra = read_manifest(path).get("extra", {})
            if not extra.get("incremental"):
                return chain
            chain.append(int(extra["base"]))

    def _chain_ids(self, cid: int) -> set:
        out = {cid}
        for r in self.unit_ranges(cid):
            out.update(self._unit_chain(cid, r))
        return out

    def retain(self, keep: int) -> None:
        """Drop all but the newest ``keep`` checkpoints whose EVERY unit —
        each unit's incremental base chain included — passes CRC
        verification; never the fallback chain below a torn newest
        (``storage.retain_verified_anchors``, shared with the flat
        store)."""
        if keep <= 0:
            return

        def verify_ok(cid: int) -> bool:
            try:
                for r in self.unit_ranges(cid):
                    for link in self._unit_chain(cid, r):
                        path = os.path.join(self._dir(link),
                                            _unit_dirname(*r))
                        verify_snapshot_files(
                            path, read_manifest(path).get("file_crcs")
                            or {})
                return True
            except (CheckpointCorruptedError, OSError, ValueError,
                    KeyError):
                return False

        retain_verified_anchors(
            self.checkpoint_ids(), keep, verify_ok, self._chain_ids,
            self._verified_ids,
            lambda cid: shutil.rmtree(self._dir(cid), ignore_errors=True))

    # ---------------------------------------------------------------- helpers

    def _dir(self, checkpoint_id: int) -> str:
        return os.path.join(self.root, f"chk-{checkpoint_id}")
