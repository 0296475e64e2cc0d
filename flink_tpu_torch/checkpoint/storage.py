"""Checkpoint storage: durable snapshots and recovery (port of
``flink_tpu/checkpoint/storage.py``, host code in the reference's on-disk
format, so either package restores the other's checkpoints).

A checkpoint is a directory holding, per stateful operator, one ``.npz``
with its logical keyed-state arrays (key_id / namespace / key_group / leaf
columns — key-group indexed, so a restore can re-shard) and one
``.meta.pkl`` with its host metadata (builtins and numpy values only),
plus a JSON manifest with the source positions, job metadata and the
CRC32 of every payload file. Writes go to a temporary directory renamed
into place; reads verify the CRCs first. Barrier alignment is structural:
a snapshot is taken between micro-batches.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.chaos import injection as chaos


class CheckpointCorruptedError(RuntimeError):
    """A snapshot failed integrity verification (torn write, bit rot,
    truncation). Callers fall back to an older complete checkpoint —
    silently restoring corrupt state is the one unforgivable failure
    mode (reference: Flink checkpoints fail loudly on corrupt streams;
    RocksDB verifies block checksums on read)."""


#: Snapshot format version (reference: TypeSerializerSnapshot versioning +
#: savepoint format versions). Bump when the on-disk layout changes and
#: register a migration; restore fails precisely on unknown versions.
#: v1 = round-1 layout (uncompressed, no version field); v2 = same logical
#: layout, compressed .npz allowed, version field present.
FORMAT_VERSION = 2

#: from_version -> fn(states: {uid: state}) -> states, migrating one step
#: forward. Chained until FORMAT_VERSION is reached.
_MIGRATIONS: Dict[int, Any] = {
    1: lambda states: states,  # v1 -> v2: layout unchanged, read-compatible
}


def register_migration(from_version: int, fn) -> None:
    """Install a one-step snapshot migration (from_version -> +1)."""
    _MIGRATIONS[from_version] = fn


@dataclasses.dataclass
class CheckpointMetadata:
    checkpoint_id: int
    timestamp_ms: int
    job_name: str
    operator_states: List[str]  # uids with .npz payloads
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    format_version: int = FORMAT_VERSION
    #: filename -> CRC32 of every payload file, computed before the
    #: atomic rename; verified on read so a torn/corrupted snapshot is
    #: DETECTED instead of silently restored. Empty for pre-CRC
    #: snapshots (read-compatible: verification simply skips).
    file_crcs: Dict[str, int] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# Directory-level snapshot IO (shared by periodic checkpoints, savepoints and
# the state processor API). A snapshot directory is self-contained:
# manifest.json + one .npz / .meta.pkl pair per stateful operator.
# --------------------------------------------------------------------------


def _split_state(state: Dict[str, Any]):
    """Separate flat numpy arrays (npz-able) from pickled host metadata."""
    arrays: Dict[str, np.ndarray] = {}

    def walk(prefix: str, obj: Any):
        if isinstance(obj, np.ndarray) and obj.dtype != object:
            arrays[prefix] = obj
        elif isinstance(obj, dict) and all(isinstance(k, str) for k in obj):
            sub_meta = {}
            for k, v in obj.items():
                r = walk(f"{prefix}.{k}" if prefix else k, v)
                if r is not None:
                    sub_meta[k] = r
            if sub_meta:
                return sub_meta
            return None
        else:
            return obj
        return None

    m = walk("", state)
    meta = m if isinstance(m, dict) else {}
    return arrays, {"meta": meta}


def _set_path(d: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def write_snapshot_dir(final_dir: str, checkpoint_id: int, job_name: str,
                       operator_states: Dict[str, Dict[str, Any]],
                       extra: Optional[Dict[str, Any]] = None,
                       compress: bool = True) -> str:
    """Write a self-contained snapshot directory (tmp + atomic rename).

    An existing target is replaced only if it is itself a snapshot directory
    (manifest.json present) or empty — never an arbitrary user directory.
    """
    if os.path.exists(final_dir) and os.listdir(final_dir) and \
            not os.path.exists(os.path.join(final_dir, "manifest.json")):
        raise FileExistsError(
            f"refusing to replace non-snapshot directory {final_dir!r}")
    # chaos: a raise here models a write that failed before anything
    # became visible; the tmp-dir discipline below guarantees no
    # half-written chk dir appears (recoverable faults retry in place)
    chaos.io_point("checkpoint.write", checkpoint_id=checkpoint_id)
    parent = os.path.dirname(os.path.abspath(final_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(
        prefix=f".snap-{checkpoint_id}-", dir=parent)
    try:
        uids = []
        for uid, state in operator_states.items():
            uids.append(uid)
            arrays, meta = _split_state(state)
            if arrays:
                # compressed by default (reference compresses state with
                # lz4/snappy, root pom.xml:168,225); np.load autodetects
                save = np.savez_compressed if compress else np.savez
                save(os.path.join(tmp_dir, f"op-{uid}.npz"), **arrays)
            with open(os.path.join(tmp_dir, f"op-{uid}.meta.pkl"), "wb") as f:
                pickle.dump(meta, f)
        file_crcs = {
            name: _file_crc32(os.path.join(tmp_dir, name))
            for name in sorted(os.listdir(tmp_dir))
        }
        manifest = CheckpointMetadata(
            checkpoint_id=checkpoint_id,
            timestamp_ms=int(time.time() * 1000),
            job_name=job_name,
            operator_states=uids,
            extra=extra or {},
            file_crcs=file_crcs)
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(dataclasses.asdict(manifest), f)
        if os.path.exists(final_dir):
            shutil.rmtree(final_dir)
        os.rename(tmp_dir, final_dir)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    # chaos: a TORN write — the rename was durable but a payload file's
    # contents were not (lost page-cache flush on power loss; the
    # failure mode fsync-less storage actually exhibits). kind="drop"
    # truncates a file, kind="corrupt" flips one byte; either way the
    # manifest CRCs make the snapshot detectably — not silently — bad.
    # Tear kinds ONLY: raising after the rename would model a failure
    # of a checkpoint that is in fact durable (the caller would discard
    # its committed epoch while restore skips the replay — a harness
    # false positive, not a real failure mode). Pre-visibility crashes
    # belong to the checkpoint.write point above.
    rule = chaos.payload_action("checkpoint.write.torn",
                                kinds=("drop", "corrupt"),
                                checkpoint_id=checkpoint_id)
    if rule is not None:
        _tear_snapshot_file(final_dir, truncate=(rule.kind == "drop"))
    return final_dir


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                return crc
            crc = zlib.crc32(data, crc)


def _tear_snapshot_file(snapshot_dir: str, truncate: bool) -> None:
    """Damage the first payload file (chaos-only helper): truncate to
    half, or flip one byte in the middle."""
    victims = sorted(n for n in os.listdir(snapshot_dir)
                     if n != "manifest.json")
    if not victims:
        return
    path = os.path.join(snapshot_dir, victims[0])
    size = os.path.getsize(path)
    if truncate:
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    else:
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


def verify_snapshot_files(snapshot_dir: str,
                          file_crcs: Dict[str, int]) -> None:
    """Check every manifest-recorded file exists and matches its CRC32;
    raises :class:`CheckpointCorruptedError` naming the first bad file.
    Pre-CRC snapshots (empty dict) verify vacuously."""
    for name, want in file_crcs.items():
        path = os.path.join(snapshot_dir, name)
        if not os.path.exists(path):
            raise CheckpointCorruptedError(
                f"snapshot {snapshot_dir!r} is incomplete: {name!r} is "
                "missing (torn write?) — restore from an older complete "
                "checkpoint")
        got = _file_crc32(path)
        if got != int(want):
            raise CheckpointCorruptedError(
                f"snapshot {snapshot_dir!r} is corrupt: {name!r} CRC32 "
                f"{got:#010x} != manifest {int(want):#010x} (torn write "
                "or bit rot) — restore from an older complete checkpoint")


def read_manifest(snapshot_dir: str) -> Dict[str, Any]:
    with open(os.path.join(snapshot_dir, "manifest.json")) as f:
        return json.load(f)


def read_snapshot_dir(snapshot_dir: str,
                      verify: bool = True) -> Dict[str, Dict[str, Any]]:
    """Read a snapshot directory back into operator-uid -> state dicts.

    Integrity first: with ``verify`` (the default) every payload file is
    CRC-checked against the manifest before any state is materialized —
    a torn or corrupted snapshot raises :class:`CheckpointCorruptedError`
    instead of restoring garbage. Prior-version snapshots are migrated
    forward step by step; a snapshot from a NEWER format fails with a
    precise error (reference: TypeSerializerSnapshot compatibility
    resolution)."""
    # chaos: transient read failures retry with backoff in place
    # (storage I/O is a recoverable site); persistent ones crash
    chaos.io_point("checkpoint.read", path=snapshot_dir)
    manifest = read_manifest(snapshot_dir)
    if verify:
        verify_snapshot_files(snapshot_dir,
                              manifest.get("file_crcs") or {})
    version = int(manifest.get("format_version", 1))
    if version > FORMAT_VERSION:
        raise RuntimeError(
            f"snapshot {snapshot_dir!r} has format version {version}, but "
            f"this build reads at most {FORMAT_VERSION} — it was written "
            "by a newer framework version")
    out: Dict[str, Dict[str, Any]] = {}
    for uid in manifest["operator_states"]:
        state: Dict[str, Any] = {}
        npz_path = os.path.join(snapshot_dir, f"op-{uid}.npz")
        if os.path.exists(npz_path):
            with np.load(npz_path, allow_pickle=False) as z:
                for k in z.files:
                    _set_path(state, k, z[k])
        with open(os.path.join(snapshot_dir, f"op-{uid}.meta.pkl"), "rb") as f:
            meta = pickle.load(f)["meta"]
        _merge(state, meta)
        out[uid] = state
    while version < FORMAT_VERSION:
        migrate = _MIGRATIONS.get(version)
        if migrate is None:
            raise RuntimeError(
                f"snapshot {snapshot_dir!r} has format version {version} "
                f"and no migration to {version + 1} is registered")
        out = migrate(out)
        version += 1
    return out


# --------------------------------------------------------------------------
# Incremental checkpoints: a delta snapshot stores only rows dirtied since
# its base checkpoint plus freed-namespace tombstones (reference:
# RocksIncrementalSnapshotStrategy uploads only new SST files; the chain is
# re-materialized at restore). A checkpoint's manifest extra carries
# {"incremental": true, "base": <id>}.
# --------------------------------------------------------------------------


def is_delta_table(d: Any) -> bool:
    return isinstance(d, dict) and bool(np.asarray(d.get("__delta__", False)))


def _pack_rows(key_ids, namespaces) -> np.ndarray:
    out = np.empty(len(key_ids), dtype=[("k", "<i8"), ("n", "<i8")])
    out["k"] = np.asarray(key_ids, dtype=np.int64)
    out["n"] = np.asarray(namespaces, dtype=np.int64)
    return out


def apply_table_delta(base: Optional[Dict[str, Any]],
                      delta: Dict[str, Any]) -> Dict[str, Any]:
    """Materialize base rows + delta upserts - tombstones (whole freed
    namespaces and TTL-expired (key, ns) pairs)."""
    meta = ("__delta__", "freed_namespaces",
            "tombstone_key_id", "tombstone_namespace")
    cols = [k for k in delta if k not in meta]
    delta_rows = {c: np.asarray(delta[c]) for c in cols}
    if base is None or len(np.asarray(base.get("key_id", ()))) == 0:
        return delta_rows
    freed = np.asarray(delta.get("freed_namespaces", ()), dtype=np.int64)
    keep = np.ones(len(base["key_id"]), dtype=bool)
    if len(freed):
        keep &= ~np.isin(np.asarray(base["namespace"], dtype=np.int64),
                         freed)
    tomb_k = np.asarray(delta.get("tombstone_key_id", ()), dtype=np.int64)
    packed_base = None  # built once; base can be millions of rows
    if len(tomb_k) or len(delta_rows["key_id"]):
        packed_base = _pack_rows(base["key_id"], base["namespace"])
    if len(tomb_k):
        tomb_n = np.asarray(delta["tombstone_namespace"], dtype=np.int64)
        keep &= ~np.isin(packed_base, _pack_rows(tomb_k, tomb_n))
    if len(delta_rows["key_id"]):
        keep &= ~np.isin(
            packed_base,
            _pack_rows(delta_rows["key_id"], delta_rows["namespace"]))
    return {
        c: np.concatenate([np.asarray(base[c])[keep], delta_rows[c]])
        for c in cols
    }


def merge_incremental_state(base: Dict[str, Any],
                            delta: Dict[str, Any]) -> Dict[str, Any]:
    """Merge one operator's delta state onto its base state: delta tables
    apply row-wise, structural dicts (string keys) recurse, leaves replace;
    base keys absent from the delta are kept.

    A dict keyed by data (non-string keys: the session intervals per key,
    the slice -> last-window map, the key values) is host metadata that a
    delta checkpoint writes whole, so it REPLACES the base's. The
    reference recurses into it too, which keeps the base's entries for
    keys the delta no longer holds: a session fired between the base and
    the delta comes back after a restore and fires again (ROADMAP.md
    Queue C item R2). A data dict of the base that the delta lacks was
    empty when the delta was written (the codec prunes empty dicts), so
    it becomes empty."""
    out = dict(base)
    for k, v in delta.items():
        if is_delta_table(v):
            prior = base.get(k) if isinstance(base.get(k), dict) else None
            out[k] = apply_table_delta(prior, v)
        elif (isinstance(v, dict) and isinstance(base.get(k), dict)
              and not _is_data_dict(v)):
            out[k] = merge_incremental_state(base[k], v)
        else:
            out[k] = v
    for k, v in base.items():
        if k not in delta and _is_data_dict(v):
            # the delta's map was empty: the codec prunes empty dicts
            out[k] = {}
    return out


def _is_data_dict(v: Any) -> bool:
    return isinstance(v, dict) and not all(isinstance(k, str) for k in v)


def read_checkpoint_chain(snapshot_dir: str) -> Dict[str, Dict[str, Any]]:
    """Read a checkpoint, materializing its incremental chain if any.

    Delta checkpoints reference their base by id; bases live as sibling
    chk-<id> directories.
    """
    manifest = read_manifest(snapshot_dir)
    states = read_snapshot_dir(snapshot_dir)
    extra = manifest.get("extra", {})
    if not extra.get("incremental"):
        # a full-manifest checkpoint should not carry delta tables; if one
        # does (writer bug / tampering), materializing it as-if-complete
        # would silently drop state — fail loudly instead
        def assert_no_delta(state, path):
            for k, v in state.items():
                if is_delta_table(v):
                    raise RuntimeError(
                        f"full checkpoint {snapshot_dir!r} contains a "
                        f"delta-marked table at {path + (k,)!r}")
                if isinstance(v, dict):
                    assert_no_delta(v, path + (k,))

        for uid, st in states.items():
            assert_no_delta(st, (uid,))
        return states
    base_dir = os.path.join(os.path.dirname(os.path.abspath(snapshot_dir)),
                            f"chk-{extra['base']}")
    if not os.path.isdir(base_dir):
        raise RuntimeError(
            f"incremental checkpoint {snapshot_dir!r} references missing "
            f"base chk-{extra['base']} — was it deleted outside retain()?")
    base_states = read_checkpoint_chain(base_dir)
    out: Dict[str, Dict[str, Any]] = dict(base_states)
    for uid, st in states.items():
        out[uid] = merge_incremental_state(base_states.get(uid, {}), st)
    return out


def checkpoint_chain_ids(root: str, checkpoint_id: int) -> List[int]:
    """All checkpoint ids the given checkpoint transitively depends on
    (including itself)."""
    ids = [checkpoint_id]
    cur = checkpoint_id
    while True:
        d = os.path.join(root, f"chk-{cur}")
        if not os.path.isdir(d):
            break
        extra = read_manifest(d).get("extra", {})
        if not extra.get("incremental"):
            break
        cur = int(extra["base"])
        ids.append(cur)
    return ids


def retain_verified_anchors(ids, keep: int, verify_ok, chain_ids,
                            verified_cache: set, delete) -> None:
    """The ONE torn-aware retention core shared by the flat and sharded
    checkpoint stores: scan newest-first, anchor the ``keep`` newest
    checkpoints whose ``verify_ok`` passes (memoized in
    ``verified_cache`` — checkpoints are immutable after the atomic
    rename), keep everything at/above the oldest anchor plus every id
    an anchor's incremental chain needs, delete the rest unread. If
    nothing verifies, delete nothing (GC must never strand the job).

    ``verify_ok(cid)`` must verify the WHOLE restorable artifact —
    including incremental base chains: an anchor whose base is corrupt
    is not restorable, and anchoring it would let GC delete the older
    complete snapshots the fallback needs."""
    anchors = []
    needed = set()
    for i in reversed(ids):
        if len(anchors) >= keep:
            break
        if i not in verified_cache:
            if not verify_ok(i):
                continue  # torn/corrupt: not an anchor; kept only if
                # newer than the oldest anchor (harmless forensics)
            verified_cache.add(i)
        anchors.append(i)
        needed.update(chain_ids(i))
    if not anchors:
        return
    floor = min(anchors)
    for i in ids:
        if i >= floor or i in needed:
            continue
        delete(i)


def resolve_snapshot_dir(path: str) -> str:
    """Accept either a self-contained snapshot dir (savepoint / single
    checkpoint) or a checkpoint root holding chk-N children (newest wins)."""
    if os.path.exists(os.path.join(path, "manifest.json")):
        return path
    ids = [int(n[4:]) for n in os.listdir(path)
           if n.startswith("chk-") and n[4:].isdigit()] if os.path.isdir(
               path) else []
    if ids:
        return os.path.join(path, f"chk-{max(ids)}")
    raise RuntimeError(
        f"no checkpoint or savepoint found at {path!r} (expected "
        "manifest.json or chk-N subdirectories)")


class CheckpointStorage:
    """Directory-per-checkpoint layout:

    <root>/chk-<id>/manifest.json
    <root>/chk-<id>/op-<uid>.npz           (numpy arrays of the slot table)
    <root>/chk-<id>/op-<uid>.meta.pkl      (host-side metadata: pending
                                            windows, key-value maps, rng...)
    Writes go to a temp dir then atomically rename — a half-written
    checkpoint is never visible (the reference gets this from
    FsCheckpointStorage's exclusive scope + atomic rename semantics).
    """

    def __init__(self, root: str, compress: bool = True):
        self.root = root
        self.compress = compress
        #: checkpoint ids that passed a FULL CRC verification in this
        #: process — snapshots are immutable after the atomic rename,
        #: so retention never pays the verify I/O for the same id twice
        self._verified_ids: set = set()
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ write

    def write_checkpoint(self, checkpoint_id: int, job_name: str,
                         operator_states: Dict[str, Dict[str, Any]],
                         extra: Optional[Dict[str, Any]] = None) -> str:
        return write_snapshot_dir(self._dir(checkpoint_id), checkpoint_id,
                                  job_name, operator_states, extra,
                                  compress=self.compress)

    # ------------------------------------------------------------------- read

    def read_checkpoint(self, checkpoint_id: int,
                        verify: bool = True) -> Dict[str, Dict[str, Any]]:
        """``verify=False`` skips the CRC pass — for callers that just
        verified this id via ``latest_checkpoint_id(verify=True)`` and
        would otherwise read every payload file twice."""
        return read_snapshot_dir(self._dir(checkpoint_id), verify=verify)

    def latest_checkpoint_id(self,
                             verify: bool = False) -> Optional[int]:
        """Newest COMPLETE checkpoint id, or None.

        A chk dir without a manifest.json (crash mid-write outside the
        atomic-rename discipline, or external tampering) is never
        complete and is always skipped. With ``verify``, every payload
        file is additionally CRC-checked against the manifest, so torn
        and bit-flipped snapshots are skipped too and the newest id
        that PASSES wins — the fallback the crash-restore harness
        relies on."""
        ids = []
        for name in os.listdir(self.root):
            if name.startswith("chk-"):
                try:
                    ids.append(int(name[4:]))
                except ValueError:
                    pass
        for i in sorted(ids, reverse=True):
            d = self._dir(i)
            if not os.path.exists(os.path.join(d, "manifest.json")):
                continue
            if verify:
                try:
                    verify_snapshot_files(
                        d, read_manifest(d).get("file_crcs") or {})
                except (CheckpointCorruptedError, OSError,
                        ValueError):
                    continue
            return i
        return None

    def retain(self, keep: int) -> None:
        """Drop all but the newest ``keep`` COMPLETE checkpoints —
        never a checkpoint that a retained incremental checkpoint still
        references as (part of) its base chain (reference: shared-state
        registry refcounting in SharedStateRegistry), and never the
        fallback chain below a torn/corrupt newest: retention anchors
        on the ``keep`` newest checkpoints that PASS verification
        (including every link of an incremental chain — a delta whose
        base is corrupt is not restorable), so a torn chk-N can never
        strand the job with zero restorable checkpoints. Shared core:
        :func:`retain_verified_anchors`."""
        if keep <= 0:
            return
        all_ids = sorted(
            int(n[4:]) for n in os.listdir(self.root)
            if n.startswith("chk-") and n[4:].isdigit())

        def verify_ok(i: int) -> bool:
            try:
                # the whole restorable artifact: the checkpoint AND its
                # incremental base chain
                for cid in checkpoint_chain_ids(self.root, i):
                    d = self._dir(cid)
                    verify_snapshot_files(
                        d, read_manifest(d).get("file_crcs") or {})
                return True
            except (CheckpointCorruptedError, OSError, ValueError):
                return False

        retain_verified_anchors(
            all_ids, keep, verify_ok,
            lambda i: checkpoint_chain_ids(self.root, i),
            self._verified_ids,
            lambda i: shutil.rmtree(self._dir(i), ignore_errors=True))

    # ---------------------------------------------------------------- helpers

    def _dir(self, checkpoint_id: int) -> str:
        return os.path.join(self.root, f"chk-{checkpoint_id}")

