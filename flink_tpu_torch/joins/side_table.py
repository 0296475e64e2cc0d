"""One side of a two-input join: a keyed row table over the logical mesh
(port of ``flink_tpu/joins/side_table.py``; host code with the same
behaviour).

Join state is append-only rows (a buffered left/right record, or one
version of a temporal right side), not merge-on-write accumulators: the
value columns live in ``[P, capacity]`` device tensors (one row per
shard), while the row *metadata* (key, event/version time, row id, device
slot) stays on the host, sorted by ``(key, ts, rid)`` per shard. That
order IS the index both join programs probe: an interval band or a
temporal version lookup is a pair of lexicographic binary searches over
it, and the banded-probe program gathers candidate slots through a device
mirror of the same order.

Both sides of one join share the key routing, so a key's left and right
rows always land on the same shard and every probe is shard-local.

Cold rows: when the per-shard device budget fills, the OLDEST rows (by
event time) evict as a page cohort through ``state/paged_spill.py``. They
are never reloaded: probes serve them straight from page storage, and
watermark pruning drops them from the membership map.

``backend="host"`` keeps the value columns in host numpy arrays and is the
bit-identical oracle: every metadata decision is shared code and the
value path is pure movement, so both backends agree bit for bit,
emission order included.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.state.keygroups import assign_key_groups
from flink_tpu_torch.state.paged_spill import (
    PagedSpillMap,
    drop_spilled_sessions,
    read_spilled_rows,
    spill_page,
)
from flink_tpu_torch.state.slot_table import SlotTableFullError, SpillTier

#: dtypes that ride the device plane. The reference's x32 device backend
#: carries exactly these bit-exactly; the port keeps the same split (torch
#: could hold int64 on the card) because which columns ride the plane and
#: which the host shadow decides where a cold candidate is served from.
#: Anything else (int64 ids, float64, objects) rides the host shadow store
#: in BOTH backends.
DEVICE_ELIGIBLE = ("float32", "int32", "bool")


def pair_lower_bound(sk: np.ndarray, st: np.ndarray,
                     qk: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Vectorized lexicographic lower bound: for each query ``(qk[i],
    qt[i])``, the first position ``p`` with ``(sk[p], st[p]) >= (qk[i],
    qt[i])`` over the lexicographically sorted pair ``(sk, st)`` (a
    branchless binary search, on the host because keys are int64)."""
    n = len(sk)
    m = len(qk)
    lo = np.zeros(m, dtype=np.int64)
    if n == 0 or m == 0:
        return lo
    hi = np.full(m, n, dtype=np.int64)
    for _ in range(int(n).bit_length()):
        mid = (lo + hi) >> 1
        mid_c = np.minimum(mid, n - 1)  # settled lanes have mid == n
        mk = sk[mid_c]
        mt = st[mid_c]
        less = ((mk < qk) | ((mk == qk) & (mt < qt))) & (lo < hi)
        lo = np.where(less, mid + 1, lo)
        hi = np.where(less, hi, mid)
    return lo


class _ShardMeta:
    """One shard's row metadata, sorted by ``(key, ts, rid)``."""

    __slots__ = ("key", "ts", "rid", "slot", "dirty")

    def __init__(self) -> None:
        self.key = np.empty(0, dtype=np.int64)
        self.ts = np.empty(0, dtype=np.int64)
        self.rid = np.empty(0, dtype=np.int64)
        #: device slot; -1 = spilled (page membership in the pmap)
        self.slot = np.empty(0, dtype=np.int32)
        self.dirty = np.empty(0, dtype=bool)

    def __len__(self) -> int:
        return len(self.key)

    def merge_rows(self, key, ts, rid, slot, dirty) -> None:
        """Insert rows whose row ids all exceed the stored ones (ingest
        allocates rids in order; a restore fills an empty shard): a new
        row goes after every stored row of its ``(key, ts)``, so sorting
        the batch and inserting it keeps the ``(key, ts, rid)`` order a
        full lexsort would give."""
        if not len(key):
            return
        if len(self.key) and int(rid.min()) <= int(self.rid.max()):
            raise ValueError("merge_rows: row ids must exceed the stored "
                             "ones")
        o = np.lexsort((rid, ts, key))
        k, t = key[o], ts[o]
        pos = pair_lower_bound(self.key, self.ts, k, t + 1)
        self.key = np.insert(self.key, pos, k)
        self.ts = np.insert(self.ts, pos, t)
        self.rid = np.insert(self.rid, pos, rid[o])
        self.slot = np.insert(self.slot, pos, slot[o])
        self.dirty = np.insert(self.dirty, pos, dirty[o])

    def compress(self, keep: np.ndarray) -> None:
        self.key = self.key[keep]
        self.ts = self.ts[keep]
        self.rid = self.rid[keep]
        self.slot = self.slot[keep]
        self.dirty = self.dirty[keep]


class JoinSideTable:
    """Per-side keyed row table: device (or host-oracle) value plane +
    sorted host metadata + paged spill tier, one of each per shard. The
    engine owns the device planes; this class owns everything on the
    host."""

    def __init__(self, num_shards: int, capacity: int,
                 schema: Sequence[Tuple[str, np.dtype]],
                 max_device_slots: int = 0,
                 spill_dir: Optional[str] = None,
                 spill_host_max_bytes: int = 0,
                 backend: str = "device") -> None:
        if backend not in ("device", "host"):
            raise ValueError(
                f"backend must be 'device' or 'host', got {backend!r}")
        self.P = int(num_shards)
        self.backend = backend
        self.max_device_slots = int(max_device_slots or 0)
        self.capacity = max(int(capacity), 256)
        if self.max_device_slots:
            self.max_device_slots = max(self.max_device_slots, 256)
            self.capacity = min(self.capacity, self.max_device_slots)
        #: (name, numpy dtype) per value column, sorted by name: the one
        #: column order shared by planes, page entries and snapshots
        self.schema: List[Tuple[str, np.dtype]] = [
            (str(n), np.dtype(dt)) for n, dt in schema]
        self.device_cols: List[int] = [
            i for i, (_, dt) in enumerate(self.schema)
            if dt.name in DEVICE_ELIGIBLE]
        self.host_cols: List[int] = [
            i for i in range(len(self.schema))
            if i not in self.device_cols]
        self.meta: List[_ShardMeta] = [_ShardMeta()
                                       for _ in range(self.P)]
        #: per-shard free slots, slot 0 reserved as scratch (padding lanes
        #: of every staged block write there)
        self._free: List[np.ndarray] = [
            np.arange(self.capacity - 1, 0, -1, dtype=np.int32)
            for _ in range(self.P)]
        #: host shadow store for device-ineligible columns (and the whole
        #: store in host mode): one [P, capacity] array per column
        self.shadow: Dict[int, np.ndarray] = {}
        shadow_idx = (range(len(self.schema))
                      if backend == "host" else self.host_cols)
        for i in shadow_idx:
            self.shadow[i] = np.zeros((self.P, self.capacity),
                                      dtype=self.schema[i][1])
        # host page-memory budget per SHARD (the engine already split the
        # operator budget across sides)
        self.spills: List[SpillTier] = [
            SpillTier(f"{spill_dir.rstrip('/')}/shard-{p}"
                      if spill_dir else None,
                      spill_host_max_bytes // self.P
                      if spill_host_max_bytes else 0)
            for p in range(self.P)]
        self.pmaps: List[PagedSpillMap] = [PagedSpillMap()
                                           for _ in range(self.P)]
        #: probe rows answered from page storage
        self.cold_rows_served = 0

    # ------------------------------------------------------------ accounting

    @property
    def spill_active(self) -> bool:
        return self.max_device_slots > 0

    def num_rows(self) -> int:
        return sum(len(m) for m in self.meta) + sum(
            len(pm) for pm in self.pmaps)

    def spill_counters(self) -> Dict[str, int]:
        out = PagedSpillMap.zero_counters()
        for pm in self.pmaps:
            for k, v in pm.counters().items():
                out[k] += v
        out["cold_rows_served"] = int(self.cold_rows_served)
        return out

    # ------------------------------------------------------------ allocation

    def free_headroom(self, p: int) -> int:
        return len(self._free[p])

    def allocate(self, p: int, n: int) -> np.ndarray:
        """``n`` fresh slots on shard ``p`` (the engine made headroom)."""
        free = self._free[p]
        if len(free) < n:
            raise SlotTableFullError(
                f"join side table shard {p}: {n} slots needed, "
                f"{len(free)} free — eviction failed to make headroom")
        slots, self._free[p] = free[-n:][::-1].copy(), free[:-n]
        return slots

    def release(self, p: int, slots: np.ndarray) -> None:
        if len(slots):
            self._free[p] = np.concatenate(
                [self._free[p], np.asarray(slots, dtype=np.int32)])

    def grow(self, new_capacity: int) -> None:
        """Widen the shadow store (the engine widens the device planes,
        uniformly across shards)."""
        old = self.capacity
        if new_capacity <= old:
            return
        self.capacity = new_capacity
        for i, arr in list(self.shadow.items()):
            wide = np.zeros((self.P, new_capacity), dtype=arr.dtype)
            wide[:, :old] = arr
            self.shadow[i] = wide
        for p in range(self.P):
            self._free[p] = np.concatenate([
                self._free[p],
                np.arange(new_capacity - 1, old - 1, -1,
                          dtype=np.int32)])

    # ------------------------------------------------------------- eviction

    def choose_eviction(self, p: int, needed: int) -> np.ndarray:
        """Metadata positions of the eviction cohort on shard ``p``: the
        OLDEST resident rows (stable by metadata order), enough to free
        ``needed`` slots plus workable headroom. Pure metadata: both
        backends choose identically."""
        m = self.meta[p]
        res = np.nonzero(m.slot >= 0)[0]
        if not len(res):
            raise SlotTableFullError(
                f"join side table shard {p}: device budget exhausted "
                "with no resident rows to evict — raise the budget or "
                "reduce batch size")
        target = min(len(res),
                     max(needed, self.capacity // 8, 256))
        order = np.argsort(m.ts[res], kind="stable")
        return res[order[:target]]

    def evict_rows(self, p: int, pos: np.ndarray,
                   values: List[np.ndarray]) -> np.ndarray:
        """Move the cohort at metadata positions ``pos`` (values already
        gathered by the engine, schema order) into one page; returns the
        freed slots."""
        m = self.meta[p]
        slots = m.slot[pos].copy()
        entry = {
            "key_id": m.key[pos].copy(),
            "ns": m.rid[pos].copy(),
            "dirty": m.dirty[pos].copy(),
            **{f"leaf_{i}": np.asarray(values[i])
               for i in range(len(self.schema))},
        }
        spill_page(self.spills[p], self.pmaps[p], entry)
        m.slot[pos] = -1
        self.release(p, slots)
        return slots

    def shadow_values(self, p: int, pos: np.ndarray
                      ) -> List[np.ndarray]:
        """Host-readable value columns at metadata positions (host
        backend: every column; device backend: only shadow columns, the
        engine fills the device columns from its gather)."""
        m = self.meta[p]
        slots = np.clip(m.slot[pos], 0, None)
        out: List[np.ndarray] = []
        for i, (_, dt) in enumerate(self.schema):
            if i in self.shadow:
                out.append(self.shadow[i][p][slots].copy())
            else:
                out.append(np.zeros(len(pos), dtype=dt))
        return out

    # ------------------------------------------------------------- pruning

    def prune(self, min_ts: int) -> int:
        """Drop rows with ``ts < min_ts`` (watermark expiry): resident
        slots free, cold rows unmap from their pages. Returns rows
        dropped."""
        dropped = 0
        for p in range(self.P):
            m = self.meta[p]
            if not len(m):
                continue
            dead = m.ts < min_ts
            if not dead.any():
                continue
            dropped += int(dead.sum())
            res = dead & (m.slot >= 0)
            if res.any():
                self.release(p, m.slot[res])
            cold = dead & (m.slot < 0)
            if cold.any():
                drop_spilled_sessions(self.spills[p], self.pmaps[p],
                                      m.rid[cold])
            m.compress(~dead)
        return dropped

    def drop_positions(self, p: int, pos: np.ndarray) -> None:
        """Drop specific metadata positions (temporal compaction)."""
        if not len(pos):
            return
        m = self.meta[p]
        dead = np.zeros(len(m), dtype=bool)
        dead[pos] = True
        res = dead & (m.slot >= 0)
        if res.any():
            self.release(p, m.slot[res])
        cold = dead & (m.slot < 0)
        if cold.any():
            drop_spilled_sessions(self.spills[p], self.pmaps[p],
                                  m.rid[cold])
        m.compress(~dead)

    # ------------------------------------------------------------ cold reads

    def fill_cold(self, p: int, wants: List[Tuple[int, int, int]],
                  sinks: List[np.ndarray],
                  rows: np.ndarray) -> None:
        """Serve spilled rows into output columns: ``wants`` is
        ``(out_row, key_id, rid)``; ``sinks[i][rows[out_row]]`` receives
        column ``i``. One page read per touched page."""
        if not wants:
            return

        def on_row(tag, entry, src):
            for i in range(len(self.schema)):
                sinks[i][rows[tag]] = entry[f"leaf_{i}"][src]
            self.cold_rows_served += 1

        read_spilled_rows(self.spills[p], self.pmaps[p], True,
                          wants, on_row)

    # ------------------------------------------------------------- snapshot

    def snapshot_rows(self, max_parallelism: int,
                      device_values) -> Dict[str, np.ndarray]:
        """Logical rows (resident + spilled), ordered by rid so snapshot ->
        restore -> snapshot round-trips bit-exactly whatever the
        residency split. ``device_values``: per shard ``{col_index:
        [capacity] host array}`` for the device columns (the engine made
        ONE device->host copy); host mode passes nothing."""
        keys, tss, rids, dirties = [], [], [], []
        leaf_chunks: List[List[np.ndarray]] = [
            [] for _ in self.schema]
        for p in range(self.P):
            m = self.meta[p]
            res = np.nonzero(m.slot >= 0)[0]
            if len(res):
                keys.append(m.key[res])
                tss.append(m.ts[res])
                rids.append(m.rid[res])
                dirties.append(m.dirty[res])
                slots = m.slot[res]
                for i in range(len(self.schema)):
                    src = (self.shadow[i][p] if i in self.shadow
                           else device_values[p][i])
                    leaf_chunks[i].append(np.asarray(src)[slots])
            pm = self.pmaps[p]
            sp = self.spills[p]
            for page in sorted(pm.page_rows):
                entry = sp.peek(int(page))
                if entry is None:
                    continue
                rns = np.asarray(entry["ns"], dtype=np.int64)
                alive = pm.live_row_mask(int(page), rns)
                if not alive.any():
                    continue
                keys.append(np.asarray(entry["key_id"],
                                       dtype=np.int64)[alive])
                rids.append(rns[alive])
                dirties.append(np.asarray(entry["dirty"],
                                          dtype=bool)[alive])
                # cold rows keep their metadata entry (slot -1): find
                # their ts by rid
                mk, mpos = _rid_positions(m.rid, rns[alive])
                ts_cold = np.zeros(int(alive.sum()), dtype=np.int64)
                ts_cold[mk] = m.ts[mpos]
                tss.append(ts_cold)
                for i in range(len(self.schema)):
                    leaf_chunks[i].append(
                        np.asarray(entry[f"leaf_{i}"])[alive])
        if not keys:
            return {
                "key_id": np.empty(0, dtype=np.int64),
                "namespace": np.empty(0, dtype=np.int64),
                "ts": np.empty(0, dtype=np.int64),
                "dirty": np.empty(0, dtype=bool),
                "key_group": np.empty(0, dtype=np.int32),
                **{f"leaf_{i}": np.empty(0, dtype=dt)
                   for i, (_, dt) in enumerate(self.schema)},
            }
        key_id = np.concatenate(keys)
        rid = np.concatenate(rids)
        order = np.argsort(rid, kind="stable")
        out = {
            "key_id": key_id[order],
            "namespace": rid[order],
            "ts": np.concatenate(tss)[order],
            "dirty": np.concatenate(dirties)[order],
            "key_group": assign_key_groups(
                key_id[order], max_parallelism),
        }
        for i in range(len(self.schema)):
            out[f"leaf_{i}"] = np.concatenate(leaf_chunks[i])[order]
        return out


def _rid_positions(sorted_source: np.ndarray, queries: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Positions of ``queries`` in an UNSORTED rid array (rids are
    unique): returns (found_mask_over_queries, source_positions)."""
    order = np.argsort(sorted_source, kind="stable")
    srt = sorted_source[order]
    if not len(srt):
        return (np.zeros(len(queries), dtype=bool),
                np.empty(0, dtype=np.int64))
    pos = np.minimum(np.searchsorted(srt, queries), len(srt) - 1)
    found = srt[pos] == queries
    return found, order[pos[found]]
