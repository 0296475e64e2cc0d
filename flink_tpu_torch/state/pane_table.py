"""Pane-layout keyed window state: a ring of slices x stable key columns
(port of ``flink_tpu/state/pane_table.py``).

The slot table (``state/slot_table.py``) keeps one slot per (key, slice),
so a fire of a k-slice window ships a host-built ``[keys, k]`` slot matrix
to the device. This layout has no such matrix:

- each aggregate leaf is a dense ``[R, C]`` tensor on the device, plus an
  int8 presence plane (``[R, C]``) that tells a key with data in a slice
  from an identity value;
- a KEY owns one column across all slices (the host index, keyed by key
  alone); a live SLICE owns a ring row (``slice_row``; row 0 is the
  reserved identity row, the target of missing slices);
- a scatter is ``acc[row, col] op= v`` through one int32 flat index, built
  on the host (``_flat_indices``) or by one native sweep
  (``ingest_indices``);
- a FIRE merges the window's rows, finishes them and projects: its only
  host->device payload is the ``[k]`` ring-row ids; freeing an expired
  slice is one row reset;
- with pre-aggregation (``slices_for_window`` given) each pending window
  also keeps a running partial row, combined at absorb, so its fire
  gathers ONE row.

The ring starts at 8 rows and doubles. Keys are never freed inline, so
key churn triggers a compaction: the table rebuilt from its own snapshot.
Snapshots carry the reference's logical rows (``key_id``, ``namespace``,
``key_group``, ``leaf_i``), so a snapshot moves between the two packages
and between the two layouts.

With ``memory=(manager, owner)`` the ring's cells reserve from the job's
managed pool at creation and every growth (``core/memory.py``).

Not in this slice: point queries (``query_windows``, ROADMAP Queue A item
12e).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.ops.segment_ops import (
    pad_i32,
    pad_values,
    sticky_bucket,
    torch_dtype,
)
from flink_tpu_torch.runtime.pending import Fence, PendingFire
from flink_tpu_torch.state.keygroups import assign_key_groups
from flink_tpu_torch.state.slot_table import _not_ported, make_slot_index
from flink_tpu_torch.stateplane.families import _idents, pane_fence
from flink_tpu_torch.stateplane.pane import pane_programs
from flink_tpu_torch.windowing.aggregates import AggregateFunction

_INITIAL_RING = 8


class PaneTable:
    """Ring-of-slices x key-columns window state on ``device`` (``None``:
    ``execution.device``'s default, the card, raising without one)."""

    def __init__(self, agg: AggregateFunction, capacity: int = 1 << 16,
                 max_parallelism: int = 128, fire_projector=None,
                 slices_for_window=None, device=None, memory=None):
        self.agg = agg
        #: (MemoryManager, owner) or None: the dense ring is the layout
        #: most likely to exhaust device memory
        self._memory = memory
        self.max_parallelism = max_parallelism
        self.fire_projector = fire_projector
        self.device = resolve_device(device)
        #: window_end -> slice ends (the assigner's mapping): rebuilds the
        #: window-partial rows from the panes (pre-aggregation only)
        self._slices_for_window = slices_for_window
        self._idents = _idents(agg.leaves)
        self._tds = tuple(torch_dtype(l.dtype) for l in agg.leaves)
        self.index = make_slot_index(capacity, on_grow=self._grow_cols)
        self.capacity = self.index.capacity
        self.R = _INITIAL_RING
        self._reserve_cells(self.R * self.capacity)
        self.accs = self._identity_rows(self.R, self.capacity)
        #: slice_end -> ring row (row 0 reserved identity)
        self.slice_row: Dict[int, int] = {}
        #: window_end -> ring row of the window's RUNNING PARTIAL (derived
        #: state: snapshots skip it, restore and compaction rebuild it)
        self.window_row: Dict[int, int] = {}
        self._free_rows: List[int] = list(range(self.R - 1, 0, -1))
        self._dirty_slices: set = set()
        self._freed_ns: List[int] = []
        self._scatter_bucket = 0
        #: exclusive bound of allocated key columns (keys are never freed,
        #: so allocations stay contiguous from 1)
        self._high_water = 1
        self._compact_probed_hw = 0
        (self._scatter2d, self._scatter2d_valued, self._fire_rows,
         self._reset_row, self._put_row,
         self._fold_rows) = pane_programs(agg, fire_projector)

    # ---------------------------------------------------------------- sizing

    def _identity_rows(self, rows: int, cols: int
                       ) -> Tuple[torch.Tensor, ...]:
        """Identity-filled ``[rows, cols]`` leaves plus a zero presence
        plane."""
        return tuple(
            torch.full((rows, cols), i, dtype=td, device=self.device)
            for i, td in zip(self._idents, self._tds)
        ) + (torch.zeros((rows, cols), dtype=torch.int8, device=self.device),)

    def _cell_bytes(self) -> int:
        return sum(np.dtype(l.dtype).itemsize
                   for l in self.agg.leaves) + 1  # + presence plane

    def _reserve_cells(self, cells: int) -> None:
        if self._memory is not None:
            manager, owner = self._memory
            manager.reserve(owner, cells * self._cell_bytes())

    def release_memory(self) -> None:
        if self._memory is not None:
            manager, owner = self._memory
            manager.release_all(owner)

    def _grow_cols(self, old: int, new: int) -> None:
        self._reserve_cells(self.R * (new - old))
        self.capacity = new
        pad = self._identity_rows(self.R, new - old)
        self.accs = tuple(torch.cat([a, p], dim=1)
                          for a, p in zip(self.accs, pad))

    def _take_row(self) -> int:
        if not self._free_rows:
            old = self.R
            self._reserve_cells(old * self.capacity)  # doubling the ring
            self.R = old * 2
            pad = self._identity_rows(old, self.capacity)
            self.accs = tuple(torch.cat([a, p], dim=0)
                              for a, p in zip(self.accs, pad))
            self._free_rows = list(range(self.R - 1, old - 1, -1))
        return self._free_rows.pop()

    def _alloc_row(self, slice_end: int) -> int:
        row = self._take_row()
        self.slice_row[int(slice_end)] = row
        return row

    def _alloc_window_row(self, window_end: int) -> int:
        row = self._take_row()
        self.window_row[int(window_end)] = row
        return row

    @property
    def used_cols(self) -> int:
        """High-water key-column bound (exclusive); column 0 is reserved."""
        return self._high_water

    @property
    def device_bytes(self) -> int:
        """Bytes of the ring on the device (leaves plus presence)."""
        return sum(a.numel() * a.element_size() for a in self.accs)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        # from pageable memory the copy has staged `host` when it returns
        return torch.from_numpy(np.ascontiguousarray(host)).to(
            self.device, non_blocking=True)

    # ---------------------------------------------------------------- ingest

    #: upsert()/upsert_valued() take WindowAssigner.slice_plan's (uniq,
    #: inverse), sparing a sort of the batch
    accepts_slice_plan = True

    def _flat_indices(self, key_ids: np.ndarray, slice_ends: np.ndarray,
                      slice_plan=None) -> np.ndarray:
        """[n] (ring row, key column) -> flat int32 scatter indices: one
        index array crosses to the device instead of two."""
        cols = self.index.lookup_or_insert(
            key_ids, np.zeros(len(key_ids), dtype=np.int64))
        if len(cols):
            self._high_water = max(self._high_water, int(cols.max()) + 1)
        uniq, inv = slice_plan if slice_plan is not None else \
            np.unique(slice_ends, return_inverse=True)
        for se in uniq.tolist():
            if int(se) not in self.slice_row:
                self._alloc_row(int(se))
            self._dirty_slices.add(int(se))
        uniq_rows = np.fromiter(
            (self.slice_row[int(se)] for se in uniq.tolist()),
            dtype=np.int64, count=len(uniq))
        rows = uniq_rows[inv]
        self._check_flat_range()
        return (rows * self.capacity + cols).astype(np.int32)

    def ingest_indices(self, key_ids: np.ndarray, timestamps: np.ndarray,
                       offset: int, width: int):
        """The fused index build: one native sweep (``sm_pane_ingest``)
        replaces slice assignment, the slice plan, the key lookup and the
        flat fuse. Returns ``(flat, uniq_ends, sinv)`` — the distinct slice
        ends in first-seen order — or None without the native index or
        with too many distinct slice ends (the NumPy path then)."""
        ingest = getattr(self.index, "pane_ingest", None)
        if ingest is None:
            return None
        res = ingest(key_ids, timestamps, offset, width)
        if res is None:
            return None
        cols, sinv, uniq, max_col = res
        self._high_water = max(self._high_water, max_col + 1)
        rowmap = np.empty(len(uniq), dtype=np.int64)
        for j, se in enumerate(uniq.tolist()):
            se = int(se)
            if se not in self.slice_row:
                self._alloc_row(se)
            self._dirty_slices.add(se)
            rowmap[j] = self.slice_row[se]
        self._check_flat_range()
        flat = self.index.flat_fuse(cols, sinv, rowmap, self.capacity)
        return flat, uniq, sinv

    def scatter_flat(self, flat: np.ndarray, values: Tuple[np.ndarray, ...],
                     valued: bool = False) -> None:
        """Scatter with a prebuilt flat index (see ingest_indices)."""
        size = sticky_bucket(len(flat), self._scatter_bucket)
        self._scatter_bucket = size
        idx = self._to_device(pad_i32(flat, size, fill=0))
        if valued:
            vals = tuple(
                self._to_device(pad_values(np.asarray(v, dtype=l.dtype),
                                           size, l.identity))
                for v, l in zip(values, self.agg.leaves))
            self.accs = self._scatter2d_valued(self.accs, idx, vals)
        else:
            vals = tuple(self._to_device(v) for v in
                         self.agg.pad_input_values(values, size))
            self.accs = self._scatter2d(self.accs, idx, vals)

    def upsert(self, key_ids: np.ndarray, slice_ends: np.ndarray,
               values: Tuple[np.ndarray, ...], slice_plan=None) -> None:
        self.scatter_flat(self._flat_indices(key_ids, slice_ends, slice_plan),
                          values)

    def upsert_valued(self, key_ids: np.ndarray, slice_ends: np.ndarray,
                      values: Tuple[np.ndarray, ...],
                      slice_plan=None) -> None:
        """Fold locally pre-aggregated partials (every leaf valued)."""
        self.scatter_flat(self._flat_indices(key_ids, slice_ends, slice_plan),
                          values, valued=True)

    # ------------------------------------- incremental pane pre-aggregation

    def has_window_partial(self, window_end: int) -> bool:
        return int(window_end) in self.window_row

    def _check_flat_range(self) -> None:
        if self.R * self.capacity > np.iinfo(np.int32).max:
            raise RuntimeError(
                f"pane table exceeds int32 flat-index range "
                f"(ring={self.R} x capacity={self.capacity}); lower "
                "state.slot-table.capacity or the window's slice count")

    def window_flat(self, cols: np.ndarray, sinv: np.ndarray,
                    wins_per_slice):
        """Flat indices folding each record into its live windows' PARTIAL
        rows (combine-on-absorb). ``cols``: the records' key columns,
        ``sinv``: the unique-slice inverse, ``wins_per_slice``: one list of
        window ends per unique slice. Only windows that already HAVE a
        partial row get folds (the others are rebuilt from the panes after
        the scatter). Returns ``(flat, rec_idx)`` or None."""
        chunks_f: List[np.ndarray] = []
        chunks_i: List[np.ndarray] = []
        order = np.argsort(sinv, kind="stable")
        counts = np.bincount(sinv, minlength=len(wins_per_slice))
        offs = np.concatenate(([0], np.cumsum(counts)))
        C = self.capacity
        self._check_flat_range()
        for j, wins in enumerate(wins_per_slice):
            if not wins:
                continue
            sel = order[offs[j]:offs[j + 1]]
            if not len(sel):
                continue
            c = cols[sel].astype(np.int64)
            for w in wins:
                row = self.window_row.get(int(w))
                if row is None:
                    continue
                chunks_f.append((row * C + c).astype(np.int32))
                chunks_i.append(sel)
        if not chunks_f:
            return None
        return np.concatenate(chunks_f), np.concatenate(chunks_i)

    def scatter_combined(self, flat: np.ndarray, win,
                         values: Tuple[np.ndarray, ...],
                         valued: bool = False) -> None:
        """One scatter over the pane cells AND the window-partial cells:
        the window half repeats each record's value through ``rec_idx``
        (see window_flat)."""
        if win is None:
            return self.scatter_flat(flat, values, valued)
        flat_w, rec_idx = win
        flat_all = np.concatenate([flat, flat_w])
        vals = tuple(np.concatenate([np.asarray(v), np.asarray(v)[rec_idx]])
                     for v in values)
        self.scatter_flat(flat_all, vals, valued)

    def rebuild_window_partials(self, window_ends) -> int:
        """(Re)build partial rows for pending windows that lack one — the
        fold of the window's pane rows. Runs after restore, after
        compaction, and for windows newly pending in a batch (late
        re-registrations included). Returns the rows built."""
        if self._slices_for_window is None:
            return 0
        built = 0
        # sorted: ring-row allocation order must be deterministic
        for w in sorted(int(x) for x in window_ends):
            if w in self.window_row:
                continue
            rows = [self.slice_row.get(int(se), 0)
                    for se in self._slices_for_window(w)]
            if not any(rows):
                continue  # no pane data: the fire emits nothing
            dst = self._alloc_window_row(w)
            self.accs = self._fold_rows(
                self.accs, dst,
                self._to_device(np.asarray(rows, dtype=np.int32)),
                self.used_cols)
            built += 1
        return built

    def release_window_row(self, window_end: int) -> None:
        """Reset and free a fired window's partial row (queued behind the
        fire on the device's stream, so a deferred harvest never races
        it)."""
        row = self.window_row.pop(int(window_end), None)
        if row is None:
            return
        self.accs = self._reset_row(self.accs, row)
        self._free_rows.append(row)

    def clear_window_rows(self) -> None:
        for w in list(self.window_row):
            self.release_window_row(w)

    def fire_partial(self, window_end: int
                     ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Delta fire: gather ONE partial ring row, then release it."""
        row = self.window_row.get(int(window_end))
        if row is None:
            return np.empty(0, dtype=np.int64), {}
        out = self._harvest_rows(np.asarray([row], dtype=np.int32))
        self.release_window_row(window_end)
        return out

    def fire_partial_async(self, window_end: int):
        """Async delta fire: a PendingFire (or None); the row release is
        dispatched right after the fire."""
        row = self.window_row.get(int(window_end))
        if row is None:
            return None
        pf = self._harvest_rows_async(np.asarray([row], dtype=np.int32))
        self.release_window_row(window_end)
        return pf

    def make_fence(self) -> Fence:
        """Dispatch-depth fence (see SlotTable.make_fence)."""
        return pane_fence(self.agg.leaves[0].dtype.str)(self.accs[0])

    # ------------------------------------------------------------------ fire

    def fire_window(self, slice_ends: List[int]
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(keys, result columns) of one window; missing slices read the
        identity row 0."""
        rows = np.asarray(
            [self.slice_row.get(int(se), 0) for se in slice_ends],
            dtype=np.int32)
        if not rows.any():
            return np.empty(0, dtype=np.int64), {}
        return self._harvest_rows(rows)

    def fire_window_async(self, slice_ends: List[int]):
        """fire_window() as a PendingFire (None for a window with no
        data)."""
        rows = np.asarray(
            [self.slice_row.get(int(se), 0) for se in slice_ends],
            dtype=np.int32)
        if not rows.any():
            return None
        return self._harvest_rows_async(rows)

    def _dispatch_rows(self, rows: np.ndarray):
        """Dispatch the fire of ``rows``: (device outputs, host finisher)
        — the one harvest body of the full-window and the delta fire. The
        key column snapshot survives an index grow."""
        used = self.used_cols
        out = self._fire_rows(self.accs, self._to_device(rows), used)
        keys_snap = self.index.slot_key[:used].copy()
        if self.fire_projector is None:
            cols, valid = out
            names = list(cols)

            def build(host: List[np.ndarray]):
                sel = host[0]
                return keys_snap[sel], {
                    name: col[sel] for name, col in zip(names, host[1:])}

            return [valid] + [cols[n] for n in names], build
        pidx, pcols, pvalid = out
        names = list(pcols)

        def build(host: List[np.ndarray]):
            pidx_h, sel = host[0], host[1]
            return keys_snap[pidx_h[sel]], {
                name: col[sel] for name, col in zip(names, host[2:])}

        return [pidx, pvalid] + [pcols[n] for n in names], build

    def _harvest_rows(self, rows: np.ndarray
                      ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        tensors, build = self._dispatch_rows(rows)
        return build([t.cpu().numpy() for t in tensors])

    def _harvest_rows_async(self, rows: np.ndarray) -> PendingFire:
        return PendingFire(*self._dispatch_rows(rows))

    # ----------------------------------------------------------------- frees

    def free_slices(self, slice_ends: List[int]) -> None:
        for se in slice_ends:
            row = self.slice_row.pop(int(se), None)
            if row is None:
                continue
            self.accs = self._reset_row(self.accs, row)
            self._free_rows.append(row)
            self._dirty_slices.discard(int(se))
            self._freed_ns.append(int(se))
        self._maybe_compact()

    #: the windower's on_watermark frees through this name
    free_namespaces = free_slices

    #: no spill tier in the pane layout (the slot layout has it)
    spill = frozenset()

    _COMPACT_MIN_KEYS = 4096

    def _maybe_compact(self) -> None:
        """Rebuild the table from its own snapshot once most allocated
        columns belong to departed keys. The aliveness probe is a blocking
        device read, so it runs only when the key high-water mark has
        grown 1.5x since the last probe."""
        hw = self._high_water
        if hw < self._COMPACT_MIN_KEYS:
            return
        if hw < self._compact_probed_hw * 3 // 2:
            return
        self._compact_probed_hw = hw
        live = sorted(self.slice_row)
        if live:
            rows = torch.as_tensor([self.slice_row[se] for se in live],
                                   dtype=torch.int64, device=self.device)
            alive = int((self.accs[-1][rows, :hw].amax(dim=0) > 0).sum())
        else:
            alive = 0
        if alive * 2 > hw:
            return
        snap = self.snapshot(reset_dirty=False)
        dirty, freed = self._dirty_slices, self._freed_ns
        wins = sorted(self.window_row)  # derived rows: rebuilt below
        self.index = make_slot_index(self.index.capacity,
                                     on_grow=self._grow_cols)
        self.capacity = self.index.capacity
        self._high_water = 1
        self.slice_row = {}
        self.window_row = {}
        self._free_rows = list(range(self.R - 1, 0, -1))
        self.accs = self._identity_rows(self.R, self.capacity)
        self.restore(snap)
        # every surviving slice moved: all dirty against the last base
        self._dirty_slices = set(dirty) | set(self.slice_row)
        self._freed_ns = freed
        self.rebuild_window_partials(wins)

    # ------------------------------------------------------------ point query

    def query_windows(self, key_id: int, assigner):
        raise _not_ported("PaneTable.query_windows", "12e")

    # -------------------------------------------------------------- snapshot

    def snapshot(self, reset_dirty: bool = True) -> Dict[str, np.ndarray]:
        """Logical rows in the slot table's format (key_id, namespace,
        key_group, leaf_i): pane and slot snapshots restore into each
        other, and into the reference's tables."""
        return self._snapshot_slices(sorted(self.slice_row),
                                     reset_dirty=reset_dirty, delta=False)

    def snapshot_delta(self) -> Dict[str, np.ndarray]:
        """The slices touched since the last snapshot plus the freed
        slices' tombstones: sealed slices never dirty again."""
        return self._snapshot_slices(sorted(self._dirty_slices),
                                     reset_dirty=True, delta=True)

    def _snapshot_slices(self, slices: List[int], reset_dirty: bool,
                         delta: bool) -> Dict[str, np.ndarray]:
        used = self.used_cols
        key_cols, ns_cols = [], []
        leaf_cols: List[List[np.ndarray]] = [[] for _ in self.agg.leaves]
        if slices:
            # one gather and one device->host copy per plane for every slice
            row_ids = torch.as_tensor([self.slice_row[se] for se in slices],
                                      dtype=torch.int64, device=self.device)
            rows_host = [a[row_ids, :used].cpu().numpy() for a in self.accs]
        for j, se in enumerate(slices):
            present = rows_host[-1][j] > 0
            if not present.any():
                continue
            keys = self.index.slot_key[:used][present]
            key_cols.append(keys)
            ns_cols.append(np.full(len(keys), se, dtype=np.int64))
            for i in range(len(self.agg.leaves)):
                leaf_cols[i].append(rows_host[i][j][present])
        if key_cols:
            key_ids = np.concatenate(key_cols)
            out = {
                "key_id": key_ids,
                "namespace": np.concatenate(ns_cols),
                "key_group": assign_key_groups(key_ids,
                                               self.max_parallelism),
                **{f"leaf_{i}": np.concatenate(cols)
                   for i, cols in enumerate(leaf_cols)},
            }
        else:
            out = {
                "key_id": np.empty(0, dtype=np.int64),
                "namespace": np.empty(0, dtype=np.int64),
                "key_group": np.empty(0, dtype=np.int32),
                **{f"leaf_{i}": np.empty(0, dtype=l.dtype)
                   for i, l in enumerate(self.agg.leaves)},
            }
        if delta:
            out["__delta__"] = np.asarray(True)
            out["freed_namespaces"] = np.asarray(
                sorted(set(self._freed_ns)), dtype=np.int64)
        if reset_dirty:
            self._dirty_slices.clear()
            self._freed_ns.clear()
        return out

    def restore(self, snap: Dict[str, np.ndarray],
                key_group_filter=None) -> None:
        key_ids = np.asarray(snap["key_id"], dtype=np.int64)
        namespaces = np.asarray(snap["namespace"], dtype=np.int64)
        leaves = []
        for i, leaf in enumerate(self.agg.leaves):
            arr = np.asarray(snap[f"leaf_{i}"])
            want = np.dtype(leaf.dtype)
            if len(arr) and arr.dtype != want:
                # a value-preserving cast migrates, a lossy one fails
                cast = arr.astype(want)
                if not np.array_equal(cast.astype(arr.dtype), arr):
                    raise RuntimeError(
                        f"state schema incompatible: snapshot leaf_{i} "
                        f"has dtype {arr.dtype}, the aggregate expects "
                        f"{want} and the values do not survive the cast")
                arr = cast
            leaves.append(arr.astype(want))
        if key_group_filter is not None and len(key_ids):
            groups = assign_key_groups(key_ids, self.max_parallelism)
            keep = np.isin(groups, np.asarray(sorted(key_group_filter)))
            key_ids, namespaces = key_ids[keep], namespaces[keep]
            leaves = [l[keep] for l in leaves]
        order = np.argsort(namespaces, kind="stable")
        key_ids, namespaces = key_ids[order], namespaces[order]
        leaves = [l[order] for l in leaves]
        bounds = np.nonzero(np.diff(namespaces))[0] + 1
        starts = np.concatenate(([0], bounds)) if len(key_ids) else []
        ends = np.concatenate((bounds, [len(key_ids)])) if len(key_ids) \
            else []
        for a, b in zip(list(starts), list(ends)):
            se = int(namespaces[a])
            row = self.slice_row.get(se)
            if row is None:
                row = self._alloc_row(se)
            cols = self.index.lookup_or_insert(
                key_ids[a:b], np.zeros(b - a, dtype=np.int64))
            if len(cols):
                self._high_water = max(self._high_water,
                                       int(cols.max()) + 1)
            self.accs = self._put_row(
                self.accs, row, self._to_device(cols.astype(np.int32)),
                tuple(self._to_device(l[a:b]) for l in leaves))
        self._dirty_slices.clear()
        self._freed_ns.clear()
