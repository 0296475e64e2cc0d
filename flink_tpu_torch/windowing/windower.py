"""Slice-shared window engine (port of ``SliceSharedWindower`` in
``flink_tpu/windowing/windower.py``): host-side control, device-side math.

A ``WindowAssigner`` maps timestamps to slices and windows to slices; a
``SlotTable`` keeps one accumulator row per (key, slice) on the device.

- ``process_batch``: vectorized slice assignment, late-record drop, slot
  lookup, one fold per accumulator leaf.
- ``on_watermark``: fire every pending window with end - 1 <= watermark —
  its ``[keys, slices]`` slot matrix built on the host, one gather, merge,
  finish (and projection) program on the device — then free the slices
  whose last window fired.

Window lifecycle metadata lives in ``SliceBookkeeper`` (shared with the
mesh engine). ``PaneWindower`` runs the same contract over the pane layout
(``state/pane_table.py``). ``snapshot``/``restore`` carry the table's
logical rows and the bookkeeping in the reference's format.

Point queries: ``query_windows`` / ``query_windows_batch`` answer
{window_end -> result columns} for live keys through
``compose_windows_pairs``, the one copy of the serving path's
slice-to-window composition (``compose_windows`` and the mesh engine read
through it too).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.runtime.local_agg import (
    is_partial_batch,
    partial_leaf_values,
)
from flink_tpu_torch.ops.segment_ops import HOST_COMBINE
from flink_tpu_torch.windowing.aggregates import AggregateFunction
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.bookkeeping import SliceBookkeeper

WINDOW_START_FIELD = "window_start"
WINDOW_END_FIELD = "window_end"


def compose_windows(assigner, agg, slice_vals: Dict[int, tuple]
                    ) -> Dict[int, Dict[str, float]]:
    """Slice sharing on the host (reference
    ``flink_tpu/windowing/windower.py:40``): one key's ``{slice_end ->
    per-leaf 1-element raw accumulator arrays}`` composed into
    ``{window_end -> finished result columns}``: ``compose_windows_pairs``
    for a batch of one key."""
    if not slice_vals:
        return {}
    ns = np.fromiter(slice_vals, dtype=np.int64, count=len(slice_vals))
    leaves = [np.concatenate([slice_vals[int(se)][i] for se in ns])
              for i in range(len(agg.leaves))]
    return compose_windows_pairs(assigner, agg,
                                 np.zeros(len(ns), dtype=np.int64), ns,
                                 leaves, 1)[0]


#: the quiet bit of a float's NaN, by width
_QUIET = {4: (np.uint32, np.uint32(0x00400000)),
          8: (np.uint64, np.uint64(0x0008000000000000))}


def _combine_elementwise(reduce: str, a: np.ndarray, b: np.ndarray
                         ) -> np.ndarray:
    """``HOST_COMBINE[reduce](a, b)`` elementwise with the NaN each pair
    gets from a ONE-element call, the reference's composition: NumPy's
    vector loops may return the other operand's NaN when both are NaN.
    Sums: a NaN ``a`` comes out quieted, else a NaN ``b`` quieted (the
    CPU's scalar add); max/min: a NaN ``a``, else a NaN ``b``, unchanged
    (NumPy's scalar rule)."""
    out = HOST_COMBINE[reduce](a, b)
    if a.dtype.kind != "f":
        return out
    na, nb = np.isnan(a), np.isnan(b)
    if not (na.any() or nb.any()):
        return out
    if reduce == "sum":
        u, q = _QUIET[a.dtype.itemsize]
        qa = (a.view(u) | q).view(a.dtype)
        qb = (b.view(u) | q).view(b.dtype)
        return np.where(na, qa, np.where(nb, qb, out))
    return np.where(na, a, np.where(nb, b, out))


def compose_windows_pairs(assigner, agg, rows: np.ndarray, ns: np.ndarray,
                          leaves, n: int) -> List[Dict[int, Dict[str, float]]]:
    """The serving path's composition for a whole batch: ``(rows[j],
    ns[j])`` pairs (request row, slice end) with their raw leaf values
    ``leaves[i][j]`` become one ``{window_end -> finished result columns}``
    per request row (``n`` rows; a pair given twice keeps its later
    values). Each window touching a row's slices is the left fold of that
    row's slices in ``slice_ends_for_window`` order with ``HOST_COMBINE``
    (absent slices skipped), as the reference folds it key by key, so
    float sums keep its bits; here every (row, window) folds at once,
    elementwise, and finishes in one call. Result columns are Python
    scalars."""
    out: List[Dict[int, Dict[str, float]]] = [{} for _ in range(n)]
    if len(ns) == 0:
        return out
    rows = np.asarray(rows, dtype=np.int64)
    ns = np.asarray(ns, dtype=np.int64)
    uniq, sidx = np.unique(ns, return_inverse=True)
    at = {int(se): i for i, se in enumerate(uniq.tolist())}
    pair_at = np.full((n, len(uniq)), -1, dtype=np.int64)
    pair_at[rows, sidx] = np.arange(len(ns))
    # the (row, window) combinations: every window of every present slice
    wins_of = [assigner.window_ends_for_slice(int(se)) for se in uniq]
    windows = sorted({int(w) for ws in wins_of for w in ws})
    w_at = {w: i for i, w in enumerate(windows)}
    has = np.zeros((n, len(windows)), dtype=bool)
    for s, ws in enumerate(wins_of):
        present = pair_at[:, s] >= 0
        for w in ws:
            has[:, w_at[int(w)]] |= present
    c_row, c_win = np.nonzero(has)            # row-major: rows ascending
    accs = [np.full(len(c_row), l.identity, dtype=l.dtype)
            for l in agg.leaves]
    # inf + -inf is NaN in any order: no warning for the data's specials
    with np.errstate(invalid="ignore", over="ignore"):
        for wi, w in enumerate(windows):
            sel = np.nonzero(c_win == wi)[0]
            r = c_row[sel]
            for se in assigner.slice_ends_for_window(w):
                s = at.get(int(se))
                if s is None:
                    continue
                pj = pair_at[r, s]
                m = pj >= 0
                if not m.any():
                    continue
                for i, l in enumerate(agg.leaves):
                    cur = accs[i][sel]
                    accs[i][sel] = np.where(m, _combine_elementwise(
                        l.reduce, cur,
                        np.asarray(leaves[i])[np.maximum(pj, 0)]), cur)
    finished = agg.finish(tuple(torch.from_numpy(a) for a in accs))
    cols = [(name, col.tolist()) for name, col in finished.items()]
    for j, (r, wi) in enumerate(zip(c_row.tolist(), c_win.tolist())):
        out[r][windows[wi]] = {name: vals[j] for name, vals in cols}
    return out


class SliceSharedWindower:
    """Windowed keyed aggregation over one device. ``spill``: the
    SlotTable's device and spill arguments (``device``,
    ``max_device_slots``, ``spill_dir``, ``spill_host_max_bytes``)."""

    #: on_watermark(async_ok=True) may return PendingFire handles (the
    #: hosting operator owns their harvest and the watermark holdback)
    supports_async_fires = True

    def __init__(
        self,
        assigner: WindowAssigner,
        agg: AggregateFunction,
        capacity: int = 1 << 16,
        max_parallelism: int = 128,
        allowed_lateness: int = 0,
        spill: dict = None,
        fire_projector=None,
    ) -> None:
        from flink_tpu_torch.state.slot_table import SlotTable

        self.assigner = assigner
        self.agg = agg
        self.table = SlotTable(agg, capacity=capacity,
                               max_parallelism=max_parallelism,
                               **(spill or {}))
        self.book = SliceBookkeeper(assigner, allowed_lateness)
        #: optional device-side reduction of each fired window's rows
        self.fire_projector = fire_projector

    @property
    def late_records_dropped(self) -> int:
        return self.book.late_records_dropped

    def spill_counters(self):
        return self.table.spill_counters()

    def make_fence(self):
        return self.table.make_fence()

    # --------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        fused = getattr(self.table, "ingest_indices", None)
        if fused is not None:
            out = fused(batch.key_ids, batch.timestamps,
                        self.assigner.offset, self.assigner.slice_width)
            if out is not None:
                flat, uniq, sinv = out
                self._register_fused(uniq, sinv)
                if is_partial_batch(batch):
                    self.table.scatter_flat(
                        flat, partial_leaf_values(batch, self.agg),
                        valued=True)
                else:
                    self.table.scatter_flat(flat,
                                            self.agg.map_input(batch))
                return
        slice_ends = self.assigner.assign_slice_ends(batch.timestamps)
        live = self.book.live_mask(slice_ends)
        if live is not None:
            slice_ends = slice_ends[live]
            batch = batch.filter(live)
            if len(batch) == 0:
                return
        # one O(n) pass finds the distinct slice ends and the inverse, for
        # the bookkeeper and a table that takes the plan
        plan = self.assigner.slice_plan(slice_ends)
        self.book.register_slices(slice_ends, uniq=plan[0])
        kw = {"slice_plan": plan} \
            if getattr(self.table, "accepts_slice_plan", False) else {}
        if is_partial_batch(batch):
            # locally pre-aggregated rows: fold explicit per-leaf partials
            self.table.upsert_valued(batch.key_ids, slice_ends,
                                     partial_leaf_values(batch, self.agg),
                                     **kw)
        else:
            self.table.upsert(batch.key_ids, slice_ends,
                              self.agg.map_input(batch), **kw)

    def _register_fused(self, uniq: np.ndarray, sinv: np.ndarray) -> None:
        """Bookkeeping of the fused ingest. Late records are not filtered
        out of its scatter: they land in slices whose every window is past
        retention, which no fire reads and the next watermark frees, so
        the results and the late-drop count match the filtering path."""
        book = self.book
        if book.watermark > -(1 << 61):
            last = self.assigner.last_window_ends(uniq)
            late = last - 1 + book.allowed_lateness <= book.watermark
            if late.any():
                book.late_records_dropped += int(
                    np.bincount(sinv, minlength=len(uniq))[late].sum())
        book.register_slices(uniq, uniq=uniq)

    # ----------------------------------------------------------------- fire

    def on_watermark(self, watermark: int,
                     async_ok: bool = False) -> List[object]:
        """Fire all windows with end - 1 <= watermark: result batches, or
        with ``async_ok`` PendingFire handles whose harvest yields them.
        Slice frees dispatched after the fires run behind them on the
        device's stream, so a deferred host read never races a reset."""
        out: List[object] = []
        while True:
            w_end = self.book.next_window(watermark)
            if w_end is None:
                break
            batch = self._fire_window(w_end, async_ok=async_ok)
            if batch is not None and (not hasattr(batch, "__len__")
                                      or len(batch) > 0):
                out.append(batch)
            self.book.mark_fired(w_end)
        expired = self.book.expired_slices(watermark)
        if expired:
            self.table.free_namespaces(expired)
        return out

    def _columns(self, window_end: int, keys: np.ndarray,
                 results) -> RecordBatch:
        m = len(keys)
        cols = {
            KEY_ID_FIELD: keys,
            WINDOW_START_FIELD: np.full(
                m, self.assigner.window_start(window_end), dtype=np.int64),
            WINDOW_END_FIELD: np.full(m, window_end, dtype=np.int64),
            TIMESTAMP_FIELD: np.full(m, window_end - 1, dtype=np.int64),
        }
        cols.update(results)
        return RecordBatch(cols)

    def _wrap_pending(self, pending, window_end: int):
        """The table's PendingFire (keys, result columns) with the window
        columns added at harvest."""
        if pending is None:
            return None
        inner = pending.build

        def build(host):
            keys, results = inner(host)
            if len(keys) == 0:
                return None
            return self._columns(window_end, keys, results)

        pending.build = build
        return pending

    def _fire_window(self, window_end: int, async_ok: bool = False):
        slice_ends = self.assigner.slice_ends_for_window(window_end)
        if any(int(se) in self.table.spill for se in slice_ends):
            # hybrid fire: resident slices merge on the device, spilled
            # ones on the host — the device budget does not depend on the
            # window's slice count
            keys, results = self.table.fire_hybrid(
                [int(se) for se in slice_ends])
            if len(keys) == 0:
                return None
            if self.fire_projector is not None:
                keys, results = self.fire_projector.project_host(
                    keys, results)
            return self._columns(window_end, keys, results)
        if len(slice_ends) == 1:
            # single-slice (tumbling) fast path: no cross-slice grouping
            slots = self.table.slots_for_namespace(slice_ends[0])
            if len(slots) == 0:
                return None
            keys = self.table.keys_of_slots(slots)
            matrix = slots[:, None].astype(np.int32)
        else:
            keys, matrix = self.table.build_slice_matrix(
                [int(se) for se in slice_ends])
            if keys is None:
                return None
        if self.fire_projector is not None:
            if async_ok:
                return self._wrap_pending(
                    self.table.fire_projected_async(
                        matrix, keys, self.fire_projector), window_end)
            keys, results = self.table.fire_projected(
                matrix, keys, self.fire_projector)
        else:
            if async_ok:
                return self._wrap_pending(
                    self.table.fire_async(matrix, keys), window_end)
            results = self.table.fire(matrix)
        return self._columns(window_end, keys, results)

    # ---------------------------------------------------------- point query

    def query_windows(self, key_id: int) -> Dict[int, Dict[str, float]]:
        """{window_end -> result columns} for one key (reference
        ``flink_tpu/windowing/windower.py:275``)."""
        return self.table.query_windows(key_id, self.assigner)

    def query_windows_batch(self, key_ids
                            ) -> List[Dict[int, Dict[str, float]]]:
        """One result dict per requested key (reference ``:280``): the
        whole batch through ONE gather and ONE device-to-host copy
        (``SlotTable.query_batch_pairs`` over keys x live slices); the pane
        layout, with no pair gather, answers key by key."""
        key_ids = np.asarray(key_ids, dtype=np.int64)
        n = len(key_ids)
        if n == 0:
            return []
        if not hasattr(self.table, "query_batch_pairs"):
            return [self.query_windows(int(k)) for k in key_ids]
        live_ns = np.asarray([int(x) for x in self.table.namespaces],
                             dtype=np.int64)
        if len(live_ns) == 0:
            return [{} for _ in range(n)]
        pair_keys = np.repeat(key_ids, len(live_ns))
        pair_ns = np.tile(live_ns, n)
        found, leaves = self.table.query_batch_pairs(pair_keys, pair_ns)
        rows = np.repeat(np.arange(n, dtype=np.int64), len(live_ns))
        return compose_windows_pairs(self.assigner, self.agg, rows[found],
                                     pair_ns[found],
                                     [l[found] for l in leaves], n)

    # ------------------------------------------------------------- snapshot

    def snapshot(self, mode: str = "full") -> Dict[str, object]:
        """mode: "full" (a new incremental base), "delta" (dirty rows
        only), "savepoint" (full, keeping the dirty tracking)."""
        if mode == "delta":
            table = self.table.snapshot_delta()
        else:
            table = self.table.snapshot(reset_dirty=(mode != "savepoint"))
        return {"table": table, **self.book.snapshot()}

    def restore(self, snap: Dict[str, object], key_group_filter=None) -> None:
        self.table.restore(snap["table"], key_group_filter=key_group_filter)
        self.book.restore(snap)


class PaneWindower(SliceSharedWindower):
    """SliceSharedWindower over the pane layout (``state/pane_table.py``):
    the same contract, but a fire is a device reduction over ring rows —
    no host-built slot matrix, no per-fire host->device transfer but the
    row ids — and freeing a slice is one row reset.

    With ``preagg`` (the default, ``latency.pane-preagg``) each pending
    window also keeps a RUNNING PARTIAL row, combined at absorb: a record
    scatters into its pane AND into every pending window that has a
    partial row, in one flat-index scatter, and the window's fire gathers
    that ONE row. Windows without a partial row — and every window with
    ``preagg`` off — take the full-window harvest over their slices'
    rows. Partials are derived state: snapshots carry the panes, and
    restore, compaction and late re-registrations refold them. Float sums
    fold in record order rather than slice by slice, so they can differ
    from the full harvest in the last bits (Count, Min, Max and
    integer-valued sums are exact). Tumbling windows (one slice) keep no
    partials: the partial would duplicate the pane.
    """

    def __init__(
        self,
        assigner: WindowAssigner,
        agg: AggregateFunction,
        capacity: int = 1 << 16,
        max_parallelism: int = 128,
        allowed_lateness: int = 0,
        fire_projector=None,
        preagg: bool = True,
        device=None,
        memory=None,
    ) -> None:
        from flink_tpu_torch.state.pane_table import PaneTable

        self.assigner = assigner
        self.agg = agg
        self._preagg = bool(preagg) and assigner.slices_per_window > 1
        self.table = PaneTable(
            agg, capacity=capacity, max_parallelism=max_parallelism,
            fire_projector=fire_projector, device=device, memory=memory,
            slices_for_window=(assigner.slice_ends_for_window
                               if self._preagg else None))
        self.book = SliceBookkeeper(assigner, allowed_lateness)
        self.fire_projector = fire_projector

    def spill_counters(self):
        return None

    # --------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch) -> None:
        if not self._preagg:
            return super().process_batch(batch)
        if len(batch) == 0:
            return
        table = self.table
        flat = uniq = sinv = None
        out = table.ingest_indices(batch.key_ids, batch.timestamps,
                                   self.assigner.offset,
                                   self.assigner.slice_width)
        if out is not None:
            flat, uniq, sinv = out
            self._register_fused(uniq, sinv)
        else:
            slice_ends = self.assigner.assign_slice_ends(batch.timestamps)
            live = self.book.live_mask(slice_ends)
            if live is not None:
                slice_ends = slice_ends[live]
                batch = batch.filter(live)
                if len(batch) == 0:
                    return
            plan = self.assigner.slice_plan(slice_ends)
            self.book.register_slices(slice_ends, uniq=plan[0])
            uniq, sinv = plan
            flat = table._flat_indices(batch.key_ids, slice_ends, plan)
        # combine-on-absorb: records fold into their pending windows'
        # partial rows in the SAME scatter; windows without a row (new,
        # late re-registered, restored) are refolded from the panes after
        pending = self.book.pending_windows()
        wins = [[w for w in self.assigner.window_ends_for_slice(int(se))
                 if w in pending and table.has_window_partial(w)]
                for se in uniq.tolist()]
        win = table.window_flat(flat % np.int32(table.capacity), sinv, wins)
        if is_partial_batch(batch):
            table.scatter_combined(flat, win,
                                   partial_leaf_values(batch, self.agg),
                                   valued=True)
        else:
            table.scatter_combined(flat, win, self.agg.map_input(batch))
        table.rebuild_window_partials(pending)

    # ----------------------------------------------------------------- fire

    def _fire_window(self, window_end: int, async_ok: bool = False):
        if self._preagg and self.table.has_window_partial(window_end):
            # the delta harvest: ONE ring row
            if async_ok:
                return self._wrap_pending(
                    self.table.fire_partial_async(window_end), window_end)
            return self._assemble(window_end,
                                  *self.table.fire_partial(window_end))
        # the full-window harvest (preagg off, or no partial row)
        slice_ends = [int(se) for se in
                      self.assigner.slice_ends_for_window(window_end)]
        if async_ok:
            return self._wrap_pending(
                self.table.fire_window_async(slice_ends), window_end)
        return self._assemble(window_end,
                              *self.table.fire_window(slice_ends))

    def _assemble(self, window_end: int, keys, results):
        if len(keys) == 0:
            return None
        return self._columns(window_end, keys, results)

    # ------------------------------------------------------------- snapshot

    def restore(self, snap, key_group_filter=None) -> None:
        if self._preagg:
            # partial rows are derived: drop stale ones, land the panes,
            # then refold the pending windows' partials
            self.table.clear_window_rows()
        super().restore(snap, key_group_filter=key_group_filter)
        if self._preagg:
            self.table.rebuild_window_partials(self.book.pending_windows())
