"""Two-input join operators on the host (port of
``flink_tpu/runtime/join_operators.py``; host code with the same
behaviour).

Window join (buffer both sides per slice, join on fire), interval join
(columnar side buffers pruned by watermark, with ``left_outer``) and the
event-time temporal join. Joins are data movement, not arithmetic: NumPy's
sort-join is the tool here. Window lifecycle reuses ``SliceBookkeeper``;
the equality join is a vectorized sort + searchsorted matcher. These are
the ``join.mode=host`` plane and the semantics the device engines
(``joins/``) are held to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.runtime.operators import Operator
from flink_tpu_torch.windowing.assigners import WindowAssigner
from flink_tpu_torch.windowing.bookkeeping import SliceBookkeeper
from flink_tpu_torch.windowing.windower import (
    WINDOW_END_FIELD,
    WINDOW_START_FIELD,
)


def equi_join_indices(left_keys: np.ndarray, right_keys: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """All (i, j) with left_keys[i] == right_keys[j], vectorized."""
    if len(left_keys) == 0 or len(right_keys) == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy()
    order_r = np.argsort(right_keys, kind="stable")
    rs = right_keys[order_r]
    lo = np.searchsorted(rs, left_keys, side="left")
    hi = np.searchsorted(rs, left_keys, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy()
    l_idx = np.repeat(np.arange(len(left_keys), dtype=np.int64), counts)
    # per-match offset within each left row's range
    starts = np.repeat(lo, counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    r_idx = order_r[starts + within]
    return l_idx, r_idx


def _filter_by_key_groups(cols: Dict[str, np.ndarray], key_group_filter,
                          max_parallelism: int) -> Dict[str, np.ndarray]:
    """Keep only rows whose key belongs to the owned key groups — the
    key-group-range-scoped restore of buffered join state (reference:
    keyed state restore is key-group scoped; join buffers are keyed
    state)."""
    from flink_tpu_torch.state.keygroups import assign_key_groups

    kid = np.asarray(cols[KEY_ID_FIELD], dtype=np.int64)
    groups = assign_key_groups(kid, max_parallelism)
    keep = np.isin(groups, np.fromiter(key_group_filter, dtype=np.int32,
                                       count=len(key_group_filter)))
    return {k: np.asarray(v)[keep] for k, v in cols.items()}


def _merge_columns(left: RecordBatch, right: RecordBatch,
                   l_idx: np.ndarray, r_idx: np.ndarray,
                   suffixes=("_l", "_r")) -> Dict[str, np.ndarray]:
    cols: Dict[str, np.ndarray] = {}
    lcols = {k: v[l_idx] for k, v in left.columns.items()}
    rcols = {k: v[r_idx] for k, v in right.columns.items()}
    for k, v in lcols.items():
        if k in rcols and k not in (KEY_ID_FIELD,):
            cols[k + suffixes[0]] = v
        else:
            cols[k] = v
    for k, v in rcols.items():
        if k in lcols:
            if k == KEY_ID_FIELD:
                continue
            cols[k + suffixes[1]] = v
        else:
            cols[k] = v
    return cols


class WindowJoinOperator(Operator):
    """INNER equi-join of two keyed streams per window."""

    name = "window_join"

    def __init__(self, assigner: WindowAssigner, suffixes=("_l", "_r"),
                 key_fields: Optional[Tuple[str, str]] = None):
        self.assigner = assigner
        self.suffixes = suffixes
        self.key_fields = key_fields
        self.book = SliceBookkeeper(assigner)
        # slice_end -> [left batches], [right batches]
        self._buf: Dict[int, Tuple[List[RecordBatch], List[RecordBatch]]] = {}
        self._max_parallelism = 128

    def open(self, ctx):
        self._max_parallelism = getattr(ctx, "max_parallelism", 128)

    def process_batch(self, batch, input_index=0):
        if len(batch) == 0:
            return []
        slice_ends = self.assigner.assign_slice_ends(batch.timestamps)
        live = self.book.live_mask(slice_ends)
        if live is not None:
            slice_ends = slice_ends[live]
            batch = batch.filter(live)
            if len(batch) == 0:
                return []
        self.book.register_slices(slice_ends)
        # split batch by slice
        order = np.argsort(slice_ends, kind="stable")
        se_sorted = slice_ends[order]
        boundaries = np.nonzero(np.diff(se_sorted))[0] + 1
        idx_chunks = np.split(order, boundaries)
        firsts = np.concatenate(([0], boundaries))
        for se, idxs in zip(se_sorted[firsts].tolist(), idx_chunks):
            sides = self._buf.setdefault(se, ([], []))
            sides[input_index].append(batch.take(idxs))
        return []

    def process_watermark(self, watermark, input_index=0):
        out: List[RecordBatch] = []
        while True:
            w_end = self.book.next_window(watermark)
            if w_end is None:
                break
            b = self._fire(w_end)
            if b is not None and len(b):
                out.append(b)
            self.book.mark_fired(w_end)
        for se in self.book.expired_slices(watermark):
            self._buf.pop(se, None)
        return out

    def _fire(self, window_end: int) -> Optional[RecordBatch]:
        lefts: List[RecordBatch] = []
        rights: List[RecordBatch] = []
        for se in self.assigner.slice_ends_for_window(window_end):
            sides = self._buf.get(se)
            if sides:
                lefts.extend(sides[0])
                rights.extend(sides[1])
        if not lefts or not rights:
            return None
        left = RecordBatch.concat(lefts)
        right = RecordBatch.concat(rights)
        l_idx, r_idx = equi_join_indices(left.key_ids, right.key_ids)
        if len(l_idx) == 0:
            return None
        # the window's own timestamp replaces the per-record ones; an
        # identically-named join key stays a single unsuffixed column
        left = left.drop(TIMESTAMP_FIELD)
        right = right.drop(TIMESTAMP_FIELD)
        if self.key_fields and self.key_fields[0] == self.key_fields[1]:
            right = right.drop(self.key_fields[1])
        cols = _merge_columns(left, right, l_idx, r_idx, self.suffixes)
        m = len(l_idx)
        cols[WINDOW_START_FIELD] = np.full(
            m, self.assigner.window_start(window_end), dtype=np.int64)
        cols[WINDOW_END_FIELD] = np.full(m, window_end, dtype=np.int64)
        cols[TIMESTAMP_FIELD] = np.full(m, window_end - 1, dtype=np.int64)
        return RecordBatch(cols)

    def snapshot_state(self):
        return {
            "book": self.book.snapshot(),
            "buf": {
                se: ([dict(b.columns) for b in l],
                     [dict(b.columns) for b in r])
                for se, (l, r) in self._buf.items()
            },
        }

    def restore_state(self, state, key_group_filter=None):
        self.book.restore(state["book"])
        buf = state.get("buf", {})
        if key_group_filter is not None:
            buf = {
                se: ([_filter_by_key_groups(c, key_group_filter,
                                            self._max_parallelism)
                      for c in l],
                     [_filter_by_key_groups(c, key_group_filter,
                                            self._max_parallelism)
                      for c in r])
                for se, (l, r) in buf.items()
            }
        self._buf = {
            se: ([RecordBatch(c) for c in l], [RecordBatch(c) for c in r])
            for se, (l, r) in buf.items()
        }


class IntervalJoinOperator(Operator):
    """Keyed interval join: left at t matches right in [t+lower, t+upper].

    reference: streaming/api/operators/co/IntervalJoinOperator.java —
    re-designed over columnar side buffers pruned by watermark instead of
    per-key MapState buckets + per-record timers.

    ``left_outer`` (LEFT JOIN): a left row whose interval expires without
    any match emits once, null-padded on the right, at the moment the
    watermark proves no match can still arrive (t + upper) — the
    reference's outer interval-join semantics. ``right_columns`` names
    the right schema so null-padded rows keep one stable shape even
    before any right row is seen."""

    name = "interval_join"

    def __init__(self, lower: int, upper: int, suffixes=("_l", "_r"),
                 left_outer: bool = False,
                 right_columns: Optional[List[str]] = None):
        assert lower <= upper
        self.lower = lower
        self.upper = upper
        self.suffixes = suffixes
        self.left_outer = left_outer
        if left_outer and right_columns is None:
            raise ValueError(
                "LEFT interval join needs the right-side column names "
                "(null padding must have a stable schema)")
        self.right_columns = list(right_columns) if right_columns \
            else None
        self._left: List[RecordBatch] = []
        #: per-buffered-left-row "has matched" flags, parallel to the
        #: concatenation of self._left (only maintained when left_outer)
        self._left_matched: List[np.ndarray] = []
        self._right: List[RecordBatch] = []
        #: right column -> observed dtype (set at the first right batch;
        #: drives type-correct null padding in _pad_unmatched)
        self._right_dtypes: Dict[str, np.dtype] = {}
        self._max_parallelism = 128

    def _observe_right(self, batch: RecordBatch) -> RecordBatch:
        """First-right-batch schema contract (LEFT JOIN only).

        The declared ``right_columns`` drive the null-padded schema, so
        a drift between declaration and the actual right batches would
        silently give matched and padded rows different schemas — raise
        instead. Integer/bool right columns are coerced to float64 at
        the buffering boundary: SQL NULL has no integer representation
        in a dense column, so BOTH matched and padded emissions carry
        float64 (one schema), rather than int in matched and float-NaN
        in padded."""
        if not self.left_outer:
            return batch
        observed = [c for c in batch.names()
                    if c not in (KEY_ID_FIELD, TIMESTAMP_FIELD)]
        declared = [c for c in self.right_columns
                    if c not in (KEY_ID_FIELD, TIMESTAMP_FIELD)]
        if set(observed) != set(declared):
            raise RuntimeError(
                "LEFT interval join: declared right columns "
                f"{sorted(declared)} != right batch columns "
                f"{sorted(observed)} — null padding would produce "
                "a different schema than matches")
        cols = dict(batch.columns)
        for c in observed:
            v = np.asarray(cols[c])
            if v.dtype.kind in "iub":
                # float64 only round-trips integers up to 2^53 — larger
                # values (snowflake-style IDs) must go through object
                # dtype or they'd be silently rounded. Compare in the
                # ORIGINAL dtype: casting uint64 >= 2^63 to int64 first
                # would wrap and sneak past the guard.
                big = (v.dtype.itemsize >= 8 and len(v)
                       and (int(v.max()) > (1 << 53)
                            or int(v.min()) < -(1 << 53)))
                v = v.astype(object) if big else v.astype(np.float64)
            elif v.dtype.kind in "US":
                # fixed-width numpy strings can't hold a None pad —
                # carry strings as object so NULL is representable
                v = v.astype(object)
            cols[c] = v
            prev = self._right_dtypes.setdefault(c, v.dtype)
            if prev != v.dtype:
                raise RuntimeError(
                    f"LEFT interval join: right column {c!r} changed "
                    f"carry dtype across batches ({prev} -> {v.dtype}; "
                    "an int64 value above 2^53 arrived after the column "
                    "was established as float64) — emitted schemas "
                    "would diverge")
        return RecordBatch(cols)

    def open(self, ctx):
        self._max_parallelism = getattr(ctx, "max_parallelism", 128)

    def process_batch(self, batch, input_index=0):
        if len(batch) == 0:
            return []
        out = []
        if input_index == 0:
            matches, l_hit = self._join(
                batch, RecordBatch.concat(self._right), left_is_new=True)
            self._left.append(batch)
            if self.left_outer:
                flags = np.zeros(len(batch), dtype=bool)
                if l_hit is not None:
                    flags[l_hit] = True
                self._left_matched.append(flags)
        else:
            batch = self._observe_right(batch)
            matches, l_hit = self._join(
                RecordBatch.concat(self._left), batch, left_is_new=False)
            self._right.append(batch)
            if self.left_outer and l_hit is not None and \
                    len(self._left_matched):
                merged = (self._left_matched[0]
                          if len(self._left_matched) == 1
                          else np.concatenate(self._left_matched))
                merged[l_hit] = True
                self._left_matched = [merged]
        if matches is not None and len(matches):
            out.append(matches)
        return out

    def _join(self, left: RecordBatch, right: RecordBatch,
              left_is_new: bool):
        """(matched batch or None, matching LEFT row indices or None)."""
        if len(left) == 0 or len(right) == 0:
            return None, None
        l_idx, r_idx = equi_join_indices(left.key_ids, right.key_ids)
        if len(l_idx) == 0:
            return None, None
        lt = left.timestamps[l_idx]
        rt = right.timestamps[r_idx]
        ok = (rt >= lt + self.lower) & (rt <= lt + self.upper)
        # each side's raw timestamp column must not survive into the merged
        # schema (it would come out as suffixed __ts___l/__ts___r junk); the
        # result's timestamp is computed below from lt/rt
        left = left.drop(TIMESTAMP_FIELD)
        right = right.drop(TIMESTAMP_FIELD)
        # (duplicate avoidance is structural: a pair is emitted by whichever
        # side arrives second — the new batch is joined only against the
        # other side's buffer, never its own)
        l_idx, r_idx = l_idx[ok], r_idx[ok]
        if len(l_idx) == 0:
            return None, None
        cols = _merge_columns(left, right, l_idx, r_idx, self.suffixes)
        cols[TIMESTAMP_FIELD] = np.maximum(lt[ok], rt[ok])
        return RecordBatch(cols), l_idx

    def _pad_unmatched(self, rows: RecordBatch) -> RecordBatch:
        """Null-extend expired unmatched left rows with the SAME column
        naming _merge_columns produces for matches."""
        lts = rows.timestamps
        left_b = rows.drop(TIMESTAMP_FIELD)
        rset = set(self.right_columns)
        cols: Dict[str, np.ndarray] = {}
        for k, v in left_b.columns.items():
            if k in rset and k != KEY_ID_FIELD:
                cols[k + self.suffixes[0]] = v
            else:
                cols[k] = v
        n = len(rows)
        for k in self.right_columns:
            if k in (KEY_ID_FIELD, TIMESTAMP_FIELD):
                continue
            name = k + self.suffixes[1] if k in left_b.columns else k
            dt = self._right_dtypes.get(k)
            if dt is not None and dt.kind in "OUS":
                # string/object right column: SQL NULL is None, not NaN
                cols[name] = np.full(n, None, dtype=object)
            else:
                cols[name] = np.full(n, np.nan,
                                     dtype=dt if dt is not None
                                     else np.float64)
        cols[TIMESTAMP_FIELD] = lts
        return RecordBatch(cols)

    def process_watermark(self, watermark, input_index=0):
        # prune buffers: left rows can only match right in
        # [t+lower, t+upper]; once watermark passes t+upper the left row
        # is dead (and symmetrically for right). A dead UNMATCHED left
        # row is exactly when LEFT JOIN null-extends.
        out: List[RecordBatch] = []
        min_left_ts = watermark - self.upper
        if self.left_outer and self._left:
            merged = RecordBatch.concat(self._left)
            matched = (self._left_matched[0]
                       if len(self._left_matched) == 1
                       else np.concatenate(self._left_matched)) \
                if self._left_matched else np.zeros(len(merged), bool)
            dead = merged.timestamps < min_left_ts
            expired = dead & ~matched
            if expired.any():
                out.append(self._pad_unmatched(merged.filter(expired)))
            keep = ~dead
            self._left = [merged.filter(keep)] if keep.any() else []
            self._left_matched = [matched[keep]] if keep.any() else []
        else:
            self._left = self._prune(self._left, min_left_ts)
        self._right = self._prune(self._right, watermark + self.lower)
        return out

    def close(self):
        from flink_tpu_torch.runtime.elements import MAX_WATERMARK

        # end of input: every buffered left row's interval has expired
        return self.process_watermark(MAX_WATERMARK)

    @staticmethod
    def _prune(batches: List[RecordBatch], min_ts: int) -> List[RecordBatch]:
        if not batches:
            return batches
        merged = RecordBatch.concat(batches)
        if len(merged) == 0:
            return []
        keep = merged.timestamps >= min_ts
        if keep.all():
            return [merged]
        return [merged.filter(keep)]

    def snapshot_state(self):
        snap = {
            "left": [dict(b.columns) for b in self._left],
            "right": [dict(b.columns) for b in self._right],
        }
        if self.left_outer:
            # ONE flags array aligned to the CONCATENATION of the left
            # buffers — a right-side match merges the per-batch arrays,
            # so batch-parallel storage would misalign on restore
            if self._left_matched:
                snap["ij_matched"] = np.concatenate(
                    [np.asarray(m) for m in self._left_matched])
            else:
                snap["ij_matched"] = np.zeros(
                    sum(len(b) for b in self._left), dtype=bool)
            # padding dtypes must survive a restore even when the right
            # buffer was pruned empty — else a post-restore pad of a
            # string column would fall back to float NaN
            snap["ij_right_dtypes"] = {
                k: str(v) for k, v in self._right_dtypes.items()}
        return snap

    def restore_state(self, state, key_group_filter=None):
        left = state.get("left", [])
        right = state.get("right", [])
        if self.left_outer and left:
            # normalize the left side to ONE batch + one flags array so
            # the key-group filter applies to both identically
            merged = RecordBatch.concat([RecordBatch(
                {k: np.asarray(v) for k, v in c.items()}) for c in left])
            matched = np.asarray(
                state.get("ij_matched",
                          np.zeros(len(merged), dtype=bool)), dtype=bool)
            if key_group_filter is not None:
                from flink_tpu_torch.state.keygroups import assign_key_groups

                kid = np.asarray(merged.key_ids, dtype=np.int64)
                groups = assign_key_groups(kid, self._max_parallelism)
                keep = np.isin(groups,
                               np.asarray(sorted(key_group_filter)))
                merged = merged.filter(keep)
                matched = matched[keep]
            self._left = [merged] if len(merged) else []
            self._left_matched = [matched] if len(merged) else []
        else:
            if key_group_filter is not None:
                left = [_filter_by_key_groups(c, key_group_filter,
                                              self._max_parallelism)
                        for c in left]
            self._left = [RecordBatch(c) for c in left]
            if self.left_outer:
                self._left_matched = [np.zeros(len(b), dtype=bool)
                                      for b in self._left]
        if key_group_filter is not None:
            right = [_filter_by_key_groups(c, key_group_filter,
                                           self._max_parallelism)
                     for c in right]
        self._right = [RecordBatch(c) for c in right]
        self._right_dtypes = {
            k: np.dtype(v)
            for k, v in state.get("ij_right_dtypes", {}).items()}


class TemporalJoinOperator(Operator):
    """Event-time temporal join: each left row joins the RIGHT VERSION
    valid at the left row's event time.

    reference: flink-table/flink-table-runtime/.../operators/join/temporal/
    TemporalRowTimeJoinOperator.java (and the planner's
    StreamExecTemporalJoin) — the right input is a versioned stream keyed
    by the join key, versioned by its rowtime; a left row at t matches
    the latest right version with version_ts <= t. Correctness needs
    version completeness, so left rows wait for the COMBINED watermark
    (the valve min across both inputs) before joining; late left rows
    drop.

    Re-design: per watermark advance, ready left rows sort once by
    (key, ts) and each key segment binary-searches its version history
    (columnar, sorted) — no per-row state lookups. Version state
    compacts to {versions newer than the watermark} + {the single
    latest version at-or-before it} per key, the reference's
    cleanupState contract.
    """

    name = "temporal_join"

    def __init__(self, suffixes=("_l", "_r")):
        self.suffixes = suffixes
        self._left: List[RecordBatch] = []
        self._versions: List[RecordBatch] = []
        self._max_parallelism = 128
        self.late_left_dropped = 0
        self._emitted_wm = -(1 << 62)

    def open(self, ctx):
        self._max_parallelism = getattr(ctx, "max_parallelism", 128)

    def process_batch(self, batch, input_index=0):
        if len(batch) == 0:
            return []
        if input_index == 0:
            late = batch.timestamps <= self._emitted_wm
            if late.any():
                self.late_left_dropped += int(late.sum())
                batch = batch.filter(~late)
            if len(batch):
                self._left.append(batch)
        else:
            self._versions.append(batch)
        return []

    def process_watermark(self, watermark, input_index=0):
        self._emitted_wm = max(self._emitted_wm, watermark)
        if not self._left:
            self._compact(watermark)
            return []
        left = RecordBatch.concat(self._left)
        ready_mask = left.timestamps <= watermark
        self._left = [left.filter(~ready_mask)] \
            if (~ready_mask).any() else []
        ready = left.filter(ready_mask)
        if len(ready) == 0:
            self._compact(watermark)
            return []
        out = self._join(ready)
        self._compact(watermark)
        return [out] if out is not None and len(out) else []

    def close(self):
        from flink_tpu_torch.runtime.elements import MAX_WATERMARK

        return self.process_watermark(MAX_WATERMARK)

    def _sorted_versions(self):
        if not self._versions:
            return None
        v = RecordBatch.concat(self._versions)
        if len(v) == 0:
            return None
        order = np.lexsort((v.timestamps, v.key_ids))
        v = v.take(order)
        self._versions = [v]
        return v

    def _join(self, ready: RecordBatch) -> Optional[RecordBatch]:
        v = self._sorted_versions()
        if v is None:
            return None
        order = np.lexsort((ready.timestamps, ready.key_ids))
        ready = ready.take(order)
        lk, lt = ready.key_ids, ready.timestamps
        vk, vt = v.key_ids, v.timestamps
        # per-key version segment for every ready row (both sides sorted
        # by key, so one vectorized searchsorted each)
        lo = np.searchsorted(vk, lk, side="left")
        hi = np.searchsorted(vk, lk, side="right")
        pick = np.full(len(ready), -1, dtype=np.int64)
        # binary-search each key segment once for all its ready rows
        starts = np.flatnonzero(np.r_[True, lk[1:] != lk[:-1]])
        bounds = np.r_[starts, len(lk)]
        for s in range(len(bounds) - 1):
            a, b = bounds[s], bounds[s + 1]
            if lo[a] >= hi[a]:
                continue  # no versions for this key
            seg = vt[lo[a]:hi[a]]
            pos = np.searchsorted(seg, lt[a:b], side="right") - 1
            ok = pos >= 0
            pick[a:b][ok] = lo[a] + pos[ok]
        matched = pick >= 0
        l_idx = np.flatnonzero(matched)
        r_idx = pick[matched]
        if len(l_idx) == 0:
            return None  # INNER: left rows with no valid version drop
        lts = lt[l_idx]
        cols = _merge_columns(ready.drop(TIMESTAMP_FIELD),
                              v.drop(TIMESTAMP_FIELD),
                              l_idx, r_idx, self.suffixes)
        cols[TIMESTAMP_FIELD] = lts
        return RecordBatch(cols)

    def _compact(self, watermark: int) -> None:
        """Keep versions newer than the watermark plus each key's single
        latest version at-or-before it (any future left row joins one of
        those)."""
        v = self._sorted_versions()
        if v is None:
            return
        vk, vt = v.key_ids, v.timestamps
        future = vt > watermark
        # latest at-or-before per key: the last index of each key's
        # prefix segment (vt sorted within key)
        is_last_of_prefix = np.r_[
            (vk[1:] != vk[:-1]) | future[1:], True] & ~future
        keep = future | is_last_of_prefix
        if not keep.all():
            self._versions = [v.filter(keep)]

    def snapshot_state(self):
        return {
            "left": [dict(b.columns) for b in self._left],
            "tj_versions": [dict(b.columns) for b in self._versions],
            "max_ts": self._emitted_wm,
        }

    def restore_state(self, state, key_group_filter=None):
        def rebuild(cols_list):
            out = []
            for cols in cols_list:
                cols = {k: np.asarray(c) for k, c in cols.items()}
                if key_group_filter is not None:
                    cols = _filter_by_key_groups(
                        cols, key_group_filter, self._max_parallelism)
                out.append(RecordBatch(cols))
            return out

        self._left = rebuild(state.get("left", []))
        self._versions = rebuild(state.get("tj_versions", []))
        self._emitted_wm = state.get("max_ts", -(1 << 62))
