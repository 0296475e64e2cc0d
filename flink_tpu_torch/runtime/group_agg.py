"""Unwindowed GROUP BY — running keyed aggregation with changelog emission (port of
``flink_tpu/runtime/group_agg.py``).

reference: flink-table-runtime/.../aggregate/GroupAggFunction.java:85
(processElement reads accState.value(), folds one record, writes back, and
emits retract+insert pairs downstream; `firstRow` decides INSERT vs
UPDATE_BEFORE/UPDATE_AFTER, and a row-count accumulator decides DELETE) and
its MiniBatch variant (MiniBatchGroupAggFunction.java:163 finishBundle).

Re-design: the per-key accumulators live in the device SlotTable under a
single namespace (namespace 0 — there is no window dimension); a micro-batch
folds in with ONE scatter kernel per accumulator leaf. Emission is a
changelog (RowKind column, flink_tpu_torch.core.records.ROWKIND_FIELD):

- first value of a key             -> INSERT
- updated value                    -> UPDATE_BEFORE(prev) + UPDATE_AFTER(new)
- row count falls to zero          -> DELETE(prev)

The UPDATE_BEFORE image is the value at the key's previous *emission*
(tracked in host arrays), so no extra device read is needed — exactly the
reference's contract, where the retraction carries the previously emitted
row. Retraction INPUT (a second-level aggregate over an updating stream) is
consumed by folding each row's contribution with its changelog sign in one
signed scatter; this requires every accumulator leaf to be additive
(``AggregateFunction.retractable`` — COUNT/SUM/AVG yes, MAX/MIN no, like
the reference's retractable agg function family).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    ROWKIND_DELETE,
    ROWKIND_FIELD,
    ROWKIND_INSERT,
    ROWKIND_UPDATE_AFTER,
    ROWKIND_UPDATE_BEFORE,
    TIMESTAMP_FIELD,
    RecordBatch,
    rowkind_signs,
)
from flink_tpu_torch.runtime.operators import Operator
from flink_tpu_torch.state.slot_table import SlotTable
from flink_tpu_torch.windowing.aggregates import AggregateFunction

_GLOBAL_NS = 0


class GroupAggOperator(Operator):
    name = "group_agg"

    def __init__(self, agg: AggregateFunction, key_field: str,
                 capacity: int = 1 << 16,
                 emit_on_watermark_only: bool = False,
                 generate_update_before: bool = True,
                 ttl_ms: Optional[int] = None, clock=None):
        self.agg = agg
        self.key_field = key_field
        self.capacity = capacity
        #: True = suppress per-batch emission, emit one deduped changelog
        #: per watermark advance (MiniBatch-style emission)
        self.emit_on_watermark_only = emit_on_watermark_only
        #: False = upsert mode: UPDATE_AFTER only (no retraction images),
        #: DELETEs still emitted — for upsert-keyed sinks
        self.generate_update_before = generate_update_before
        #: idle-state retention: accumulators untouched for ttl_ms are
        #: dropped (slot freed, snapshot shrinks); a key arriving after
        #: expiry re-INSERTs — the reference's documented
        #: `table.exec.state.ttl` semantics (reference: StateTtlConfig +
        #: GroupAggFunction's stateRetentionTime cleanup timer). Silent
        #: drop, no DELETE emission, like the reference.
        self.ttl_ms = ttl_ms
        from flink_tpu_torch.state.ttl import SweepGate, default_clock

        self._clock = clock or default_clock
        self._sweep_gate = SweepGate(ttl_ms) if ttl_ms else None
        self.table: Optional[SlotTable] = None
        self._key_values: Dict[int, Any] = {}
        self._keys_hashed = False
        self._dirty: set = set()
        self._max_ts = 0
        # per-slot changelog bookkeeping (host; grown with the table)
        self._row_counts = np.zeros(0, dtype=np.int64)
        self._emitted_mask = np.zeros(0, dtype=bool)
        self._last_emitted: Dict[str, np.ndarray] = {}
        #: per-slot last-update processing-time stamp (-1 = free)
        self._last_update = np.zeros(0, dtype=np.int64)

    def open(self, ctx):
        mm = getattr(ctx, "memory_manager", None)
        self.table = SlotTable(
            self.agg, capacity=self.capacity,
            max_parallelism=ctx.max_parallelism, device=ctx.device,
            memory=(mm, f"{self.name}#{id(self):x}") if mm else None)

    def dispose(self):
        if self.table is not None:
            self.table.release_memory()

    # ------------------------------------------------------------- host state

    def _ensure_host_capacity(self, n: int) -> None:
        if n <= len(self._row_counts):
            return
        size = max(n, 2 * len(self._row_counts), 1024)
        grown = np.zeros(size, dtype=np.int64)
        grown[: len(self._row_counts)] = self._row_counts
        self._row_counts = grown
        mask = np.zeros(size, dtype=bool)
        mask[: len(self._emitted_mask)] = self._emitted_mask
        self._emitted_mask = mask
        stamps = np.full(size, -1, dtype=np.int64)
        stamps[: len(self._last_update)] = self._last_update
        self._last_update = stamps
        for name, arr in self._last_emitted.items():
            g = np.zeros(size, dtype=arr.dtype)
            g[: len(arr)] = arr
            self._last_emitted[name] = g

    # --------------------------------------------------------------- TTL

    def _maybe_sweep_ttl(self) -> None:
        """Vectorized idle-state expiry: one masked scan per sweep
        interval (ttl/4, floor 1 ms) instead of the reference's
        per-key cleanup timers."""
        if not self.ttl_ms:
            return
        now = self._clock()
        if not self._sweep_gate.should_sweep(now):
            return
        n = len(self._last_update)
        if n == 0:
            return
        stamps = self._last_update
        expired = np.nonzero((stamps != -1)
                             & (now - stamps > self.ttl_ms))[0]
        if not len(expired):
            return
        if self._keys_hashed:
            for kid in self.table.keys_of_slots(expired).tolist():
                self._key_values.pop(int(kid), None)
        self.table.free_slots(expired)
        self._row_counts[expired] = 0
        self._emitted_mask[expired] = False
        stamps[expired] = -1
        if self._dirty:
            self._dirty.difference_update(expired.tolist())

    # ----------------------------------------------------------------- ingest

    def process_batch(self, batch: RecordBatch, input_index: int = 0
                      ) -> List[RecordBatch]:
        if len(batch) == 0:
            return []
        if batch.has_timestamps:
            self._max_ts = max(self._max_ts, int(batch.timestamps.max()))
        if self.key_field in batch.columns:
            keys = batch[self.key_field]
            if keys.dtype.kind not in "iu":
                self._keys_hashed = True
                kid = batch.key_ids
                uniq, first = np.unique(kid, return_index=True)
                for i, j in zip(uniq.tolist(), first.tolist()):
                    self._key_values.setdefault(i, keys[j])
        namespaces = np.full(len(batch), _GLOBAL_NS, dtype=np.int64)
        slots = self.table.lookup_or_insert(batch.key_ids, namespaces)
        kinds = batch.row_kinds
        signs = None if kinds is None else rowkind_signs(np.asarray(kinds))
        if signs is None or not (signs < 0).any():
            # append-only input (possibly an all-INSERT changelog) — the
            # plain scatter path works for every aggregate, incl. MAX/MIN
            self.table.scatter(slots, self.agg.map_input(batch))
            signs = None
        else:
            if not self.agg.retractable:
                raise ValueError(
                    "aggregate over an updating (retraction) input requires "
                    "retractable accumulators (COUNT/SUM/AVG); "
                    f"{type(self.agg).__name__} has MAX/MIN-style leaves "
                    "(reference: GroupAggFunction requires retract() for "
                    "update streams)")
            self.table.scatter_signed(
                slots, self.agg.map_input_signed(batch, signs))
        self._ensure_host_capacity(int(slots.max()) + 1)
        np.add.at(self._row_counts, slots,
                  1 if signs is None else signs.astype(np.int64))
        if self.ttl_ms:
            self._last_update[slots] = self._clock()
            self._maybe_sweep_ttl()
        if self.emit_on_watermark_only:
            self._dirty.update(np.unique(slots).tolist())
            return []
        out = self._emit_slots(np.unique(slots))
        return [out] if out is not None else []

    def process_watermark(self, watermark, input_index=0):
        if not self.emit_on_watermark_only or not self._dirty:
            self._maybe_sweep_ttl()
            return []
        slots = np.fromiter(self._dirty, dtype=np.int64)
        self._dirty.clear()
        out = self._emit_slots(slots)
        self._maybe_sweep_ttl()
        return [out] if out is not None else []

    # --------------------------------------------------------------- emission

    def _emit_slots(self, slots: np.ndarray) -> Optional[RecordBatch]:
        if len(slots) == 0:
            return None
        results = self.table.fire(slots[:, None].astype(np.int32))
        # the reference's result columns come out of a jitted dict, in
        # sorted key order; the changelog keeps that column order
        results = {n: results[n] for n in sorted(results)}
        self._ensure_host_capacity(int(slots.max()) + 1)
        counts = self._row_counts[slots]
        live = counts > 0
        was_emitted = self._emitted_mask[slots]
        # lazily allocate last-emitted storage from the first result dtypes
        for name, col in results.items():
            if name not in self._last_emitted:
                self._last_emitted[name] = np.zeros(
                    len(self._row_counts), dtype=np.asarray(col).dtype)

        segments: List[Dict[str, np.ndarray]] = []

        def _segment(slot_sel: np.ndarray, kind: int, from_prev: bool):
            if not slot_sel.any():
                return
            sl = slots[slot_sel]
            if from_prev:
                vals = {n: self._last_emitted[n][sl] for n in results}
            else:
                vals = {n: np.asarray(results[n])[slot_sel] for n in results}
            segments.append({
                "slots": sl,
                ROWKIND_FIELD: np.full(len(sl), kind, dtype=np.int8),
                **vals,
            })

        upd = live & was_emitted
        if self.generate_update_before:
            _segment(upd, ROWKIND_UPDATE_BEFORE, from_prev=True)
        _segment(~live & was_emitted, ROWKIND_DELETE, from_prev=True)
        _segment(live & ~was_emitted, ROWKIND_INSERT, from_prev=False)
        _segment(upd, ROWKIND_UPDATE_AFTER, from_prev=False)

        # roll the changelog bookkeeping forward
        for name in results:
            arr = self._last_emitted[name]
            arr[slots[live]] = np.asarray(results[name])[live]
        self._emitted_mask[slots] = live

        if not segments:
            return None
        all_slots = np.concatenate([s.pop("slots") for s in segments])
        kid = self.table.keys_of_slots(all_slots)
        if self._keys_hashed:
            kv = np.array([self._key_values.get(int(i)) for i in kid],
                          dtype=object)
        else:
            kv = kid
        cols: Dict[str, np.ndarray] = {
            KEY_ID_FIELD: kid,
            self.key_field: kv,
            TIMESTAMP_FIELD: np.full(len(all_slots), self._max_ts,
                                     dtype=np.int64),
        }
        for name in segments[0]:
            cols[name] = np.concatenate([s[name] for s in segments])
        return RecordBatch(cols)

    # ------------------------------------------------------------- checkpoint

    def _host_state(self):
        # the changelog bookkeeping is stored LOGICALLY (keyed by key_id,
        # not by physical slot) so snapshots merge across subtasks and
        # restore into any slot layout (key-group re-assignment, multi-slot
        # union — same portability contract as the slot table rows)
        interesting = np.nonzero((self._row_counts != 0)
                                 | self._emitted_mask)[0]
        # minibatch emission state: slots whose change is still pending a
        # watermark flush must survive a restore or their final rows would
        # be silently lost (batch mode defers ALL emission to end-of-input)
        dirty = np.zeros(len(interesting), dtype=bool)
        if self._dirty:
            dirty = np.isin(interesting,
                            np.fromiter(self._dirty, dtype=np.int64))
        cl = {
            "key_id": self.table.keys_of_slots(interesting),
            "count": self._row_counts[interesting],
            "emitted": self._emitted_mask[interesting],
            "dirty": dirty,
            "last": {n: a[interesting]
                     for n, a in self._last_emitted.items()},
        }
        if self.ttl_ms:
            # stamps travel logically so restore resumes each key's
            # REMAINING lifetime (reference: TTL state restores with its
            # original timestamps)
            cl["ttl_last_update"] = self._last_update[interesting]
        return {
            "key_values": dict(self._key_values),
            "keys_hashed": self._keys_hashed,
            "max_ts": self._max_ts,
            "changelog": cl,
        }

    def snapshot_state(self):
        return {"table": self.table.snapshot(), **self._host_state()}

    def snapshot_state_delta(self):
        """Incremental: dirty rows + tombstones only (see
        SlotTable.snapshot_delta)."""
        return {"table": self.table.snapshot_delta(), **self._host_state()}

    def snapshot_state_savepoint(self):
        """Full state without resetting the incremental base."""
        return {"table": self.table.snapshot(reset_dirty=False),
                **self._host_state()}

    def query_state(self, key_value, namespace=None):
        """Queryable-state point lookup (see WindowAggOperator)."""
        from flink_tpu_torch.state.keygroups import hash_keys_to_i64

        key_id = int(hash_keys_to_i64(np.asarray([key_value]))[0])
        return self.table.query(key_id, namespace)

    def restore_state(self, state, key_group_filter=None):
        self.table.restore(state["table"],
                           key_group_filter=key_group_filter)
        self._key_values = dict(state.get("key_values", {}))
        self._keys_hashed = state.get("keys_hashed", False)
        self._max_ts = state.get("max_ts", 0)
        self._row_counts = np.zeros(0, dtype=np.int64)
        self._emitted_mask = np.zeros(0, dtype=bool)
        self._last_update = np.zeros(0, dtype=np.int64)
        self._last_emitted = {}
        cl = state.get("changelog")
        if cl is None or len(np.asarray(cl.get("key_id", ()))) == 0:
            return
        key_ids = np.asarray(cl["key_id"], dtype=np.int64)
        counts = np.asarray(cl["count"], dtype=np.int64)
        emitted = np.asarray(cl["emitted"], dtype=bool)
        dirty = np.asarray(cl.get("dirty", np.zeros(len(key_ids), bool)),
                           dtype=bool)
        if key_group_filter is not None:
            from flink_tpu_torch.state.keygroups import assign_key_groups

            groups = assign_key_groups(key_ids, self.table.max_parallelism)
            keep = np.isin(groups, np.asarray(sorted(key_group_filter)))
            key_ids, counts, emitted, dirty = (
                key_ids[keep], counts[keep], emitted[keep], dirty[keep])
            cl_last = {n: np.asarray(a)[keep]
                       for n, a in cl.get("last", {}).items()}
        else:
            cl_last = {n: np.asarray(a) for n, a in cl.get("last", {}).items()}
        if len(key_ids) == 0:
            return
        # re-key the logical changelog onto this instance's slot layout
        ns = np.full(len(key_ids), _GLOBAL_NS, dtype=np.int64)
        slots = self.table.lookup_or_insert(key_ids, ns)
        self._ensure_host_capacity(int(slots.max()) + 1)
        self._row_counts[slots] = counts
        self._emitted_mask[slots] = emitted
        self._dirty.update(int(s) for s in slots[dirty])
        if self.ttl_ms and "ttl_last_update" in cl:
            stamps = np.asarray(cl["ttl_last_update"], dtype=np.int64)
            if key_group_filter is not None:
                stamps = stamps[keep]
            self._last_update[slots] = stamps
        for n, a in cl_last.items():
            arr = np.zeros(len(self._row_counts), dtype=a.dtype)
            arr[slots] = a
            self._last_emitted[n] = arr
