"""Per-shard and per-key-group load accounting (port of
``flink_tpu/parallel/load.py``): the *detect* stage of the skew ladder
(detect -> rebalance -> split).

- :meth:`ShardLoadAccountant.note_batch` folds routed key columns into
  per-group record counts and a Misra-Gries heavy-hitter sketch (the
  hot-KEY candidates of the split stage);
- :meth:`ShardLoadAccountant.tick` differentiates the counts, and sampled
  per-shard busy seconds and resident rows, into EWMA rates under an
  injectable clock;
- :meth:`ShardLoadAccountant.shard_load` / :meth:`imbalance` project the
  group loads through a ``KeyGroupAssignment``, so a proposed move is
  scored before it happens.

Host NumPy only; the ``skew`` metric group is :meth:`register_metrics`.
:func:`busy_from_flight` is the explicit, coarse bridge to the flight
recorder (its decode walks the whole ring).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.state.keygroups import (
    KeyGroupAssignment,
    assign_key_groups,
)

__all__ = ["ShardLoadAccountant", "busy_from_flight"]


def busy_from_flight(recorder, num_shards: int,
                     kinds: Sequence[str] = ("fire.shard",)) -> np.ndarray:
    """Total busy seconds per shard from a flight recorder's ring.

    O(ring capacity) Python decode — sample this coarsely (once per
    policy tick at most), never per batch."""
    busy = np.zeros(int(num_shards), dtype=np.float64)
    want = frozenset(kinds)
    for rec in recorder.snapshot():
        if rec.kind in want and 0 <= int(rec.shard) < len(busy):
            busy[int(rec.shard)] += max(0.0, float(rec.duration_s))
    return busy


class ShardLoadAccountant:
    """EWMA per-key-group load estimates from routed batches + sampled
    shard gauges. All state is host-side numpy; nothing here touches a
    device."""

    def __init__(self, num_shards: int, max_parallelism: int,
                 key_group_range=None, ewma_alpha: float = 0.3,
                 top_k: int = 16,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if not (0.0 < float(ewma_alpha) <= 1.0):
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.num_shards = int(num_shards)
        self.max_parallelism = int(max_parallelism)
        if key_group_range is None:
            self.first, self.span = 0, self.max_parallelism
        else:
            self.first = int(key_group_range[0])
            self.span = int(key_group_range[1]) - self.first + 1
        self.alpha = float(ewma_alpha)
        self.top_k = int(top_k)
        self.clock = clock if clock is not None else time.monotonic
        # accumulated since last tick
        self._group_counts = np.zeros(self.span, dtype=np.int64)
        self._records_pending = 0
        # EWMA state (None until the first differentiating tick)
        self._group_rate: Optional[np.ndarray] = None
        self._shard_busy_frac: Optional[np.ndarray] = None
        self._shard_resident: Optional[np.ndarray] = None
        self._last_tick: Optional[float] = None
        self.ticks = 0
        self.records_seen = 0
        # Misra-Gries heavy-hitter sketch over key ids
        self._mg: Dict[int, int] = {}

    # ------------------------------------------------------------ ingest

    def note_batch(self, key_ids: np.ndarray) -> None:
        """Fold one routed batch's key column into the running counts."""
        k = np.asarray(key_ids, dtype=np.int64)
        if len(k) == 0:
            return
        groups = assign_key_groups(k, self.max_parallelism)
        local = np.asarray(groups, dtype=np.int64) - self.first
        self._group_counts += np.bincount(local, minlength=self.span)
        self._records_pending += len(k)
        self.records_seen += len(k)
        # Misra-Gries: decrement-all on overflow keeps any key with
        # frequency > N/(top_k+1) in the sketch — enough for "one key
        # dominates its group" detection.
        uk, uc = np.unique(k, return_counts=True)
        mg = self._mg
        for key, cnt in zip(uk.tolist(), uc.tolist()):
            if key in mg:
                mg[key] += cnt
            elif len(mg) < self.top_k:
                mg[key] = cnt
            else:
                dec = min(cnt, min(mg.values()))
                for other in list(mg):
                    mg[other] -= dec
                    if mg[other] <= 0:
                        del mg[other]
                if cnt > dec:
                    mg[key] = cnt - dec

    # ------------------------------------------------------------ ticks

    def tick(self, shard_resident_rows: Sequence[float] = (),
             shard_busy_s: Sequence[float] = ()) -> None:
        """Differentiate accumulated counts into EWMA rates.

        ``shard_resident_rows``: the ``state`` gauge sample (rows per
        shard). ``shard_busy_s``: cumulative-or-sampled busy seconds per
        shard (e.g. from :func:`busy_from_flight`); normalized by the
        tick interval into a busy fraction."""
        now = float(self.clock())
        dt = None if self._last_tick is None else max(1e-9, now - self._last_tick)
        self._last_tick = now
        self.ticks += 1
        if dt is not None:
            rate = self._group_counts / dt
            if self._group_rate is None:
                self._group_rate = rate
            else:
                self._group_rate += self.alpha * (rate - self._group_rate)
            if len(shard_busy_s):
                frac = np.asarray(shard_busy_s, dtype=np.float64) / dt
                if self._shard_busy_frac is None or \
                        len(self._shard_busy_frac) != len(frac):
                    self._shard_busy_frac = frac
                else:
                    self._shard_busy_frac += self.alpha * (
                        frac - self._shard_busy_frac)
        self._group_counts[:] = 0
        self._records_pending = 0
        if len(shard_resident_rows):
            res = np.asarray(shard_resident_rows, dtype=np.float64)
            if self._shard_resident is None or \
                    len(self._shard_resident) != len(res):
                self._shard_resident = res
            else:
                self._shard_resident += self.alpha * (
                    res - self._shard_resident)

    # ------------------------------------------------------------ queries

    def group_load(self) -> np.ndarray:
        """EWMA records/sec per LOCAL key group (len == span). Before the
        first differentiating tick, falls back to the raw pending counts
        (so a single-batch smoke still sees shape)."""
        if self._group_rate is not None:
            return self._group_rate.copy()
        return self._group_counts.astype(np.float64)

    def shard_load(self, assignment: Optional[KeyGroupAssignment] = None
                   ) -> np.ndarray:
        """Group loads projected onto shards through ``assignment``
        (default: the contiguous layout)."""
        if assignment is None:
            assignment = KeyGroupAssignment.contiguous(
                self.num_shards, self.max_parallelism,
                None if (self.first == 0 and
                         self.span == self.max_parallelism)
                else (self.first, self.first + self.span - 1))
        shards = assignment.table
        return np.bincount(shards, weights=self.group_load(),
                           minlength=self.num_shards)

    def imbalance(self, assignment: Optional[KeyGroupAssignment] = None
                  ) -> float:
        """max-shard-load * P / total — same definition the autoscale
        skew guard pins (1.0 == perfectly balanced)."""
        loads = self.shard_load(assignment)
        total = float(loads.sum())
        if total <= 0.0:
            return 1.0
        return float(loads.max()) * len(loads) / total

    def hot_key_candidates(self) -> List[Tuple[int, int, float]]:
        """``(key_id, global_group, share_of_group)`` for sketched heavy
        hitters, hottest first. ``share_of_group`` ~ the fraction of the
        key's group's load this single key carries — the split-stage
        trigger signal."""
        if not self._mg:
            return []
        gl = self.group_load()
        out = []
        keys = np.fromiter(self._mg.keys(), dtype=np.int64,
                           count=len(self._mg))
        groups = assign_key_groups(keys, self.max_parallelism)
        total = max(1, self.records_seen)
        for key, grp in zip(keys.tolist(),
                            np.asarray(groups, dtype=np.int64).tolist()):
            cnt = self._mg[key]
            g_local = grp - self.first
            g_load = float(gl[g_local]) if 0 <= g_local < self.span else 0.0
            # MG counts are over the whole run; group rate is per-second.
            # Compare like with like: the key's share of ALL records vs
            # the group's share of the total rate.
            key_share = cnt / total
            g_total = float(gl.sum())
            g_share = g_load / g_total if g_total > 0 else 0.0
            share = key_share / g_share if g_share > 0 else 0.0
            out.append((int(key), int(grp), float(min(1.0, share))))
        out.sort(key=lambda t: -t[2])
        return out

    def hottest_group(self) -> int:
        """GLOBAL id of the currently hottest key group."""
        return int(np.argmax(self.group_load())) + self.first

    # ------------------------------------------------------------ metrics

    def register_metrics(self, group) -> None:
        g = group.add_group("skew")
        g.gauge("imbalance", lambda: self.imbalance())
        g.gauge("hottest_group", self.hottest_group)
        g.gauge("hottest_shard",
                lambda: int(np.argmax(self.shard_load())))
        g.gauge("records_seen", lambda: self.records_seen)
        g.gauge("ticks", lambda: self.ticks)
        g.gauge("hot_key_count", lambda: len(self._mg))
