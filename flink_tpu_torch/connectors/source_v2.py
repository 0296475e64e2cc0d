"""Split-based source framework — the FLIP-27 model (port of
``flink_tpu/connectors/source_v2.py``).

reference: runtime/source/coordinator/SourceCoordinator.java (enumerator on
the JobMaster, split assignment via RPC events, watermark alignment params
at :106), streaming/api/operators/SourceOperator.java (reader on the task),
flink-connector-base split-reader infra, and the continuous file discovery
of the FileSource connector.

Re-design for the batched engine:

- A *split* is a unit of parallelizable input (one file, one partition).
- The *enumerator* discovers splits (incrementally for unbounded sources —
  continuous directory monitoring).
- A *split reader* IS a plain ``Source`` (open/poll_batch/snapshot_position)
  created per split by a factory — reusing the one source contract end to
  end instead of a second reader SPI.
- The *coordinator* owns the enumerator and deals splits to parallel
  subtasks round-robin; each ``SplitSource`` instance (one per subtask)
  reads only its assigned splits.
- *Watermark alignment*: a split whose local max timestamp runs more than
  ``alignment_max_drift_ms`` ahead of the slowest unfinished split is
  paused (its poll is skipped) until the others catch up — the reference
  pauses SourceReader splits the same way (SourceCoordinator.java:106
  watermarkAlignmentParams + pauseOrResumeSplits).
- *Idleness*: a split with no data for ``idle_timeout_ms`` (wall clock) is
  excluded from the source watermark so it cannot hold back event time
  (reference: WatermarkStrategy.withIdleness).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.connectors.sources import Source
from flink_tpu_torch.runtime.elements import MIN_WATERMARK
from flink_tpu_torch.runtime.watermarks import WatermarkGenerator, WatermarkStrategy


@dataclasses.dataclass(frozen=True)
class SourceSplit:
    split_id: str
    payload: Any = None


class SplitEnumerator:
    """Discovers splits. ``discover()`` returns only NEW splits since the
    previous call (the reference's enumerator sends incremental
    assignments). ``bounded`` declares whether discovery ever finishes.
    ``reset()`` forgets the discovery state so a RE-opened source replays
    the whole stream (part of the contract: SplitSource.open calls it on
    re-execution; restore_state then wins on recovery)."""

    bounded: bool = True

    def discover(self) -> List[SourceSplit]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} must implement reset() so a "
            "re-executed graph replays its splits")

    def snapshot_state(self) -> Dict[str, Any]:
        return {}

    def restore_state(self, state: Dict[str, Any]) -> None:
        pass


class FileSplitEnumerator(SplitEnumerator):
    """One split per file matching a glob pattern; unbounded mode keeps
    discovering files that appear later (reference: FileSource continuous
    monitoring mode)."""

    def __init__(self, pattern: str, bounded: bool = True):
        self.pattern = pattern
        self.bounded = bounded
        self._seen: set = set()

    def discover(self) -> List[SourceSplit]:
        new = []
        for path in sorted(_glob.glob(self.pattern)):
            if path not in self._seen:
                self._seen.add(path)
                new.append(SourceSplit(split_id=path, payload=path))
        return new

    def reset(self) -> None:
        self._seen.clear()

    def snapshot_state(self):
        return {"seen": sorted(self._seen)}

    def restore_state(self, state):
        self._seen = set(state["seen"])


class SourceCoordinator:
    """Assigns splits to parallel subtasks round-robin, sticky per split
    (reference: SourceCoordinator split assignment; sticky so a restore
    re-reads a split on the same subtask)."""

    def __init__(self, parallelism: int):
        self.parallelism = max(int(parallelism), 1)
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def reset(self, parallelism: int) -> None:
        """Re-open of the owning source: forget sticky assignments and
        adopt the NEW parallelism so splits rebalance — in place, so an
        injected custom coordinator keeps its construction-time
        configuration."""
        self.parallelism = max(int(parallelism), 1)
        self._assignment.clear()
        self._next = 0

    def assign(self, splits: Sequence[SourceSplit]) -> Dict[str, int]:
        for s in splits:
            if s.split_id not in self._assignment:
                self._assignment[s.split_id] = self._next % self.parallelism
                self._next += 1
        return dict(self._assignment)

    def splits_for(self, subtask: int,
                   splits: Sequence[SourceSplit]) -> List[SourceSplit]:
        self.assign(splits)
        return [s for s in splits if self._assignment[s.split_id] == subtask]

    def snapshot_state(self):
        return {"assignment": dict(self._assignment), "next": self._next}

    def restore_state(self, state):
        self._assignment = dict(state["assignment"])
        self._next = state["next"]


class _SplitState:
    __slots__ = ("split", "reader", "finished", "max_ts", "last_data_wall",
                 "idle", "records")

    def __init__(self, split: SourceSplit, reader: Source):
        self.split = split
        self.reader = reader
        self.finished = False
        self.max_ts = MIN_WATERMARK
        self.last_data_wall = _time.monotonic()
        self.idle = False
        self.records = 0


class SplitSource(Source):
    """Adapter: (enumerator, reader_factory) -> the framework's Source
    contract, with alignment/idleness/checkpointing.

    ``reader_factory(split)`` returns a Source reading that one split.
    """

    def __init__(self, enumerator: SplitEnumerator,
                 reader_factory: Callable[[SourceSplit], Source],
                 timestamp_field: Optional[str] = None,
                 alignment_max_drift_ms: Optional[int] = None,
                 idle_timeout_ms: Optional[int] = None,
                 coordinator: Optional[SourceCoordinator] = None,
                 clock: Callable[[], float] = _time.monotonic):
        self.enumerator = enumerator
        self.reader_factory = reader_factory
        self.timestamp_field = timestamp_field
        self.max_drift = alignment_max_drift_ms
        self.idle_timeout = idle_timeout_ms
        self.coordinator = coordinator
        self.clock = clock
        self.bounded = enumerator.bounded
        self._states: Dict[str, _SplitState] = {}
        self._order: List[str] = []
        self._rr = 0
        self._subtask = 0
        self._parallelism = 1
        self._opened = False
        self._parked_restore: Optional[Dict[str, Any]] = None

    # -- lifecycle -----------------------------------------------------------

    def open(self, subtask_index: int = 0, parallelism: int = 1) -> None:
        self._subtask = subtask_index
        self._parallelism = parallelism
        if self.coordinator is None:
            self.coordinator = SourceCoordinator(parallelism)
        if self._opened:
            # RE-execution of the same graph (a registered table view
            # queried twice, a restarted job): the framework-wide
            # contract is that open() resets position so the stream
            # replays (see connectors/sources.py) — the enumerator and
            # per-split readers must start over, not resume the previous
            # run's consumed state (restore_position, applied below,
            # then wins on recovery). The coordinator is rebuilt at the
            # NEW parallelism so splits rebalance (its own documented
            # contract), and the previous run's unfinished readers close
            # first (same discipline as _apply_restore).
            self.enumerator.reset()
            for st in self._states.values():
                if st.reader is not None and not st.finished:
                    st.reader.close()
            self._states.clear()
            self._order.clear()
            self._rr = 0
            self.coordinator.reset(parallelism)
        self._opened = True
        if self._parked_restore is not None:
            self._apply_restore(self._parked_restore)
            self._parked_restore = None
        else:
            self._discover()

    def _add_split(self, split: SourceSplit,
                   reader_pos: Optional[Dict[str, Any]] = None,
                   finished: bool = False,
                   max_ts: int = MIN_WATERMARK) -> None:
        if finished:
            st = _SplitState(split, reader=None)
            st.finished = True
        else:
            reader = self.reader_factory(split)
            # open BEFORE restore: the framework-wide ordering contract is
            # open() (re)initializes position, restore_position() then
            # wins on recovery (sources reset in open so re-executed
            # graphs replay — see connectors/sources.py)
            reader.open(self._subtask, self._parallelism)
            if reader_pos is not None:
                reader.restore_position(reader_pos)
            st = _SplitState(split, reader)
        st.last_data_wall = self.clock()
        st.max_ts = max_ts
        self._states[split.split_id] = st
        self._order.append(split.split_id)

    def _discover(self) -> None:
        new = self.enumerator.discover()
        if not new:
            return
        for split in self.coordinator.splits_for(self._subtask, new):
            self._add_split(split)

    # -- alignment / idleness -----------------------------------------------

    def _unfinished(self) -> List[_SplitState]:
        return [s for s in self._states.values() if not s.finished]

    def _paused_by_alignment(self, st: _SplitState) -> bool:
        if self.max_drift is None:
            return False
        others = [s.max_ts for s in self._unfinished()
                  if s is not st and not s.idle]
        if not others:
            return False
        slowest = min(others)
        if slowest == MIN_WATERMARK:
            # peers that have produced nothing yet can't define drift
            return False
        return st.max_ts > slowest + self.max_drift

    def _update_idleness(self) -> None:
        if self.idle_timeout is None:
            return
        now = self.clock()
        for st in self._unfinished():
            st.idle = (now - st.last_data_wall) * 1000.0 >= self.idle_timeout

    # -- polling -------------------------------------------------------------

    def poll_batch(self, max_records: int) -> Optional[RecordBatch]:
        self._update_idleness()
        n = len(self._order)
        for attempt in range(max(n, 1)):
            if not self._order:
                break
            sid = self._order[self._rr % len(self._order)]
            self._rr += 1
            st = self._states[sid]
            if st.finished or self._paused_by_alignment(st):
                continue
            batch = st.reader.poll_batch(max_records)
            if batch is None:
                if self.enumerator.bounded or getattr(
                        st.reader, "bounded", True):
                    st.finished = True
                    st.reader.close()
                continue
            if len(batch) == 0:
                continue
            st.last_data_wall = self.clock()
            st.idle = False
            st.records += len(batch)
            if self.timestamp_field is not None:
                batch = batch.with_timestamps(
                    np.asarray(batch[self.timestamp_field], dtype=np.int64))
            if batch.has_timestamps:
                st.max_ts = max(st.max_ts, int(batch.timestamps.max()))
            return batch
        # nothing produced this round: rediscover (unbounded), maybe done
        if not self.enumerator.bounded:
            self._discover()
            return RecordBatch({})  # unbounded: never signal end-of-input
        if all(s.finished for s in self._states.values()):
            self._discover()  # late files between discover and finish
            if all(s.finished for s in self._states.values()):
                return None
        return RecordBatch({})

    def close(self) -> None:
        for st in self._states.values():
            if not st.finished:
                st.reader.close()

    # -- per-split watermark -------------------------------------------------

    def current_watermark(self, out_of_orderness_ms: int = 0) -> Optional[int]:
        """Min over unfinished, non-idle splits of (max_ts - delay) — the
        per-split min-merge the reference does inside SourceOperator."""
        active = [s for s in self._unfinished() if not s.idle]
        if not active:
            # all finished or idle: the max over everything seen
            seen = [s.max_ts for s in self._states.values()]
            return (max(seen) - out_of_orderness_ms - 1) if seen else None
        m = min(s.max_ts for s in active)
        if m == MIN_WATERMARK:
            return None
        return m - out_of_orderness_ms - 1

    def watermark_strategy(self, out_of_orderness_ms: int = 0,
                           ) -> WatermarkStrategy:
        """A WatermarkStrategy wired to per-split progress."""
        source = self

        class _SplitAware(WatermarkGenerator):
            def on_batch(self, batch):
                return source.current_watermark(out_of_orderness_ms)

        return WatermarkStrategy(_SplitAware,
                                 timestamp_field=None)

    # -- checkpoint ----------------------------------------------------------

    def snapshot_position(self) -> Dict[str, Any]:
        """The snapshot carries the split payloads themselves, so restore can
        rebuild readers without re-running discovery (sticky assignment
        preserved via the coordinator state)."""
        return {
            "enumerator": self.enumerator.snapshot_state(),
            "coordinator": self.coordinator.snapshot_state()
            if self.coordinator else {},
            "splits": {
                sid: {"payload": st.split.payload,
                      "finished": st.finished, "max_ts": st.max_ts,
                      "reader": (st.reader.snapshot_position()
                                 if st.reader is not None else {})}
                for sid, st in self._states.items()
            },
        }

    def restore_position(self, pos: Dict[str, Any]) -> None:
        if self._opened:
            self._apply_restore(pos)
        else:
            self._parked_restore = pos

    def _apply_restore(self, pos: Dict[str, Any]) -> None:
        for st in self._states.values():
            if st.reader is not None and not st.finished:
                st.reader.close()
        self._states.clear()
        self._order.clear()
        self._rr = 0
        self.enumerator.restore_state(pos["enumerator"])
        if self.coordinator is not None and pos.get("coordinator"):
            self.coordinator.restore_state(pos["coordinator"])
        for sid, s in pos["splits"].items():
            self._add_split(SourceSplit(sid, s["payload"]),
                            reader_pos=s["reader"] or None,
                            finished=s["finished"], max_ts=s["max_ts"])
        self._discover()  # splits that appeared after the snapshot


def file_source(pattern: str, bounded: bool = True,
                reader_factory: Optional[Callable] = None,
                timestamp_field: Optional[str] = None,
                **kwargs) -> SplitSource:
    """Directory/glob source over binary batch files (default) or a custom
    per-file reader (reference: FileSource builder)."""
    if reader_factory is None:
        from flink_tpu_torch.connectors.sources import BinaryFileSource

        reader_factory = lambda split: BinaryFileSource(split.payload)  # noqa: E731
    return SplitSource(FileSplitEnumerator(pattern, bounded=bounded),
                       reader_factory, timestamp_field=timestamp_field,
                       **kwargs)
