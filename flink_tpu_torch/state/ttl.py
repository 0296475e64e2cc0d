"""State time-to-live (port of ``flink_tpu/state/ttl.py``).

TTL is a last-access int64 column per state, one stamp per slot next to
the dense values; reads and sweeps are vectorized masks
(``now - stamps > ttl``). The time characteristic is processing time,
from an injectable clock. ``StateTtlConfig`` and its builder follow
Flink's (``UpdateType`` OnCreateAndWrite / OnReadAndWrite,
``StateVisibility`` NeverReturnExpired / ReturnExpiredIfNotCleanedUp).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from flink_tpu_torch.core.annotations import public

#: UpdateType — which accesses refresh the entry's lifetime
ON_CREATE_AND_WRITE = "OnCreateAndWrite"
ON_READ_AND_WRITE = "OnReadAndWrite"

#: StateVisibility — what an expired-but-not-yet-swept read returns
NEVER_RETURN_EXPIRED = "NeverReturnExpired"
RETURN_EXPIRED_IF_NOT_CLEANED_UP = "ReturnExpiredIfNotCleanedUp"


def default_clock() -> int:
    """Processing-time now, epoch millis."""
    return int(time.time() * 1000)


@public
@dataclasses.dataclass(frozen=True)
class StateTtlConfig:
    """TTL policy for one state (reference: StateTtlConfig builder).

    ``ttl_ms``        — entry lifetime since its last qualifying access.
    ``update_type``   — ON_CREATE_AND_WRITE (writes refresh; default) or
                        ON_READ_AND_WRITE (reads refresh too).
    ``visibility``    — NEVER_RETURN_EXPIRED (default; an expired entry
                        reads as absent even before cleanup) or
                        RETURN_EXPIRED_IF_NOT_CLEANED_UP.
    """

    ttl_ms: int
    update_type: str = ON_CREATE_AND_WRITE
    visibility: str = NEVER_RETURN_EXPIRED

    def __post_init__(self):
        if self.ttl_ms <= 0:
            raise ValueError("ttl_ms must be positive")
        if self.update_type not in (ON_CREATE_AND_WRITE,
                                    ON_READ_AND_WRITE):
            raise ValueError(f"unknown update_type {self.update_type!r}")
        if self.visibility not in (NEVER_RETURN_EXPIRED,
                                   RETURN_EXPIRED_IF_NOT_CLEANED_UP):
            raise ValueError(f"unknown visibility {self.visibility!r}")

    @staticmethod
    def new_builder(ttl_ms: int) -> "TtlConfigBuilder":
        return TtlConfigBuilder(ttl_ms)


class TtlConfigBuilder:
    """Fluent construction mirroring the reference's builder API."""

    def __init__(self, ttl_ms: int):
        self._ttl_ms = ttl_ms
        self._update = ON_CREATE_AND_WRITE
        self._visibility = NEVER_RETURN_EXPIRED

    def set_update_type(self, update_type: str) -> "TtlConfigBuilder":
        self._update = update_type
        return self

    def update_ttl_on_read_and_write(self) -> "TtlConfigBuilder":
        self._update = ON_READ_AND_WRITE
        return self

    def set_state_visibility(self, visibility: str) -> "TtlConfigBuilder":
        self._visibility = visibility
        return self

    def return_expired_if_not_cleaned_up(self) -> "TtlConfigBuilder":
        self._visibility = RETURN_EXPIRED_IF_NOT_CLEANED_UP
        return self

    def build(self) -> StateTtlConfig:
        return StateTtlConfig(self._ttl_ms, self._update, self._visibility)


#: stamp value meaning "no entry" (never written / swept away)
NO_STAMP = np.int64(-1)


class SweepGate:
    """Shared cadence for interval-gated TTL sweeps: fire at most every
    ttl/4 (floor 1 ms) so the vectorized scan amortizes across batches.
    Used by every operator that sweeps (GroupAgg, upsert materializer)."""

    def __init__(self, ttl_ms: int):
        self.ttl_ms = ttl_ms
        self._last = 0

    def should_sweep(self, now_ms: int) -> bool:
        if now_ms - self._last < max(self.ttl_ms // 4, 1):
            return False
        self._last = now_ms
        return True


class TtlStamps:
    """Per-slot last-access column for one dense state.

    Vectorized counterpart of the reference's TtlValue timestamps: one
    int64 per slot, ``NO_STAMP`` where the entry is absent."""

    def __init__(self, capacity: int, cfg: StateTtlConfig):
        self.cfg = cfg
        self.stamps = np.full(capacity, NO_STAMP, dtype=np.int64)

    def grow(self, old: int, new: int) -> None:
        grown = np.full(new, NO_STAMP, dtype=np.int64)
        grown[:old] = self.stamps
        self.stamps = grown

    def touch(self, slots: np.ndarray, now_ms: int) -> None:
        self.stamps[slots] = now_ms

    def touch_on_read(self, slots: np.ndarray, now_ms: int) -> None:
        if self.cfg.update_type == ON_READ_AND_WRITE:
            # only refresh entries that still exist and are not expired
            # (reading an expired entry must not resurrect it)
            s = self.stamps[slots]
            live = (s != NO_STAMP) & (now_ms - s <= self.cfg.ttl_ms)
            self.stamps[slots[live]] = now_ms

    def expired_mask(self, slots: np.ndarray, now_ms: int) -> np.ndarray:
        """True where the entry exists but its lifetime has passed."""
        s = self.stamps[slots]
        return (s != NO_STAMP) & (now_ms - s > self.cfg.ttl_ms)

    def hidden_mask(self, slots: np.ndarray, now_ms: int) -> np.ndarray:
        """True where a READ must pretend the entry is absent."""
        if self.cfg.visibility == RETURN_EXPIRED_IF_NOT_CLEANED_UP:
            return np.zeros(len(slots), dtype=bool)
        return self.expired_mask(slots, now_ms)

    def sweep(self, now_ms: int) -> np.ndarray:
        """All expired slots (for cleanup); resets their stamps."""
        expired = np.nonzero(
            (self.stamps != NO_STAMP)
            & (now_ms - self.stamps > self.cfg.ttl_ms))[0]
        self.stamps[expired] = NO_STAMP
        return expired

    def clear(self, slots: np.ndarray) -> None:
        self.stamps[slots] = NO_STAMP

    def snapshot(self) -> np.ndarray:
        return self.stamps.copy()

    def restore(self, snap: np.ndarray, slot_remap=None) -> None:
        snap = np.asarray(snap, dtype=np.int64)
        if slot_remap is not None:
            self.stamps[slot_remap[1]] = snap[slot_remap[0]]
        else:
            self.stamps[: len(snap)] = snap
