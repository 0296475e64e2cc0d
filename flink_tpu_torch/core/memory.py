"""Managed device-memory accounting across operators.

reference: flink-runtime/src/main/java/org/apache/flink/runtime/memory/
MemoryManager.java — the per-slot managed-memory pool batch/streaming
operators reserve pages from (RocksDB blocks, sort buffers, hash tables),
sized by ``taskmanager.memory.managed.size``; exhaustion fails the
reservation with the pool breakdown rather than OOM-killing the process.

Re-design: the unit is BYTES of device (HBM) accumulator state, not
32 KiB host segments — slot tables and pane rings reserve their array
footprint at creation and each growth, and release on dispose. One pool
per executor run covers every operator in the job, so a second windowed
aggregation can no longer silently push the first one's growth into an
opaque XLA allocation failure: the reservation error names every owner
and its bytes, and points at the spill tier as the pressure valve.
"""

from __future__ import annotations

import threading
from typing import Dict


class MemoryReservationError(RuntimeError):
    """A reservation would exceed the managed device budget."""


class MemoryManager:
    """Thread-safe byte-granular reservation pool (0 = unlimited)."""

    def __init__(self, budget_bytes: int = 0):
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._owners: Dict[str, int] = {}

    @property
    def reserved_bytes(self) -> int:
        with self._lock:
            return sum(self._owners.values())

    def usage(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._owners)

    def reserve(self, owner: str, nbytes: int) -> None:
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._lock:
            total = sum(self._owners.values())
            if self.budget_bytes and total + nbytes > self.budget_bytes:
                breakdown = ", ".join(
                    f"{o}={b:,}B" for o, b in sorted(
                        self._owners.items(), key=lambda kv: -kv[1]))
                raise MemoryReservationError(
                    f"managed device memory exhausted: {owner!r} asked "
                    f"for {nbytes:,}B but only "
                    f"{self.budget_bytes - total:,}B of the "
                    f"{self.budget_bytes:,}B budget "
                    f"(memory.device.size) remain. Reserved: "
                    f"[{breakdown or 'none'}]. Lower "
                    "state.slot-table.capacity, enable the spill tier "
                    "(state.slot-table.max-device-slots), or raise the "
                    "budget")
            self._owners[owner] = self._owners.get(owner, 0) + nbytes

    def release(self, owner: str, nbytes: int) -> None:
        with self._lock:
            cur = self._owners.get(owner, 0)
            left = cur - int(nbytes)
            if left > 0:
                self._owners[owner] = left
            else:
                self._owners.pop(owner, None)

    def release_all(self, owner: str) -> int:
        with self._lock:
            return self._owners.pop(owner, 0)
