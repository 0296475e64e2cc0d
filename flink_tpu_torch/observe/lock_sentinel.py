"""Named locks and a runtime lock-order sentinel (port of
``flink_tpu/observe/lock_sentinel.py``, the whole module; host code, no
device work).

The reference pairs it with a static checker (its ``tools/flint``
concurrency rules); the port carries the runtime half. The serving
plane's hot classes (``tenancy/serving.py``, ``tenancy/hot_cache.py``,
``tenancy/hot_cache_native.py``) create their locks through
:func:`named_lock`, and a :class:`LockSentinel` — installed only by
tests — observes every acquisition through those wrappers:

- the **acquisition-order graph** (edge ``A -> B`` whenever a thread
  acquires B while holding A), with a first-witness site per edge;
  an observed cycle raises :class:`LockOrderViolation` in the
  acquiring thread AND is recorded, so a cycle in a daemon thread
  still fails a final :meth:`LockSentinel.check`;
- per-lock **hold and contention** accounting (acquisitions, contended
  acquires, total wait, total/max hold) that a test gates on — a
  lock held across a slow path shows up as a hold-time budget failure
  before it shows up as tail latency.

With no sentinel installed a named lock is one attribute load away
from the bare ``threading`` primitive — the wrapper checks one module
global per acquire — so production paths pay (almost) nothing.

Locks are aggregated BY NAME: every ``LookupCoalescer`` instance's
lock is one ``serving.coalescer`` node. Two *different* objects with
the same name acquired nested therefore record a ``name -> name``
self-edge and trip the cycle check — deliberate: instances of one
class locked in no defined order are exactly the ABBA hazard the
"locks staggered, never nested" discipline exists to prevent.
Reentrant re-acquisition of the SAME object never records an edge.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderViolation",
    "LockSentinel",
    "NamedLock",
    "named_lock",
    "current_sentinel",
]


class LockOrderViolation(RuntimeError):
    """Two lock names were observed acquired in both orders."""


#: the one active sentinel (None in production — the fast path)
_SENTINEL: Optional["LockSentinel"] = None


def current_sentinel() -> Optional["LockSentinel"]:
    return _SENTINEL


def _site(depth: int = 2) -> str:
    """caller file:line, best effort (witness strings only)."""
    try:
        f = sys._getframe(depth)
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except Exception:
        return "?"


class NamedLock:
    """A ``threading.Lock``/``RLock`` with a stable name, observable by
    the installed :class:`LockSentinel`. Context-manager protocol plus
    ``acquire(blocking, timeout)``/``release``/``locked`` — a drop-in
    for the bare primitive at the call sites the package uses."""

    __slots__ = ("name", "reentrant", "_inner")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = _SENTINEL
        if s is None:
            return self._inner.acquire(blocking, timeout)
        return s._acquire(self, blocking, timeout, _site())

    def release(self) -> None:
        s = _SENTINEL
        if s is None:
            self._inner.release()
            return
        s._release(self)

    def locked(self) -> bool:
        # RLock has no .locked() before 3.12; its _is_owned covers the
        # calling thread (a non-blocking probe would reentrantly
        # succeed and report False while held), and a failed probe
        # covers other threads' holds
        inner = self._inner
        if hasattr(inner, "locked"):
            return inner.locked()
        if hasattr(inner, "_is_owned") and inner._is_owned():
            return True
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __enter__(self) -> bool:
        s = _SENTINEL
        if s is None:
            return self._inner.acquire()
        return s._acquire(self, True, -1, _site())

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "RLock" if self.reentrant else "Lock"
        return f"NamedLock({self.name!r}, {kind})"


def named_lock(name: str, reentrant: bool = False) -> NamedLock:
    """The factory the hot classes use instead of ``threading.Lock()``.

    Always returns the wrapper (not conditionally the bare primitive):
    module-scope locks are created at import time, long before any
    sentinel exists, and must still become observable when one is
    installed later.
    """
    return NamedLock(name, reentrant=reentrant)


class _LockStats:
    __slots__ = ("acquisitions", "contended", "wait_s", "hold_s",
                 "hold_max_s")

    def __init__(self):
        self.acquisitions = 0
        self.contended = 0
        self.wait_s = 0.0
        self.hold_s = 0.0
        self.hold_max_s = 0.0


class _Held:
    __slots__ = ("lock", "depth", "t0", "site")

    def __init__(self, lock: NamedLock, t0: float, site: str):
        self.lock = lock
        self.depth = 1
        self.t0 = t0
        self.site = site


class LockSentinel:
    """Observes every :class:`NamedLock` while installed.

    Use as a context manager (``with LockSentinel() as s: ...``) or via
    :meth:`install`/:meth:`uninstall`. :meth:`check` raises on any
    recorded order cycle; :meth:`report` returns the full accounting.
    """

    def __init__(self):
        self._mu = threading.Lock()       # guards graph + stats (leaf)
        self._tls = threading.local()     # per-thread held-lock stack
        self.stats: Dict[str, _LockStats] = {}
        #: name -> {successor name}
        self.edges: Dict[str, set] = {}
        #: (a, b) -> first-witness string
        self.witness: Dict[Tuple[str, str], str] = {}
        #: recorded cycles: (path tuple, human message)
        self.cycles: List[Tuple[Tuple[str, ...], str]] = []

    # ------------------------------------------------------------ install

    def install(self) -> "LockSentinel":
        global _SENTINEL
        if _SENTINEL is not None and _SENTINEL is not self:
            raise RuntimeError("another LockSentinel is already installed")
        _SENTINEL = self
        return self

    def uninstall(self) -> None:
        global _SENTINEL
        if _SENTINEL is self:
            _SENTINEL = None

    def __enter__(self) -> "LockSentinel":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------- observe

    def _stack(self) -> List[_Held]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _acquire(self, lock: NamedLock, blocking: bool, timeout: float,
                 site: str) -> bool:
        stack = self._stack()
        for h in stack:
            if h.lock is lock:       # reentrant re-acquire: no edge,
                ok = lock._inner.acquire(blocking, timeout)  # no wait
                if ok:
                    h.depth += 1
                return ok
        held = [(h.lock.name, h.site) for h in stack]
        if held:
            self._note_edges(held, lock.name, site)
        # contention probe: a failed non-blocking try IS contention
        t0 = time.monotonic()
        ok = lock._inner.acquire(False)
        contended = not ok
        if not ok:
            if not blocking:
                with self._mu:
                    st = self.stats.setdefault(lock.name, _LockStats())
                    st.contended += 1
                return False
            ok = lock._inner.acquire(True, timeout)
        wait = time.monotonic() - t0
        if not ok:
            with self._mu:
                st = self.stats.setdefault(lock.name, _LockStats())
                st.contended += 1
                st.wait_s += wait
            return False
        stack.append(_Held(lock, time.monotonic(), site))
        with self._mu:
            st = self.stats.setdefault(lock.name, _LockStats())
            st.acquisitions += 1
            if contended:
                st.contended += 1
                st.wait_s += wait
        return True

    def _release(self, lock: NamedLock) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            h = stack[i]
            if h.lock is lock:
                h.depth -= 1
                if h.depth == 0:
                    hold = time.monotonic() - h.t0
                    del stack[i]
                    with self._mu:
                        st = self.stats.setdefault(lock.name, _LockStats())
                        st.hold_s += hold
                        st.hold_max_s = max(st.hold_max_s, hold)
                lock._inner.release()
                return
        # not tracked (acquired before install): release pass-through
        lock._inner.release()

    def _note_edges(self, held: List[Tuple[str, str]], dst: str,
                    dst_site: str) -> None:
        cycle_msg = None
        with self._mu:
            for src, src_site in held:
                if src == dst:
                    # same NAME, different object (same object returned
                    # above): undefined intra-name order — a cycle
                    path = (src, dst)
                    msg = (f"lock order cycle: {src} (held at "
                           f"{src_site}) -> {dst} (acquiring at "
                           f"{dst_site}): two instances named "
                           f"{dst!r} nested")
                    self.cycles.append((path, msg))
                    cycle_msg = msg
                    continue
                fresh = dst not in self.edges.get(src, ())
                self.edges.setdefault(src, set()).add(dst)
                self.witness.setdefault(
                    (src, dst),
                    f"{src}@{src_site} -> {dst}@{dst_site} "
                    f"[{threading.current_thread().name}]")
                if fresh:
                    back = self._find_path(dst, src)
                    if back is not None:
                        path = (src,) + tuple(back)
                        msg = self._cycle_message(path)
                        self.cycles.append((path, msg))
                        cycle_msg = msg
        if cycle_msg is not None:
            raise LockOrderViolation(cycle_msg)

    def _find_path(self, a: str, b: str) -> Optional[List[str]]:
        """A path a..b in the edge graph (caller holds _mu)."""
        seen = {a}
        frontier = [[a]]
        while frontier:
            path = frontier.pop()
            last = path[-1]
            if last == b:
                return path
            for nxt in self.edges.get(last, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(path + [nxt])
        return None

    def _cycle_message(self, path: Tuple[str, ...]) -> str:
        legs = []
        for a, b in zip(path, path[1:]):
            legs.append(self.witness.get((a, b), f"{a} -> {b}"))
        legs.append(self.witness.get((path[-1], path[0]),
                                     f"{path[-1]} -> {path[0]}"))
        return ("lock order cycle: " + " / ".join(legs))

    # -------------------------------------------------------------- report

    def contended_locks(self) -> List[str]:
        with self._mu:
            return sorted(n for n, st in self.stats.items()
                          if st.contended > 0)

    def check(self, hold_budget_s: Optional[float] = None) -> None:
        """Raise :class:`LockOrderViolation` on any recorded cycle;
        with ``hold_budget_s``, also raise when any single hold
        exceeded the budget."""
        with self._mu:
            if self.cycles:
                raise LockOrderViolation(self.cycles[0][1])
            if hold_budget_s is not None:
                over = [(n, st.hold_max_s) for n, st in self.stats.items()
                        if st.hold_max_s > hold_budget_s]
                if over:
                    worst = max(over, key=lambda p: p[1])
                    raise LockOrderViolation(
                        f"lock hold budget {hold_budget_s:.3f}s exceeded: "
                        f"{worst[0]} held {worst[1]:.3f}s "
                        f"(all over-budget: {sorted(over)})")

    def report(self) -> Dict[str, object]:
        with self._mu:
            return {
                "locks": {
                    n: {"acquisitions": st.acquisitions,
                        "contended": st.contended,
                        "wait_s": round(st.wait_s, 6),
                        "hold_s": round(st.hold_s, 6),
                        "hold_max_s": round(st.hold_max_s, 6)}
                    for n, st in sorted(self.stats.items())},
                "edges": sorted(
                    [a, b, self.witness.get((a, b), "")]
                    for a, dsts in self.edges.items() for b in dsts),
                "cycles": [{"path": list(p), "message": m}
                           for p, m in self.cycles],
            }
