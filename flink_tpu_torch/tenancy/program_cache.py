"""Shared program cache: one family of steps for N jobs (port of
``flink_tpu/tenancy/program_cache.py``).

The reference caches compiled XLA programs, keyed on WHAT they compute —
``(program kind, device ids, aggregate layout)`` — never on WHO runs
them, so job K+1 on a warm cluster pays zero compiles. The port's steps
are eager PyTorch closures (and the two hand-written kernels are built
once per process by ``stateplane/cuda_build.py``), so there is nothing
to compile per job: this cache holds what each build
function returns — the step
closures of a ``(kind, key)`` — and the reference's "zero XLA compiles on
a warm cluster" has no counterpart here. No compile counter is kept; the
per-job hit/miss stats say whether job K+1 reused job K's closures (a
warm cluster's fresh jobs show ``misses == 0``).

Sites routed through it (kinds): ``mesh-steps`` and ``delta-fire``
(``parallel/sharded_windower.py``), ``session-merge``
(``parallel/sharded_sessions.py``), ``exchange-scatter``
(``parallel/shuffle.py``) and ``replica-pub`` (``tenancy/replica.py``).
The reference's other kinds name programs whose port counterparts are
plain functions over tensors that build nothing — the flat families
(``gather``, ``scatter-combine``, ``segment-reduce``, ``evict-cohort``,
``snapshot-lift``, ``delta-harvest``; ``ops/segment_ops.py``,
``stateplane/pane.py``), ``exchange-rank`` (``stateplane/rank.py``, whose
kernel is built once per process), the joins' ``join-*`` programs
(``joins/kernels.py``) and CEP's ``cep-*`` (``cep/kernels.py``) — so
they have nothing to cache. The two-level exchange's families
(``exchange2-stage1``/``-stage2`` and the joins' ``join-exchange2-*``,
``parallel/exchange2.py``) are cached like ``exchange-scatter``; the pod
route (``parallel/pod.py``) builds nothing and is not cached.

Job attribution is per thread: the session cluster brackets each job's
scheduling quantum with :meth:`SharedProgramCache.job_scope`. No engine
imports here: the cache is importable from the lowest layers without
cycles.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from flink_tpu_torch.observe.lock_sentinel import named_lock


class SharedProgramCache:
    """Process-global registry of built program families.

    ``get_or_build(kind, key, build)`` returns the cached program for
    ``(kind, key)`` or builds, stores and returns it. ``key`` must be
    hashable and must identify everything the built steps close
    over (device ids, aggregate layout) — and nothing else.

    Job attribution is cooperative: the tenancy session cluster brackets
    each job's scheduling quantum with :meth:`job_scope`, so any program
    built (or hit) inside it is charged to that job. Outside a scope,
    traffic lands on the ``None`` job (single-job runs). The scope is
    PER THREAD (a MiniCluster runs each job's executor on its own
    thread), and the at-most-once build contract holds across threads:
    two jobs racing to the same key cost one build, not two — the
    loser waits on the winner's per-key latch (the stall is exactly the
    build the cache saved it), while traffic for other keys proceeds
    unstalled.
    """

    def __init__(self) -> None:
        #: the raw storage — exposed for compatibility shims only
        self.programs: Dict[Tuple[str, Any], Any] = {}
        self._tls = threading.local()
        #: one lock for storage + stats: hits hold it for a dict probe;
        #: BUILDS run outside it behind a per-key once-latch (holding
        #: the cache lock across a build would stall every other
        #: thread's unrelated cache hits)
        self._lock = named_lock("tenancy.program_cache", reentrant=True)
        #: key -> Event for builds in flight (see get_or_build)
        self._building: Dict[Tuple[str, Any], threading.Event] = {}
        #: job -> {"hits": n, "misses": n}
        self._job_stats: Dict[Optional[str], Dict[str, int]] = {}

    # ------------------------------------------------------------ attribution

    @property
    def _job(self) -> Optional[str]:
        return getattr(self._tls, "job", None)

    def set_current_job(self, job: Optional[str]) -> Optional[str]:
        """Set the job charged for subsequent cache traffic ON THIS
        THREAD; returns the previous value (for restore)."""
        prev = getattr(self._tls, "job", None)
        self._tls.job = job
        return prev

    def job_scope(self, job: Optional[str]):
        """Context manager form of :meth:`set_current_job`."""
        import contextlib

        @contextlib.contextmanager
        def _scope():
            prev = self.set_current_job(job)
            try:
                yield self
            finally:
                self.set_current_job(prev)

        return _scope()

    def _charge(self, field: str) -> None:
        st = self._job_stats.setdefault(self._job,
                                        {"hits": 0, "misses": 0})
        st[field] += 1

    # ----------------------------------------------------------------- lookup

    def get_or_build(self, kind: str, key: Any,
                     build: Callable[[], Any]) -> Any:
        """The cached program family for ``(kind, key)``, building it on
        first use. The build function runs at most once per key for the process
        lifetime — restarted jobs, rescaled engines, NEW JOBS, and
        concurrent executor threads all hit. Two threads racing the SAME
        key cost one build (the loser waits on the winner's latch and
        takes the cached result); a thread hitting a DIFFERENT key is
        never stalled by an in-flight build — the build runs outside
        the cache lock. A failed build releases its latch so the next
        caller retries."""
        full = (kind, key)
        while True:
            with self._lock:
                cached = self.programs.get(full)
                if cached is not None:
                    self._charge("hits")
                    return cached
                latch = self._building.get(full)
                if latch is None:
                    self._building[full] = latch = threading.Event()
                    self._charge("misses")
                    break
            # another thread is compiling this key: wait, then re-probe
            # (on its failure this thread builds next)
            latch.wait()
        try:
            built = build()
        except BaseException:
            # latch protocol: the thread that
            # installed the latch above is its sole owner; no other
            # thread deletes this key's latch, so the boundary is safe
            with self._lock:
                del self._building[full]
            latch.set()
            raise
        # latch protocol: this thread won the
        # build election under the first hold and is the only writer
        # of this key until it sets the latch; waiters re-probe in the
        # while-loop, so the release boundary cannot lose an update
        with self._lock:
            self.programs[full] = built
            del self._building[full]
        latch.set()
        return built

    # ------------------------------------------------------------------ stats

    def stats(self) -> Dict[str, int]:
        with self._lock:
            hits = sum(s["hits"] for s in self._job_stats.values())
            misses = sum(s["misses"] for s in self._job_stats.values())
            return {"programs": len(self.programs),
                    "hits": hits, "misses": misses}

    def stat(self, field: str) -> int:
        """One stats() field without computing the others — what the
        per-scrape gauges read."""
        with self._lock:
            if field == "programs":
                return len(self.programs)
            return sum(s[field] for s in self._job_stats.values())

    def stats_for(self, job: Optional[str]) -> Dict[str, int]:
        """Per-job cache traffic ({"hits": n, "misses": n}); zeros for a
        job that never touched the cache."""
        with self._lock:
            return dict(self._job_stats.get(job,
                                            {"hits": 0, "misses": 0}))

    def reset_stats(self) -> None:
        """Clear attribution counters (NOT the programs — built
        steps stay shared; tests reset between phases)."""
        with self._lock:
            self._job_stats.clear()


#: THE process-global instance every engine routes through.
PROGRAM_CACHE = SharedProgramCache()
