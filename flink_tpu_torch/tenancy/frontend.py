"""Multi-process serving tier: frontend processes over the shared-memory
hot cache (port of ``flink_tpu/tenancy/frontend.py``; host code).

Past one process the serving clients starve the publish loop, so the
next factor needs more cores, not a faster probe. This module is that
factor, split by role:

- the OWNER process keeps ingest and publish/prime
  (``ServingPlane`` with a shm-backed ``NativeHotRowCache``, ``shm_dir``
  armed), and stays the table's ONLY writer;
- N FRONTEND processes (:class:`FrontendPool`) attach the same arenas
  (``FrontendCacheClient``) and serve the hit path entirely in their own
  process: probe -> packed reply, no lock, no GIL shared with the owner,
  no IPC per hit;
- cold misses CROSS to the owner on a per-frontend pipe and resolve
  through the owner's ``lookup_batch`` (the replica worker path), so
  frontends serve the same sealed generations the owner primes.

The frontends need no locks because the seqlock probe protocol is
address-free (``native/hotcache.cpp``): a torn read retries then falls to
the miss path, in another process exactly as in another thread.

Frontends are SPAWNED, never forked: the owner holds a CUDA context and
serving threads a forked child must not inherit. The child's import path
(this module, ``hot_cache_native``, ``state/keygroups.py``) imports torch
but never initialises CUDA.

Failure domain: a frontend dying mid-burst must not hurt the owner or its
siblings. ``lookup_batch`` detects the dead pipe and RETRIES the request
on a live sibling; with none left it fails fast. The ``serving.frontend``
chaos point injects exactly that death at the dispatch site (its ``drop``
kind kills the chosen frontend process).

:class:`LookupRouter` splits a key batch by the host that owns each key's
key-group range (under the live ``KeyGroupAssignment`` after a rebalance)
and sends each part to that host's lookup entry point.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.observe.lock_sentinel import named_lock

#: default seconds a dispatched request may wait before the frontend is
#: declared dead and the request retries on a sibling
REQUEST_TIMEOUT_S = 30.0


# --------------------------------------------------------------- worker

def _frontend_main(fe_id: int, shm_dir: str, req_conn,
                   miss_conn) -> None:  # pragma: no cover - subprocess
    """Frontend process body (spawn target; this import path must stay
    light — no serving plane, no cluster). Single-threaded loop:
    requests arrive on ``req_conn``, the hit path is one shm probe +
    a reply built straight off the packed buffers, misses cross to the
    owner over ``miss_conn`` and merge into the reply."""
    from flink_tpu_torch.tenancy.hot_cache_native import FrontendCacheClient

    client = FrontendCacheClient(shm_dir, frontend_id=fe_id)
    try:
        while True:
            try:
                msg = req_conn.recv()
            except (EOFError, OSError):
                break
            if msg is None or msg[0] == "stop":
                break
            kind, req_id = msg[0], msg[1]
            try:
                if kind == "ping":
                    req_conn.send(("ok", req_id, "pong"))
                elif kind == "lookup":
                    _job, _op, keys = msg[2], msg[3], msg[4]
                    req_conn.send(_serve_lookup(
                        client, miss_conn, req_id, _job, _op, keys))
                elif kind == "drive":
                    _job, _op, keys, batch, batches = (
                        msg[2], msg[3], msg[4], msg[5], msg[6])
                    req_conn.send(_serve_drive(
                        client, req_id, _job, _op, keys, batch,
                        batches))
                else:
                    req_conn.send(("err", req_id,
                                   f"unknown request {kind!r}"))
            except (EOFError, OSError, BrokenPipeError):
                break
            except Exception as e:  # noqa: BLE001 — reply, don't die
                try:
                    req_conn.send(("err", req_id,
                                   f"{type(e).__name__}: {e}"))
                except (OSError, BrokenPipeError):
                    break
    finally:
        client.close()


def _serve_lookup(client, miss_conn, req_id, job, op, keys):
    """One request: probe the shm table, cross ONLY the misses to the
    owner, reply the merged results in input order. Keys hash through
    the SAME ``hash_keys_to_i64`` the owner's probe path uses — the
    shm table is keyed by key id, and a divergent hash would read as
    systematic misses, not wrong answers (still: hash once, same fn)."""
    from flink_tpu_torch.state.keygroups import hash_keys_to_i64

    kids = hash_keys_to_i64(np.asarray(keys))
    hits, probe, misses = client.probe(job, op, kids, exact=False)
    out: List[Any] = [None] * len(keys)
    if probe is not None:
        for i in range(len(keys)):
            if probe.hit[i]:
                out[i] = probe.materialize(i)
    if misses:
        client.note_miss_crossings(job, op, len(misses))
        miss_conn.send((req_id, job, op, [keys[i] for i in misses]))
        rep = miss_conn.recv()
        if rep[1] != "ok":
            return ("err", req_id, rep[2])
        for i, val in zip(misses, rep[2]):
            out[i] = val
    return ("ok", req_id, out, {"hits": int(hits),
                                "misses": len(misses)})


def _serve_drive(client, req_id, job, op, keys, batch, batches):
    """Self-driving measurement loop (the multi-process bench): probe
    ``batches`` rotating windows of ``batch`` keys against the shm
    table IN this process — the shape a network frontend serves, where
    replies serialize straight from the packed buffers and never cross
    back through the owner. Misses are counted, not crossed (the bench
    pre-primes; a miss there is signal, not work to route)."""
    from flink_tpu_torch.state.keygroups import hash_keys_to_i64

    keys = hash_keys_to_i64(np.asarray(keys, dtype=np.int64))
    n = len(keys)
    probes = hits = 0
    t0 = time.perf_counter()
    for b in range(batches):
        lo = (b * batch) % max(n - batch + 1, 1)
        got, probe, _misses = client.probe(
            job, op, keys[lo:lo + batch], exact=False)
        probes += batch
        hits += got
    wall = time.perf_counter() - t0
    return ("ok", req_id, {"probes": probes, "hits": hits,
                           "wall_s": wall, "batches": batches})


# ----------------------------------------------------------------- pool

class _Frontend:
    __slots__ = ("idx", "proc", "req", "miss", "lock", "alive",
                 "miss_thread")

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.proc = None
        self.req = None
        self.miss = None
        #: one in-flight request per frontend (the bounded pipe): the
        #: lock serializes owner-side dispatchers onto it
        self.lock = named_lock("frontend.pipe")
        self.alive = False
        self.miss_thread = None


class FrontendPool:
    """Owner-side handle on N frontend processes (see module doc).

    The pool owns: the spawn lifecycle, one MISS-SERVER thread per
    frontend (draining its bounded request pipe into
    ``plane.lookup_batch`` — the replica path, exactly today's miss
    semantics), failover dispatch, and the per-frontend counters
    (read off the shared arena headers owner-side, no IPC —
    :meth:`metrics`). The serving plane must have been built with
    ``shm_dir`` armed (``ServingPlane(shm_dir=...)``)."""

    def __init__(self, plane, n_frontends: int = 2,
                 request_timeout_s: float = REQUEST_TIMEOUT_S,
                 start: bool = True) -> None:
        shm_dir = getattr(plane.hot_cache, "shm_dir", None)
        if shm_dir is None:
            raise RuntimeError(
                "FrontendPool needs a shm-backed serving cache — "
                "build the plane with ServingPlane(shm_dir=...) "
                "(native hotcache required)")
        import multiprocessing as mp

        # spawn, never fork: the owner runs serving worker threads and
        # device runtimes a forked child must not inherit mid-state
        self._ctx = mp.get_context("spawn")
        self.plane = plane
        self.shm_dir = shm_dir
        self.n_frontends = int(n_frontends)
        self.request_timeout_s = float(request_timeout_s)
        self._frontends: List[_Frontend] = [
            _Frontend(i) for i in range(self.n_frontends)]
        self._rr = itertools.count()
        self._req_ids = itertools.count(1)
        self._closed = False
        #: retries that failed over to a sibling after a dead frontend
        self.failovers = 0
        self._fe_group = None
        if start:
            self.start()

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        for fe in self._frontends:
            if not fe.alive:
                self._start_frontend(fe)

    def _start_frontend(self, fe: _Frontend) -> None:
        req_owner, req_child = self._ctx.Pipe()
        miss_owner, miss_child = self._ctx.Pipe()
        fe.req = req_owner
        fe.miss = miss_owner
        fe.proc = self._ctx.Process(
            target=_frontend_main,
            args=(fe.idx, self.shm_dir, req_child, miss_child),
            name=f"hc-frontend-{fe.idx}", daemon=True)
        fe.proc.start()
        req_child.close()
        miss_child.close()
        fe.alive = True
        fe.miss_thread = threading.Thread(
            target=self._miss_server, args=(fe,),
            name=f"hc-miss-server-{fe.idx}", daemon=True)
        fe.miss_thread.start()

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        """Block until every live frontend answers a ping — a spawned
        child pays its interpreter+import boot before its first recv,
        and a bench (or a deploy's readiness gate) must not count that
        against the serving path."""
        deadline = time.monotonic() + timeout_s
        for fe in self._frontends:
            if not fe.alive:
                continue
            remaining = max(deadline - time.monotonic(), 0.1)
            saved = self.request_timeout_s
            self.request_timeout_s = remaining
            try:
                self._dispatch(fe, ("ping", next(self._req_ids)))
            except _FrontendDead:
                raise RuntimeError(
                    f"frontend {fe.idx} did not become ready within "
                    f"{timeout_s:.0f}s") from None
            finally:
                self.request_timeout_s = saved

    def _miss_server(self, fe: _Frontend) -> None:
        """Drain one frontend's miss pipe into the replica path. The
        thread dies with its frontend's pipe; errors reply as errors —
        a miss-resolution failure must surface at the CLIENT, not kill
        the server thread."""
        while True:
            try:
                req_id, job, op, keys = fe.miss.recv()
            except (EOFError, OSError):
                return
            try:
                results = self.plane.lookup_batch(job, op, keys)
                fe.miss.send((req_id, "ok", results))
            except Exception as e:  # noqa: BLE001
                try:
                    fe.miss.send((req_id, "err",
                                  f"{type(e).__name__}: {e}"))
                except (OSError, BrokenPipeError):
                    return

    def _kill(self, fe: _Frontend) -> None:
        """Hard-kill one frontend (the chaos ``drop`` kind and dead-
        pipe cleanup): owner and siblings are untouched by design —
        the process shares nothing but the read-mapped arenas."""
        fe.alive = False
        try:
            if fe.proc is not None and fe.proc.is_alive():
                fe.proc.terminate()
        except Exception:  # noqa: BLE001
            pass
        for conn in (fe.req, fe.miss):
            try:
                if conn is not None:
                    conn.close()
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fe in self._frontends:
            if fe.alive:
                try:
                    fe.req.send(("stop", 0))
                except (OSError, BrokenPipeError):
                    pass
        deadline = time.monotonic() + 5.0
        for fe in self._frontends:
            if fe.proc is not None:
                fe.proc.join(max(0.0, deadline - time.monotonic()))
            self._kill(fe)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------- dispatch

    def live_frontends(self) -> List[int]:
        return [fe.idx for fe in self._frontends
                if fe.alive and fe.proc is not None
                and fe.proc.is_alive()]

    def _dispatch(self, fe: _Frontend, msg) -> Any:
        """One request/reply on a frontend's pipe, or raise
        ``_FrontendDead``. The per-frontend lock keeps the pipe
        bounded: one in-flight request per frontend."""
        with fe.lock:
            if not (fe.alive and fe.proc is not None
                    and fe.proc.is_alive()):
                raise _FrontendDead(fe.idx)
            try:
                fe.req.send(msg)
                if not fe.req.poll(self.request_timeout_s):
                    raise _FrontendDead(fe.idx)
                rep = fe.req.recv()
            except (OSError, BrokenPipeError, EOFError):
                raise _FrontendDead(fe.idx) from None
        if rep[0] == "err":
            raise RuntimeError(
                f"frontend {fe.idx} request failed: {rep[2]}")
        return rep

    def _faulted(self, job: str, operator: str, fe: _Frontend) -> None:
        """The ``serving.frontend`` chaos point at its real site — the
        owner-side dispatch. ``drop`` kills the CHOSEN frontend process
        for real (death mid-burst; the dispatch below then fails over
        to a sibling), ``raise``/``delay`` apply in place. One
        module-global None check while disarmed."""
        from flink_tpu_torch.chaos import injection as chaos

        rule = chaos.payload_action(
            "serving.frontend", kinds=("raise", "delay", "drop"),
            job=job, operator=operator, frontend=fe.idx)
        if rule is not None and rule.kind == "drop":
            self._kill(fe)

    def lookup_batch(self, job: str, operator: str,
                     keys: Sequence[Any],
                     frontend: Optional[int] = None) -> List[Any]:
        """Route one key batch through a frontend process (round-robin
        unless pinned): shm hits answer in the frontend, misses cross
        to the owner's replica path. A dead frontend fails over to a
        live sibling; with none left this fails fast. Results are
        bit-identical to ``plane.lookup_batch`` (same tables, same
        miss path)."""
        if self._closed:
            raise RuntimeError("FrontendPool is closed")
        order: List[_Frontend]
        if frontend is not None:
            order = [self._frontends[frontend]]
            order += [fe for fe in self._frontends
                      if fe.idx != frontend]
        else:
            start = next(self._rr) % self.n_frontends
            order = [self._frontends[(start + i) % self.n_frontends]
                     for i in range(self.n_frontends)]
        keys = list(keys)
        last_dead: Optional[int] = None
        for attempt, fe in enumerate(order):
            self._faulted(job, operator, fe)
            try:
                rep = self._dispatch(
                    fe, ("lookup", next(self._req_ids), job, operator,
                         keys))
            except _FrontendDead as e:
                last_dead = e.idx
                if attempt + 1 < len(order):
                    self.failovers += 1
                continue
            return rep[2]
        raise RuntimeError(
            f"no live frontend to serve lookup (last dead: "
            f"{last_dead}; {len(self._frontends)} configured)")

    def drive(self, job: str, operator: str, keys,
              batch: int = 256, batches: int = 100,
              frontends: Optional[List[int]] = None
              ) -> List[Dict[str, float]]:
        """Run the self-driving probe loop CONCURRENTLY on the chosen
        frontends (the multi-process bench body) and return each one's
        {probes, hits, wall_s}. Keys are pre-primed by the caller."""
        targets = [self._frontends[i] for i in
                   (frontends if frontends is not None
                    else self.live_frontends())]
        keys = np.asarray(keys, dtype=np.int64).tolist()
        results: List[Optional[Dict[str, float]]] = \
            [None] * len(targets)

        def run(slot: int, fe: _Frontend) -> None:
            rep = self._dispatch(
                fe, ("drive", next(self._req_ids), job, operator,
                     keys, int(batch), int(batches)))
            results[slot] = rep[2]

        threads = [threading.Thread(target=run, args=(s, fe))
                   for s, fe in enumerate(targets)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return [r for r in results if r is not None]

    # --------------------------------------------------------- metrics

    def fe_stats(self) -> List[Dict[str, int]]:
        """Per-frontend counters (probes / hits / torn_retries /
        miss_crossings), read owner-side off the shared arena headers."""
        return self.plane.hot_cache.fe_stats(self.n_frontends)

    def metrics(self) -> Dict[str, float]:
        rows = self.fe_stats()
        agg = {f"frontend_{k}": float(sum(r[k] for r in rows))
               for k in (rows[0].keys() if rows else ())}
        agg["frontends_configured"] = float(self.n_frontends)
        agg["frontends_live"] = float(len(self.live_frontends()))
        agg["frontend_failovers"] = float(self.failovers)
        return agg

    def register_metrics(self, group) -> None:
        """Fold the pool into a tenancy/serving metric group as live
        gauges (the discipline every plane here follows: gauges read
        the real counters, dashboards never see a second bookkeeping)."""
        if self._fe_group is not None:
            return
        self._fe_group = group.add_group("frontends")
        for name in ("frontends_configured", "frontends_live",
                     "frontend_failovers", "frontend_probes",
                     "frontend_hits", "frontend_torn_retries",
                     "frontend_miss_crossings"):
            self._fe_group.gauge(
                name, (lambda n=name: self.metrics().get(n, 0.0)))


class _FrontendDead(Exception):
    def __init__(self, idx: int) -> None:
        super().__init__(f"frontend {idx} is dead")
        self.idx = idx


def default_shm_dir(tag: str = "serving") -> str:
    """A per-process default directory for the arena files, under the
    process's temporary directory (``TMPDIR``): the arenas are mmapped
    files, so their pages live in the page cache and every frontend maps
    the same physical copy."""
    import tempfile

    return os.path.join(tempfile.gettempdir(),
                        f"flink_tpu_torch_hc_{tag}_{os.getpid()}")


# ------------------------------------------------------------------ router


class LookupRouter:
    """Lookup routing over the pod: each key goes to the HOST owning its
    key-group range, so a multi-host deployment probes its own frontends
    instead of crossing hosts per key.

    ``lookup_fns[host]`` is that host's serving entry point: locally the
    :class:`FrontendPool` (or the plane itself), remotely whatever reaches
    that host's owner. Ownership follows the LIVE ``KeyGroupAssignment``
    after a rebalance (:meth:`set_assignment`), the table the data plane
    routes by."""

    def __init__(self, num_hosts: int, local_devices: int,
                 max_parallelism: int, local_host: int,
                 lookup_fns: Dict[int, Callable],
                 assignment=None,
                 key_id_fn: Optional[Callable] = None) -> None:
        self.num_hosts = int(num_hosts)
        self.local_devices = int(local_devices)
        self.max_parallelism = int(max_parallelism)
        self.local_host = int(local_host)
        self.lookup_fns = dict(lookup_fns)
        self.assignment = assignment
        self.key_id_fn = key_id_fn
        self.local_keys = 0
        self.remote_keys = 0
        self.remote_batches = 0

    def set_assignment(self, assignment) -> None:
        """Follow a live key-group rebalance: ownership moves with the
        groups."""
        self.assignment = assignment

    def plan(self, keys) -> np.ndarray:
        """The owning host of every key (the routing decision)."""
        from flink_tpu_torch.state.keygroups import (
            assign_key_groups,
            hash_keys_to_i64,
            host_of_key_group,
        )

        arr = np.asarray(keys)
        kids = (self.key_id_fn(arr) if self.key_id_fn is not None
                else hash_keys_to_i64(arr))
        groups = assign_key_groups(np.asarray(kids, dtype=np.int64),
                                   self.max_parallelism)
        return host_of_key_group(
            groups, self.num_hosts, self.local_devices,
            self.max_parallelism, assignment=self.assignment)

    def lookup_batch(self, job: str, operator: str,
                     keys: Sequence[Any]) -> List[Any]:
        """Split the batch by owning host, send each part to that host's
        entry point, and compose the answers back in input order."""
        keys = list(keys)
        hosts = self.plan(keys)
        out: List[Any] = [None] * len(keys)
        for host in np.unique(hosts).tolist():
            idx = np.nonzero(hosts == host)[0].tolist()
            fn = self.lookup_fns.get(int(host))
            if fn is None:
                raise KeyError(
                    f"no serving endpoint for host {host} "
                    f"({len(idx)} keys routed there)")
            res = fn(job, operator, [keys[i] for i in idx])
            for i, val in zip(idx, res):
                out[i] = val
            if int(host) == self.local_host:
                self.local_keys += len(idx)
            else:
                self.remote_keys += len(idx)
                self.remote_batches += 1
        return out

    def metrics(self) -> Dict[str, float]:
        total = self.local_keys + self.remote_keys
        return {
            "router_local_keys": float(self.local_keys),
            "router_remote_keys": float(self.remote_keys),
            "router_remote_batches": float(self.remote_batches),
            "router_local_fraction": (
                self.local_keys / total if total else 0.0),
        }
