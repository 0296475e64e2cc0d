"""Queryable state client: external point lookups of live keyed state
(port of ``flink_tpu/cluster/queryable_state.py``, the whole module; host
code).

Reference: flink-queryable-state (``QueryableStateClient`` querying the
TaskManager's KvStateServer). Here a lookup travels the MiniCluster's RPC
control plane (Dispatcher -> JobMaster -> TaskExecutor) to the owning task
and is served ON the task loop at a batch boundary, so it reads a
consistent cut, at the cost of up to one micro-batch of latency.

Every read, single key or batch, travels as a ``StateQueryBatchRequest``
and is served by one gather and ONE device-to-host copy for the whole
batch. Concurrent ``get_state`` callers from different threads COALESCE
into shared batches (``tenancy/serving.py`` ``LookupCoalescer``). Against a
cluster that exposes ``.serving`` (a ``ServingPlane``), lookups take the
plane's route instead.

Usage::

    client = QueryableStateClient(cluster)
    result = client.get_state(job_id, "window_agg(SumAggregate)", key=7)
    # -> {namespace -> {output column -> value}}
    results = client.get_state_batch(job_id, "window_agg(SumAggregate)",
                                     keys=[7, 8, 9])
    # -> one result dict per key, request order
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class QueryableStateClient:
    #: default ride-collection window 0: flush immediately — the drain
    #: loop still coalesces whatever concurrent callers queued, but a
    #: SEQUENTIAL caller (always the lone flusher) pays no wait at all;
    #: a nonzero window only helps sustained multi-thread load, where
    #: the ServingPlane (which keeps one) is the intended surface.
    def __init__(self, cluster, coalesce_window_ms: float = 0.0,
                 max_batch: int = 512):
        from flink_tpu_torch.tenancy.serving import CoalescerPool

        self.cluster = cluster

        def make_flush(key):
            # the RAW rpc: the coalescer's _drain already records the
            # batch against its counters — routing through
            # get_state_batch here would double-count coalesced lookups
            def flush(keys, namespace, _j=key[0], _o=key[1]):
                return self._query_batch_rpc(_j, _o, keys, namespace)

            return flush

        #: the shared coalescer lifecycle (creation race, retirement
        #: accounting, stats shape) — one behavior with ServingPlane
        self._pool = CoalescerPool(make_flush, max_batch=int(max_batch),
                                   window_ms=float(coalesce_window_ms))

    # ------------------------------------------------------------------ API

    def _serving_plane(self):
        """The cluster's ServingPlane when it exposes one (the tenancy
        session cluster): lookups then take the native fast path — the
        whole key batch probes the GIL-free hot-row table in ONE call
        before any Python-per-key work, and only misses ride the
        replica worker queues. RPC-gateway clusters return None and
        keep the control-plane route."""
        return getattr(self.cluster, "serving", None)

    def get_state(self, job_id: str, operator_name: str, key,
                  namespace: Optional[int] = None
                  ) -> Dict[int, Dict[str, Any]]:
        """Finished result columns for ``key`` in the named stateful
        operator; one entry per live namespace (window), or just the one
        requested. Thin wrapper over the batched path: the lookup rides
        whatever device batch concurrent callers are forming."""
        plane = self._serving_plane()
        if plane is not None:
            t0 = time.perf_counter()
            out = plane.lookup(job_id, operator_name, key, namespace)
            # keep client-side stats counting point lookups on the
            # plane route (the legacy coalescer path counted each one)
            self._coalescer(job_id, operator_name).note_batch(
                1, (time.perf_counter() - t0) * 1e3)
            return out
        return self._coalescer(job_id, operator_name).lookup(
            key, namespace)

    def get_state_batch(self, job_id: str, operator_name: str, keys,
                        namespace: Optional[int] = None
                        ) -> List[Dict[int, Dict[str, Any]]]:
        """One result dict per key, request order — a single RPC (or
        one batched serving-plane probe, see :meth:`_serving_plane`)
        and a single device batch for the whole list. Recorded against
        the (job, operator) coalescer's counters (as ServingPlane's
        ``lookup_batch``) so :meth:`stats` covers the explicit-batch
        shape too, not just coalesced ``get_state`` traffic."""
        t0 = time.perf_counter()
        plane = self._serving_plane()
        if plane is not None:
            out = plane.lookup_batch(job_id, operator_name, keys,
                                     namespace)
        else:
            out = self._query_batch_rpc(job_id, operator_name, keys,
                                        namespace)
        self._coalescer(job_id, operator_name).note_batch(
            len(out), (time.perf_counter() - t0) * 1e3)
        return out

    def get_state_batch_packed(self, job_id: str, operator_name: str,
                               keys):
        """The zero-copy batch form: against a serving-plane cluster,
        hit results stay in the native probe's packed buffers and
        materialize per key only on read (bit-identical to
        :meth:`get_state_batch` when consumed). Against an RPC-gateway
        cluster it wraps the ordinary batch — same read surface either
        way."""
        from flink_tpu_torch.tenancy.serving import PackedLookupResult

        t0 = time.perf_counter()
        plane = self._serving_plane()
        if plane is not None:
            out = plane.lookup_batch_packed(job_id, operator_name,
                                            keys)
        else:
            out = PackedLookupResult.from_dicts(self._query_batch_rpc(
                job_id, operator_name, keys, None))
        self._coalescer(job_id, operator_name).note_batch(
            len(out), (time.perf_counter() - t0) * 1e3)
        return out

    def _query_batch_rpc(self, job_id: str, operator_name: str, keys,
                         namespace: Optional[int] = None):
        return self.cluster.dispatcher_gateway().query_state_batch(
            job_id, operator_name, list(keys), namespace)

    # ------------------------------------------------------------ coalescing

    def _coalescer(self, job_id: str, operator_name: str):
        return self._pool.get((job_id, operator_name))

    def forget_job(self, job_id: str) -> None:
        """Drop the job's coalescers — a long-lived client querying
        many short-lived jobs grows one coalescer (and its latency
        reservoir) per (job, operator) forever otherwise. Counters
        fold into retained totals so :meth:`stats` stays cumulative —
        including a lookup racing the forget (retired coalescers
        redirect late counts into the pool). Querying the job again
        AFTER forgetting re-creates its tracking (by design — the job
        may still be running); forget again when done."""
        self._pool.retire(lambda k: k[0] == job_id)

    def stats(self) -> Dict[str, float]:
        """Client-side amortization evidence: lookups vs device batches
        and the p99 end-to-end lookup latency (retained totals from
        forgotten jobs included)."""
        return self._pool.stats()
