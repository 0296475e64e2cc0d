"""The tenancy session cluster: N concurrent jobs, ONE device (port of
``flink_tpu/tenancy/session_cluster.py``).

A session cluster keeps shared resources alive across job submissions;
here the shared substrate is the card and the program cache. Every job is
a stepwise :class:`~flink_tpu_torch.cluster.local_executor.LocalExecutor`
run (``run_stepwise`` — the same loop single-job execution drives), and
ONE scheduler thread interleaves their scheduling quanta with
deficit-round-robin fairness. Exactly one thread ever touches engine
state, so jobs need no locks and checkpoint cuts stay aligned per job.

What each quantum pays and observes:

- the job's program-cache traffic is attributed to it
  (:mod:`program_cache`): a fresh job on a warm cluster shows zero
  program-cache misses;
- the job's quota ledger enforces its resident-row budget
  (:mod:`quotas`): an over-budget job sheds its own cold rows;
- every span the quantum records carries the job's name
  (``flight.set_job``);
- lookups resolve against each job's read replicas (``serving.replica``,
  :mod:`replica`) off the scheduler thread, or — for engines without a
  replica — land on the job's control queue and are served at its next
  batch boundary (:mod:`serving`).

Failure containment: one job's crash never unwinds its siblings — the
failed job restarts from its latest complete checkpoint (bounded
attempts, cold restart when none exists) while the others keep their
quanta.

The cross-job shard arbiter (:mod:`arbiter`), ticking every
``arbitrate_every_s``, acts through LIVE rescale requests that each job's
executor serves at its next batch boundary; shard ceilings are logical
(``parallel/mesh.py`` ``logical_shard_ceiling``).
"""

from __future__ import annotations

import os
import queue as _q
import time
from typing import Any, Dict, List, Optional

from flink_tpu_torch.tenancy.fairness import DeficitRoundRobin
from flink_tpu_torch.tenancy.program_cache import PROGRAM_CACHE
from flink_tpu_torch.tenancy.quotas import QuotaLedger, TenantQuota
from flink_tpu_torch.tenancy.serving import ServingPlane


class TenantJob:
    """One submitted job's scheduling state inside the cluster."""

    def __init__(self, name: str, graph, config, quota: TenantQuota):
        self.name = name
        self.graph = graph
        self.config = config
        self.quota = quota
        self.ledger = QuotaLedger(job=name, quota=quota)
        self.control: "_q.Queue" = _q.Queue()
        self.gen = None          # the run_stepwise generator
        self.handle = None       # JobHandle (first yield)
        self.result = None
        self.error: Optional[BaseException] = None
        self.finished = False
        self.restarts = 0
        self.records_total = 0
        #: wall time of this job's quanta (scheduler view; the operator
        #: busy breakdown lives on the handle)
        self.sched_s = 0.0
        self._pending_rescale = None
        #: failed arbiter-driven rescales (harvested each tick; the
        #: last error is kept so the operator can see WHY)
        self.rescale_errors = 0
        self.last_rescale_error: Optional[BaseException] = None
        #: arbiter-driven rescales the executor served (harvested each
        #: tick and when the job ends)
        self.rescales_served = 0

    def harvest_rescale(self, ending: bool = False) -> None:
        """Account a finished arbiter rescale request: a refused or
        failed reshard comes back through ``finish(None, e)``. When the
        job is ``ending``, a request its executor failed because the job
        terminated first is dropped, not counted as an error (the
        arbiter's tick skips finished jobs)."""
        pending = self._pending_rescale
        if pending is None or not pending._done.is_set():
            return
        self._pending_rescale = None
        if pending.error is None:
            self.rescales_served += 1
        elif not ending:
            self.rescale_errors += 1
            self.last_rescale_error = pending.error

    @property
    def busy_ms(self) -> float:
        return self.handle.busy_ms() if self.handle is not None else 0.0


class SessionCluster:
    """Run N jobs multiplexed over one device mesh (see module doc).

    Usage::

        cluster = SessionCluster()
        cluster.submit(env_a, "job-a")
        cluster.submit(env_b, "job-b", quota=TenantQuota(500_000))
        results = cluster.run()          # drives all jobs to completion
        cluster.lookup("job-a", "window_agg(SumAggregate)", key=7)

    ``run()`` owns the scheduling thread (call it from one thread);
    lookups may come from any number of client threads concurrently —
    they coalesce into device batches on the serving plane.
    """

    def __init__(self, quantum_records: int = 8192,
                 max_restarts: int = 2,
                 arbiter=None, arbitrate_every_s: float = 0.0,
                 serving: Optional[ServingPlane] = None,
                 serving_workers: int = 2,
                 serving_cache_entries: int = 1 << 18,
                 serving_shm_dir: Optional[str] = None):
        self.jobs: Dict[str, TenantJob] = {}
        self.drr = DeficitRoundRobin(quantum=quantum_records)
        #: serving_workers — threads draining the per-(job, operator,
        #: shard) lookup queues (each queue owned by exactly ONE
        #: worker); serving_cache_entries — hot-row cache LRU bound
        #: (0 disables the cache: every lookup resolves on the replica);
        #: serving_shm_dir — arms the multi-process frontend tier (the
        #: hot cache allocates shm arenas there; FrontendPool attaches)
        self.serving = serving or ServingPlane(
            workers=serving_workers,
            cache_entries=serving_cache_entries,
            shm_dir=serving_shm_dir)
        self.max_restarts = int(max_restarts)
        self.arbiter = arbiter
        self.arbitrate_every_s = float(arbitrate_every_s)
        self._last_arbitration = 0.0
        from flink_tpu_torch.metrics import MetricRegistry

        self.registry = MetricRegistry()
        root = self.registry.root_group("cluster", "session")
        self._tenancy_group = root.add_group("tenancy")
        self._register_cluster_gauges()

    # ------------------------------------------------------------ submission

    def submit(self, pipeline, job_name: str,
               quota: Optional[TenantQuota] = None,
               weight: float = 1.0) -> TenantJob:
        """Add a job (a built StreamExecutionEnvironment, or a raw
        (graph, Configuration) via an object exposing
        ``get_stream_graph``/``config``) and prime it: sources open,
        operators open (engines build — cache-attributed to this job),
        pumps start. It runs when :meth:`run` / :meth:`step_round`
        drives the loop."""
        if job_name in self.jobs:
            raise ValueError(f"job name {job_name!r} already submitted")
        graph = pipeline.get_stream_graph()
        if hasattr(pipeline, "_sinks"):
            pipeline._sinks = []
        from flink_tpu_torch.core.config import StateOptions

        config = pipeline.config.copy()
        ckpt = config.get(StateOptions.CHECKPOINT_DIR)
        if ckpt:
            # per-job checkpoint tree, same argument as the spill dirs
            # below: chk-N ids are per-storage sequences, so two jobs
            # sharing one configured dir would overwrite each other's
            # checkpoints — and a restart would restore whichever job
            # wrote last (cross-tenant state). _on_failure reads the
            # re-rooted dir from job.config, so restores stay private.
            config.set(StateOptions.CHECKPOINT_DIR,
                       os.path.join(ckpt, f"job-{job_name}"))
        # COPY the quota (as the config above): submit re-roots
        # quota.spill_dir per job, so a caller reusing one TenantQuota
        # for two jobs would otherwise hand job B job A's private tree
        # — exactly the cross-tenant page overwrite this isolates.
        import dataclasses

        quota = (dataclasses.replace(quota) if quota is not None
                 else TenantQuota())
        if quota.spill_dir is None:
            base = config.get(StateOptions.SPILL_DIR)
            if base:
                # per-job page directory: jobs never share a spill tree
                # (SpillTier page filenames are per-tier sequences —
                # two jobs writing one tree would overwrite each
                # other's pages)
                quota.spill_dir = os.path.join(base, f"job-{job_name}")
        job = TenantJob(job_name, graph, config, quota)
        self._isolate_spill_dirs(job)
        self._start(job, restore_from=None)
        self.jobs[job_name] = job
        self.drr.add(job_name, weight)
        self.serving.bind_job(job_name, job.control)
        self._register_job_gauges(job)
        return job

    def _start(self, job: TenantJob, restore_from: Optional[str]) -> None:
        from flink_tpu_torch.cluster.local_executor import LocalExecutor

        with PROGRAM_CACHE.job_scope(job.name):
            job.gen = LocalExecutor(job.config).run_stepwise(
                job.graph, job.name, restore_from=restore_from,
                control_queue=job.control, cooperative=True)
            job.handle = next(job.gen)
            self._arm_replicas(job)
        job.ledger.engines.clear()
        job.ledger.bind(job.handle.stateful_operators())

    def _arm_replicas(self, job: TenantJob) -> None:
        """Arm every replica-capable operator's read replica and bind
        its adapter to the serving plane (serving.replica; re-run on
        restart — the fresh engines get fresh planes, and rebinding
        atomically retargets lookups so clients that kept serving the
        pre-crash sealed generation move to the restored job's first
        republish). Runs inside the job's program-cache scope: the
        replica program families are charged like any other."""
        from flink_tpu_torch.core.config import ServingOptions

        if not job.config.get(ServingOptions.REPLICA):
            return
        interval = job.config.get(ServingOptions.PUBLISH_INTERVAL_MS)
        for node in job.handle.nodes.values():
            op = node.operator
            if op is None or not hasattr(op, "arm_serving_replica"):
                continue
            adapter = op.arm_serving_replica(
                publish_interval_ms=interval)
            if adapter is not None:
                self.serving.bind_replica(
                    job.name, node.transformation.name, adapter)

    @staticmethod
    def _isolate_spill_dirs(job: TenantJob) -> None:
        """Per-job page directories, made real: the job's private tree
        (``<spill_root>/job-<name>``, or the quota's own ``spill_dir``)
        becomes its configuration's ``state.spill.dir``, from which every
        stateful operator of the port takes its spill tiers at open
        (``operator_context``). Without this, two jobs configured with
        one ``state.spill.dir`` interleave page files in one tree —
        SpillTier filenames are per-tier sequences, so overlapping
        namespace ids would overwrite (and ``pop`` would delete) the
        OTHER job's pages. The configuration is the job's own copy and is
        read before operator open AND before restore, so restarts keep
        the isolation and restored spilled state lands in the job's own
        tree."""
        from flink_tpu_torch.core.config import StateOptions

        if job.quota.spill_dir:
            job.config.set(StateOptions.SPILL_DIR, job.quota.spill_dir)

    # --------------------------------------------------------------- serving

    def lookup(self, job_name: str, operator: str, key, namespace=None):
        """Point lookup against a running job (client threads; rides the
        coalescer's current batch — one gather + one device read per
        request batch)."""
        return self.serving.lookup(job_name, operator, key, namespace)

    def lookup_batch(self, job_name: str, operator: str, keys,
                     namespace=None) -> List[Any]:
        return self.serving.lookup_batch(job_name, operator, keys,
                                         namespace)

    def lookup_batch_packed(self, job_name: str, operator: str, keys):
        """The native serving fast path: the whole key batch probes the
        GIL-free hot-row table in ONE call and hit results stay packed
        until (unless) the caller reads them — see
        :meth:`ServingPlane.lookup_batch_packed`. Bit-identical to
        :meth:`lookup_batch` when materialized."""
        return self.serving.lookup_batch_packed(job_name, operator,
                                                keys)

    # ------------------------------------------------------------ scheduling

    def step_round(self) -> bool:
        """One DRR round over every live job. Returns True while any
        job remains live."""
        live = False
        progressed = False
        for name in self.drr.begin_round():
            job = self.jobs.get(name)
            if job is None or job.finished:
                continue
            live = True
            t0 = time.perf_counter()
            # flight attribution follows the scheduler: every span the
            # quantum records (engine ingest, fires, harvests) carries
            # THIS tenant's name — one Perfetto pid per job
            from flink_tpu_torch.observe import flight_recorder as flight

            flight.set_job(name)
            with PROGRAM_CACHE.job_scope(name):
                while self.drr.can_run(name) and not job.finished:
                    try:
                        n = next(job.gen)
                    except StopIteration as done:
                        self._finish(job, done.value)
                        break
                    except BaseException as e:  # noqa: BLE001
                        self._on_failure(job, e)
                        break
                    job.records_total += n
                    self.drr.charge(name, n)
                    if n > 0:
                        progressed = True
                    else:
                        # nothing ready: forfeit the rest of the quantum
                        # (DRR empty-queue rule)
                        self.drr.reset_idle(name)
                        break
            job.sched_s += time.perf_counter() - t0
            if not job.finished and job.quota.max_resident_rows:
                job.ledger.enforce()
        if self.arbiter is not None and live and \
                self.arbitrate_every_s > 0:
            now = time.monotonic()
            if now - self._last_arbitration >= self.arbitrate_every_s:
                self._last_arbitration = now
                self._arbitrate()
        if live and not progressed:
            time.sleep(0.0005)  # all jobs idle: don't spin the core
        return live

    def run(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Drive every job to completion; {job -> JobExecutionResult}.
        Failed jobs past their restart budget surface their error in
        the mapping value instead."""
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        while self.step_round():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"session cluster did not finish within {timeout_s}s "
                    f"(live: {[j.name for j in self.jobs.values() if not j.finished]})")
        # every job finished: stop the serving workers (a later submit
        # re-binds replicas and restarts the pool); riders still queued
        # fail fast instead of timing out against dead queues
        self.serving.shutdown_workers()
        return {name: (job.result if job.error is None else job.error)
                for name, job in self.jobs.items()}

    def _finish(self, job: TenantJob, result) -> None:
        job.result = result
        job.finished = True
        self.serving.unbind_job(job.name)
        self._fail_stranded_lookups(job)
        self.drr.remove(job.name)
        self._release(job)

    def _release(self, job: TenantJob) -> None:
        """Drop a terminal job's execution resources. The handle keeps
        the whole operator graph alive — engines' [P,cap] device planes,
        host indexes, pumps — so a long-lived cluster churning short
        jobs would otherwise hold one dead job's working set per
        HISTORICAL job. Cheap counters (busy_ms, records_total,
        restarts, ledger violation totals) stay on the TenantJob for
        the results mapping; the per-job gauge subtree is unregistered
        so scrapes stop reading dead engines."""
        job.harvest_rescale(ending=True)
        job.gen = None
        job.handle = None
        job.ledger.engines.clear()
        self.registry.unregister_scope_prefix(
            self._tenancy_group.scope + (job.name,))

    @staticmethod
    def _fail_stranded_lookups(job: TenantJob) -> None:
        """Fail control requests that raced past the executor's own
        terminal drain: a serving client can pass the plane's bound-queue
        check just as the run finishes and enqueue AFTER
        ``_fail_pending_controls`` ran — with the queue unbound, nothing
        would ever serve it and the rider blocks out its full timeout.
        Draining again after unbind closes the window from this side;
        ``ServingPlane._flush`` closes it from the client side."""
        from flink_tpu_torch.cluster.local_executor import LocalExecutor

        LocalExecutor._fail_pending_controls(
            job.control, f"job {job.name!r} is not serving (not running, "
            "or finished)")

    def _on_failure(self, job: TenantJob, exc: BaseException) -> None:
        """Contain one job's crash: restart it from its latest COMPLETE
        checkpoint (cold from scratch when none exists) while its
        siblings keep running; past the restart budget, the job is
        failed and the error recorded — never propagated into the
        scheduler loop."""
        from flink_tpu_torch.core.config import StateOptions

        job.gen = None
        ckpt_dir = job.config.get(StateOptions.CHECKPOINT_DIR)
        if job.restarts >= self.max_restarts:
            job.error = exc
            job.finished = True
            self.serving.unbind_job(job.name)
            self._fail_stranded_lookups(job)
            self.drr.remove(job.name)
            self._release(job)
            return
        job.restarts += 1
        try:
            restore = None
            if ckpt_dir and os.path.isdir(ckpt_dir):
                from flink_tpu_torch.checkpoint.storage import CheckpointStorage

                cid = CheckpointStorage(ckpt_dir).latest_checkpoint_id(
                    verify=True)
                if cid is not None:
                    restore = os.path.join(ckpt_dir, f"chk-{cid}")
            # drain stale control requests: their servers died with the
            # run
            while True:
                try:
                    job.control.get_nowait().finish(None, RuntimeError(
                        f"job {job.name!r} restarting after: {exc!r}"))
                except _q.Empty:
                    break
            self._start(job, restore_from=restore)
        except BaseException as restart_exc:  # noqa: BLE001
            # the RESTART itself failed (unreadable checkpoint tree,
            # operator open error): charge it against the same budget —
            # letting it escape would unwind step_round and kill every
            # sibling, the exact propagation this method exists to stop
            self._on_failure(job, restart_exc)

    # ---------------------------------------------------------- arbitration

    def _arbitrate(self) -> None:
        """One arbitration tick: demands -> allocations -> LIVE rescale
        requests on the affected jobs' control queues, served at their
        next batch boundary after the in-flight fires drain; a failed
        reshard is harvested into ``rescale_errors``. A job's shard
        ceiling is logical (``parallel/mesh.py``
        ``logical_shard_ceiling``): its quota's ``max_shards``, else the
        stated default — never the number of cards."""
        from flink_tpu_torch.cluster.local_executor import RescaleRequest
        from flink_tpu_torch.parallel.mesh import logical_shard_ceiling
        from flink_tpu_torch.tenancy.arbiter import JobDemand

        demands = []
        targets = {}
        for job in self.jobs.values():
            if job.finished or job.handle is None:
                continue
            job.harvest_rescale()
            op = next((o for o in job.handle.stateful_operators()
                       if getattr(o, "supports_live_rescale", False)),
                      None)
            if op is None:
                continue
            eng = op.windower
            hi = logical_shard_ceiling(eng, job.quota.max_shards)
            targets[job.name] = (job, op, hi)
            demands.append(JobDemand(
                job=job.name, current_shards=int(eng.P),
                backlog=float(job.handle.backlog_records()),
                quota_pressure=job.ledger.pressure(),
                min_shards=job.quota.min_shards, max_shards=hi))
        if not demands:
            return
        # a watchdog-quarantined shard changes the budget: the arbiter
        # divides what actually answers. Jobs' shards are logical and
        # their own, so the largest per-job quarantine count is taken
        dead = 0
        for j in self.jobs.values():
            if j.finished or j.handle is None:
                continue
            wd = getattr(j.handle, "watchdog", None)
            if wd is not None:
                dead = max(dead, len(wd.quarantined))
        alloc = self.arbiter.decide(demands, dead_shards=dead)
        for name, shards in alloc.items():
            job, op, hi = targets[name]
            shards = min(int(shards), hi)
            if shards == int(op.windower.P):
                continue
            if job._pending_rescale is not None:
                continue  # one in-flight rescale per job
            req = RescaleRequest(shards)
            job._pending_rescale = req
            job.control.put(req)

    # -------------------------------------------------------------- metrics

    def _register_cluster_gauges(self) -> None:
        g = self._tenancy_group
        g.gauge("jobs_live",
                lambda: sum(1 for j in self.jobs.values()
                            if not j.finished))
        # per-field accessors, not stats()/lookup_counts(): a scrape of
        # every gauge through the dict forms would recompute all fields
        # per gauge (same rule as the per-job quota gauges below)
        g.gauge("program_cache_programs",
                lambda: PROGRAM_CACHE.stat("programs"))
        g.gauge("program_cache_hits",
                lambda: PROGRAM_CACHE.stat("hits"))
        g.gauge("program_cache_misses",
                lambda: PROGRAM_CACHE.stat("misses"))
        g.gauge("queryable_lookups_total",
                lambda: self.serving.lookups_total())
        g.gauge("queryable_lookup_batches_total",
                lambda: self.serving.lookup_batches_total())
        # only the p99 gauge pays the latency-reservoir sort
        g.gauge("queryable_lookup_p99_ms",
                lambda: self.serving.lookup_p99_ms())
        # serving SLO gauges (the read-replica plane): lookup p99,
        # worst-case sealed-generation age, hot-row cache hit rate
        g.gauge("serving.lookupP99Ms",
                lambda: self.serving.lookup_p99_ms())
        g.gauge("serving.replicaStalenessMs",
                lambda: self.serving.replica_staleness_ms())
        g.gauge("serving.hotRowHitRate",
                lambda: self.serving.hot_row_hit_rate())
        if self.serving.shm_dir is not None:
            # the multi-process tier's shm-header counters (live reads
            # off the shared arenas — frontends write them lock-free)
            for name in ("probes", "hits", "torn_retries",
                         "miss_crossings"):
                g.gauge(f"serving.frontend.{name}",
                        (lambda n=name: self.serving.frontend_stats()
                         .get(f"frontend_{n}", 0.0)))

    def _register_job_gauges(self, job: TenantJob) -> None:
        g = self._tenancy_group.add_group(job.name)
        g.gauge("busyTimeMsTotal", lambda j=job: j.busy_ms)
        g.gauge("records_total", lambda j=job: j.records_total)
        g.gauge("restarts", lambda j=job: j.restarts)
        g.gauge("deficit",
                lambda j=job: self.drr.deficit(j.name) or 0.0)
        g.gauge("backlog_records",
                lambda j=job: (j.handle.backlog_records()
                               if j.handle is not None and not j.finished
                               else 0))
        g.gauge("program_cache_misses",
                lambda j=job: PROGRAM_CACHE.stats_for(j.name)["misses"])
        g.gauge("program_cache_hits",
                lambda j=job: PROGRAM_CACHE.stats_for(j.name)["hits"])
        g.gauge("rescale_errors", lambda j=job: j.rescale_errors)
        # individual accessors, not ledger.metrics(): a scrape of all
        # five gauges through metrics() would walk every engine's
        # resident-row indexes ~10 times (metrics() computes
        # resident_rows twice, once directly and once via pressure())
        g.gauge("resident_rows",
                lambda j=job: j.ledger.resident_rows())
        g.gauge("quota_rows",
                lambda j=job: j.ledger.quota.max_resident_rows)
        g.gauge("quota_pressure", lambda j=job: j.ledger.pressure())
        g.gauge("quota_violations",
                lambda j=job: j.ledger.quota_violations)
        g.gauge("rows_shed", lambda j=job: j.ledger.rows_shed)
