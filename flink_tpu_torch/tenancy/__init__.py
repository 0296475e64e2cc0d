"""Multi-tenancy and queryable-state serving (port of
``flink_tpu/tenancy/``): N jobs multiplexed over ONE device.

- :mod:`session_cluster` (``SessionCluster``, ``TenantJob``): every job a
  stepwise ``LocalExecutor`` run, interleaved on one scheduler thread by
  :mod:`fairness` (``DeficitRoundRobin``), each bounded by a
  :mod:`quotas` budget (``TenantQuota``, ``QuotaLedger``); crash
  containment restarts only the failed job.
- :mod:`program_cache` (``PROGRAM_CACHE``, ``SharedProgramCache``): the
  engines' step families shared across jobs, with per-job hit/miss stats.
- :mod:`replica` (``ReplicaPlane`` and the window, session and join-side
  adapters): the read replica every mesh engine publishes at watermark
  boundaries; lookups resolve against a sealed generation off the task
  loop.
- :mod:`serving` (``ServingPlane``, ``LookupCoalescer``,
  ``CoalescerPool``, ``PackedLookupResult``), :mod:`hot_cache` and
  :mod:`hot_cache_native`: the lookup path, its worker pool and the
  hot-row cache the publishes prime.
- :mod:`frontend` (``FrontendPool``): frontend processes serving the hit
  path off the hot cache's shared-memory arenas.
- :mod:`arbiter` (``ShardArbiter``, ``JobDemand``): the cross-job shard
  policy, acted on through live rescale requests.

The names stay lazy, as in the reference: the lowest engine layers import
:mod:`program_cache` without pulling in the cluster.
"""

_LAZY = {
    "PROGRAM_CACHE": "flink_tpu_torch.tenancy.program_cache",
    "SharedProgramCache": "flink_tpu_torch.tenancy.program_cache",
    "TenantQuota": "flink_tpu_torch.tenancy.quotas",
    "QuotaLedger": "flink_tpu_torch.tenancy.quotas",
    "DeficitRoundRobin": "flink_tpu_torch.tenancy.fairness",
    "ServingPlane": "flink_tpu_torch.tenancy.serving",
    "LookupCoalescer": "flink_tpu_torch.tenancy.serving",
    "CoalescerPool": "flink_tpu_torch.tenancy.serving",
    "PackedLookupResult": "flink_tpu_torch.tenancy.serving",
    "ReplicaPlane": "flink_tpu_torch.tenancy.replica",
    "SessionReplicaAdapter": "flink_tpu_torch.tenancy.replica",
    "WindowReplicaAdapter": "flink_tpu_torch.tenancy.replica",
    "JoinSideReplicaAdapter": "flink_tpu_torch.tenancy.replica",
    "HotRowCache": "flink_tpu_torch.tenancy.hot_cache",
    "PrimeDelta": "flink_tpu_torch.tenancy.hot_cache",
    "make_hot_row_cache": "flink_tpu_torch.tenancy.hot_cache",
    "NativeHotRowCache": "flink_tpu_torch.tenancy.hot_cache_native",
    "ShardArbiter": "flink_tpu_torch.tenancy.arbiter",
    "JobDemand": "flink_tpu_torch.tenancy.arbiter",
    "SessionCluster": "flink_tpu_torch.tenancy.session_cluster",
    "TenantJob": "flink_tpu_torch.tenancy.session_cluster",
    "FrontendPool": "flink_tpu_torch.tenancy.frontend",
    "LookupRouter": "flink_tpu_torch.tenancy.frontend",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(mod), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
