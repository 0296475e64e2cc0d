"""Queryable-state serving (port of ``flink_tpu/tenancy/``, the serving
half).

- :mod:`serving`: ``LookupCoalescer``, ``CoalescerPool``,
  ``PackedLookupResult`` and ``ServingPlane``. Its legacy path coalesces
  lookups into ``StateQueryBatchRequest``s on a job's control queue (one
  gather and one device-to-host copy per batch, served on the task thread
  at a batch boundary); its replica path serves a bound adapter's sealed
  generations through a worker pool and the hot-row cache.
- :mod:`hot_cache` (``HotRowCache``, ``PrimeDelta``,
  ``make_hot_row_cache``) and :mod:`hot_cache_native` (the native probe
  table over ``native/hotcache.cpp``): composed results tagged with the
  generation that produced them; a whole key batch probes in one
  GIL-released C call.

The names stay lazy, as in the reference. Those whose modules are the
multi-tenant cluster's (the session cluster, quotas, fairness, the
arbiter, the program cache, the read replicas and the frontends) raise
``NotImplementedError`` naming ROADMAP.md Queue A item 12f.
"""

_LAZY = {
    "ServingPlane": "flink_tpu_torch.tenancy.serving",
    "LookupCoalescer": "flink_tpu_torch.tenancy.serving",
    "CoalescerPool": "flink_tpu_torch.tenancy.serving",
    "PackedLookupResult": "flink_tpu_torch.tenancy.serving",
    "HotRowCache": "flink_tpu_torch.tenancy.hot_cache",
    "PrimeDelta": "flink_tpu_torch.tenancy.hot_cache",
    "make_hot_row_cache": "flink_tpu_torch.tenancy.hot_cache",
    "NativeHotRowCache": "flink_tpu_torch.tenancy.hot_cache_native",
}

#: the reference's names whose modules come with item 12f
_NOT_PORTED = {
    "PROGRAM_CACHE": "program_cache",
    "SharedProgramCache": "program_cache",
    "TenantQuota": "quotas",
    "QuotaLedger": "quotas",
    "DeficitRoundRobin": "fairness",
    "ReplicaPlane": "replica",
    "SessionReplicaAdapter": "replica",
    "WindowReplicaAdapter": "replica",
    "JoinSideReplicaAdapter": "replica",
    "ShardArbiter": "arbiter",
    "JobDemand": "arbiter",
    "SessionCluster": "session_cluster",
    "TenantJob": "session_cluster",
    "FrontendPool": "frontend",
    "LookupRouter": "frontend",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(mod), name)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"tenancy.{name} (the reference's tenancy/{_NOT_PORTED[name]}"
            ".py) is not ported to flink_tpu_torch yet (ROADMAP.md, "
            "Queue A item 12f)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
