"""Runtime observability (port of ``flink_tpu/observe/``).

:mod:`~flink_tpu_torch.observe.flight_recorder` is the always-on span
plane the whole batch lifecycle reports into, exported to Perfetto/Chrome
traces, Prometheus histograms and event-time latency markers by
:mod:`~flink_tpu_torch.observe.export`.

Not here: the reference's ``recompile_sentinel`` (it counts XLA backend
compiles and device-to-host materializations through ``jax.monitoring``;
the port has no compiled programs to count and no transfer hook, ROADMAP
Queue A item 12h) and ``lock_sentinel`` (the serving plane's lock-order
checker, item 12e). Their names raise ``NotImplementedError`` naming the
item.
"""

#: Canonical span-kind inventory — the reference's tuple, whole. The
#: flight recorder raises on an unregistered kind, and the exporters'
#: category mapping derives from this tuple. ``xla.compile`` and
#: ``d2h.transfer`` stay listed but the port never records them (see
#: ``flight_recorder``'s docstring).
KNOWN_SPAN_KINDS = (
    # per-batch lifecycle (the engines' ingest -> emit pipeline)
    "batch.ingest",        # one engine process_batch (host prep + dispatch)
    "prep.meta_sweep",     # session-metadata absorb (native C or Python)
    "prep.stage",          # shuffle staging / bucketing into [P, B] blocks
    "device.dispatch",     # inline device interactions on the ingest path
    "device.fence_wait",   # host blocked on dispatch-ahead fences
    "exchange.stage1",     # two-level exchange: intra-host (ICI) route
    "exchange.stage2",     # two-level exchange: cross-host (DCN) hop +
                           # the stream-order scatter
    "fire.dispatch",       # watermark advance -> fire programs enqueued
    "fire.shard",          # one shard's fire-path host work (resolve,
                           # cold page extraction) — the per-shard track
    "fire.harvest",        # D2H materialization of fire/query results
    "op.process",          # executor: one operator's process_batch
    "op.watermark",        # executor: one operator's process_watermark
    "emit",                # executor: one output left its operator
                           # (instant — durations belong to op.process)
    # control plane
    "checkpoint.write",
    "checkpoint.restore",
    "failover.replay",     # partial-failover bounded replay of one range
    "reshard.handoff",     # live key-group migration between mesh sizes
    "serving.lookup",      # one coalesced queryable-state flush
    "serving.replica_publish",  # boundary publish of the read replica
                           # (batch field carries the sealed generation)
    "serving.cache_hit",   # hot-row cache served a lookup batch without
                           # touching the device (instant; batch field
                           # carries the generation the hits were tagged)
    # instants correlated into the same timeline
    "xla.compile",         # real XLA backend compile (jax.monitoring)
    "d2h.transfer",        # device->host materialization (__array__)
    "watchdog.miss",       # a deadline-tracked section ran past budget
    "chaos.inject",        # an armed fault plan fired at a fault point
)

from flink_tpu_torch.observe.flight_recorder import (  # noqa: E402,F401
    FlightRecorder,
    SpanRecord,
    recorder,
)

#: name -> (reference module, ROADMAP item)
_NOT_PORTED = {
    **{n: ("recompile_sentinel", "12h") for n in (
        "RecompileSentinel", "SteadyStateViolation", "compile_count",
        "transfer_count", "install_probes")},
    **{n: ("lock_sentinel", "12e") for n in (
        "LockOrderViolation", "LockSentinel", "NamedLock", "named_lock")},
}


def __getattr__(name):
    if name in _NOT_PORTED:
        module, item = _NOT_PORTED[name]
        raise NotImplementedError(
            f"observe.{name} (the reference's observe/{module}.py) is not "
            f"ported to flink_tpu_torch (ROADMAP.md, Queue A item {item})")
    raise AttributeError(name)
