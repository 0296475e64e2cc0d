"""Runtime observability (port of ``flink_tpu/observe/``).

:mod:`~flink_tpu_torch.observe.flight_recorder` is the always-on span
plane the whole batch lifecycle reports into, exported to Perfetto/Chrome
traces, Prometheus histograms and event-time latency markers by
:mod:`~flink_tpu_torch.observe.export`.


:mod:`~flink_tpu_torch.observe.lock_sentinel` gives the serving plane its
named locks and the tests their lock-order checker (the reference's
names, re-exported here as there).

Not here, by design: the reference's ``recompile_sentinel`` (it counts
XLA backend compiles and device-to-host materializations through
``jax.monitoring``; the port has no compiled programs to count and no
transfer hook). ROADMAP Queue A item 12h records why it stays unported;
its names raise ``NotImplementedError`` citing that note.
"""

#: Canonical span-kind inventory. The flight recorder raises on an
#: unregistered kind, and the exporters' category mapping derives from
#: this tuple. Against the reference's tuple: the ingest and fire
#: splits (``prep.route``, ``prep.slots``), the task loop's source wait
#: and the two wait records (``source.wait``, ``source.queue``,
#: ``fire.pending``) are added; ``emit`` (read by nothing) and the
#: JAX-only probes ``xla.compile`` and ``d2h.transfer`` are not here.
KNOWN_SPAN_KINDS = (
    # per-batch lifecycle (the engines' ingest -> emit pipeline)
    "batch.ingest",        # one engine process_batch (host prep + dispatch)
    "prep.route",          # slice assignment, live mask, key-group route,
                           # the records grouped by shard
    "prep.slots",          # one shard's slot lookup/insert and its marks
    "prep.meta_sweep",     # session-metadata absorb (native C or Python)
    "prep.stage",          # shuffle staging / bucketing into [P, B] blocks
    "device.dispatch",     # inline device interactions (H2D + launch)
    "device.fence_wait",   # host blocked on dispatch-ahead fences
    "exchange.stage1",     # two-level exchange: intra-host (ICI) route
    "exchange.stage2",     # two-level exchange: cross-host (DCN) hop +
                           # the stream-order scatter
    "fire.dispatch",       # watermark advance -> fire programs enqueued
    "fire.shard",          # one shard's fire-path host work (resolve,
                           # slice frees, cold page extraction) — the
                           # per-shard track
    "fire.pending",        # wait record: a fire's dispatch -> its harvest
    "fire.harvest",        # D2H materialization of fire/query results
    "op.process",          # executor: one operator's process_batch
    "op.watermark",        # executor: one operator's process_watermark
    "source.wait",         # executor: the task loop blocked on a pump
    "source.queue",        # wait record: a pump's put -> the loop's take
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
    "watchdog.miss",       # a deadline-tracked section ran past budget
    "chaos.inject",        # an armed fault plan fired at a fault point
)

#: the kinds whose spans hold their thread CPU seconds (``cpu_s``). A read
#: of the thread CPU clock is a system call: 30-70 us inside a job on the
#: card's host (its tail to 10 ms), where it steps in 10 ms ticks. So only
#: the engines' whole-batch ingest span reads it, at most once in
#: ``flight_recorder.CPU_EVERY_S`` a thread.
CPU_TIMED_KINDS = frozenset({"batch.ingest"})

from flink_tpu_torch.observe.flight_recorder import (  # noqa: E402,F401
    FlightRecorder,
    SpanRecord,
    recorder,
)

from flink_tpu_torch.observe.lock_sentinel import (  # noqa: E402,F401
    LockOrderViolation,
    LockSentinel,
    NamedLock,
    named_lock,
)

#: name -> (reference module, ROADMAP item)
_NOT_PORTED = {
    **{n: ("recompile_sentinel", "12h") for n in (
        "RecompileSentinel", "SteadyStateViolation", "compile_count",
        "transfer_count", "install_probes")},
}


def __getattr__(name):
    if name in _NOT_PORTED:
        module, item = _NOT_PORTED[name]
        raise NotImplementedError(
            f"observe.{name} (the reference's observe/{module}.py) counts "
            "XLA compiles through jax.monitoring and stays unported by "
            f"design in flink_tpu_torch (ROADMAP.md, Queue A item {item})")
    raise AttributeError(name)
