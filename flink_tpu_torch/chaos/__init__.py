"""Chaos engine (port of ``flink_tpu/chaos``): deterministic fault
injection at named fault points (``injection``) and the crash-restore-
verify harness (``harness``) that kills an engine at those points,
restores it from the latest complete checkpoint and diffs its committed
output against a fault-free oracle.

Everything is reproducible from ``(FaultPlan, seed)``, and the same plan
and seed select the same hits as in the reference: the fault points sit at
the reference's call sites.
"""

#: The reference's canonical fault-point inventory, copied whole. Points
#: whose subsystem is not ported yet (joins, CEP, serving, rescale, the
#: watchdog, host and device loss) have no call site in the port.
KNOWN_FAULT_POINTS = (
    "shuffle.bucket_prep",
    "shuffle.bucket_send",
    "shuffle.device_exchange",
    "exchange.dcn_send",
    "spill.page_reload",
    "spill.page_compact",
    "checkpoint.write",
    "checkpoint.write.torn",
    "checkpoint.read",
    "mesh.dispatch_fence",
    "mesh.session_fire",
    "mesh.window_fire",
    "rescale.handoff",
    "rebalance.handoff",
    "join.exchange",
    "join.versioned_lookup",
    "cep.advance",
    "cep.match_fire",
    "serving.lookup",
    "serving.replica_publish",
    "serving.cache_probe",
    "serving.frontend",
    "harvest.pending_fire",
    "task.batch",
    "task.subtask_batch",
    "device.lost",
    "host.lost",
    "watchdog.deadline",
)

from flink_tpu_torch.chaos.injection import (  # noqa: E402,F401
    ChaosController,
    FaultPlan,
    FaultRule,
    InjectedFault,
    RetryBudgetExhaustedError,
    arm,
    armed,
    chaos_active,
    controller,
    disarm,
    fault_point,
    io_point,
    payload_action,
    register_chaos_metrics,
    run_recoverable,
)
from flink_tpu_torch.chaos.harness import (  # noqa: E402,F401
    ChaosDivergenceError,
    ChaosReport,
    run_crash_restore_verify,
)
