"""Typed configuration (port of ``flink_tpu/core/config.py``).

The options the ported paths read are carried under the reference's keys
and defaults, plus the port's own ``execution.device``. Reference keys the
port does not declare are the ones the reference declares and never
reads (``REFERENCE_KEYS_NEVER_READ``), and ``check_unread_keys`` (called
at ``execute()``) rejects the reference's ``stateplane.backend.*`` keys,
so no key the reference reads is ignored without a word.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generic, Optional, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class ConfigOption(Generic[T]):
    """A typed configuration key with a default."""

    key: str
    default: Optional[T] = None
    type: type = str
    description: str = ""

    def with_default(self, default: T) -> "ConfigOption[T]":
        return dataclasses.replace(self, default=default)


def _coerce(value: Any, typ: type) -> Any:
    if value is None or isinstance(value, typ):
        return value
    if typ is bool and isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes", "on")
    return typ(value)


class Configuration:
    """Layered key/value store with typed access through ConfigOptions:
    a configuration's own entries override its fallback's
    (``with_fallback``)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None) -> None:
        self._data: Dict[str, Any] = dict(data or {})
        self._fallback: Optional[Configuration] = None

    def get(self, option: ConfigOption[T]) -> Optional[T]:
        found, value = self._lookup(option.key)
        return _coerce(value, option.type) if found else option.default

    def set(self, option: "ConfigOption[T] | str", value: T) -> "Configuration":
        key = option.key if isinstance(option, ConfigOption) else option
        self._data[key] = value
        return self

    def contains(self, option: "ConfigOption | str") -> bool:
        key = option.key if isinstance(option, ConfigOption) else option
        return self._lookup(key)[0]

    def get_raw(self, key: str, default: Any = None) -> Any:
        found, value = self._lookup(key)
        return value if found else default

    def _lookup(self, key: str):
        if key in self._data:
            return True, self._data[key]
        if self._fallback is not None:
            return self._fallback._lookup(key)
        return False, None

    def with_fallback(self, other: "Configuration") -> "Configuration":
        """A new Configuration: self's entries override ``other``'s."""
        merged = Configuration(self._data)
        merged._fallback = other
        return merged

    def to_dict(self) -> Dict[str, Any]:
        base = self._fallback.to_dict() if self._fallback else {}
        base.update(self._data)
        return base

    def copy(self) -> "Configuration":
        c = Configuration(dict(self._data))
        c._fallback = self._fallback
        return c

    def keys(self):
        """Every key visible through this configuration (own layer and
        the fallback chain)."""
        return list(self.to_dict())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Configuration({self.to_dict()!r})"


class CoreOptions:
    DEFAULT_PARALLELISM = ConfigOption(
        "parallelism.default", default=1, type=int,
        description="Default operator parallelism (number of key-group "
        "shards; in this port the shard count of the logical mesh on one "
        "device).")
    MAX_PARALLELISM = ConfigOption(
        "pipeline.max-parallelism", default=128, type=int,
        description="Number of key groups (rescale granularity).")


class ExecutionOptions:
    DEVICE = ConfigOption(
        "execution.device", default="cuda", type=str,
        description="torch device the keyed state and its programs run "
        "on. 'cuda' (default) requires a CUDA card and raises without "
        "one — the port never falls back to the CPU by itself; 'cpu' "
        "runs every program's plain PyTorch version on the host.")


class BatchOptions:
    BATCH_SIZE = ConfigOption(
        "execution.micro-batch.size", default=8192, type=int,
        description="Max records per micro-batch handed to the device.")
    MAX_DISPATCH_AHEAD = ConfigOption(
        "execution.pipeline.max-dispatch-batches", default=4, type=int,
        description="How many batches of device work the task loop may "
        "dispatch ahead of completion (per-batch fences).")
    LATENCY_TARGET_MS = ConfigOption(
        "execution.micro-batch.latency-target-ms", default=0, type=int,
        description="Adaptive batch sizing (runtime/debloater.py): hold "
        "each batch's processing time to a fraction of this budget by "
        "resizing the micro-batch from the measured throughput, between "
        "execution.micro-batch.min-size and execution.micro-batch.size. "
        "0 (default) = fixed batches.")
    MIN_BATCH_SIZE = ConfigOption(
        "execution.micro-batch.min-size", default=256, type=int,
        description="Lower bound for adaptive batch sizing.")
    IN_FLIGHT_BATCHES = ConfigOption(
        "execution.pipeline.in-flight-batches", default=2, type=int,
        description="Prefetch depth of the source pump threads: each "
        "source is polled and timestamped by a thread of its own while "
        "the task loop drives the previous batches, through a queue of "
        "this many batches (the backpressure bound). <= 0 polls the "
        "sources synchronously in the task loop.")
    ASYNC_FIRES = ConfigOption(
        "execution.window.async-fires", default=True, type=bool,
        description="Dispatch window fires asynchronously: the fire "
        "program and its device->host copies run while the loop keeps "
        "ingesting; results and the covering watermark are forwarded "
        "once they land.")


class ExecutionModeOptions:
    RUNTIME_MODE = ConfigOption(
        "execution.runtime-mode", default="streaming", type=str,
        description="'streaming' (default) or 'batch'. Batch mode requires "
        "bounded sources (an unbounded one is rejected at submit), emits "
        "no intermediate watermark and no fire-deadline split: every "
        "window fires once, at the end of input, when the source's "
        "MAX_WATERMARK arrives.")
    TARGET_RECORDS_PER_SUBTASK = ConfigOption(
        "execution.batch.target-records-per-subtask", default=1_000_000,
        type=int,
        description="Adaptive batch parallelism: with "
        "execution.stage-parallelism=-1 in batch mode, each keyed stage "
        "runs ceil(source records / this target) subtasks.")


class DeploymentOptions:
    SHUFFLE_MODE = ConfigOption(
        "shuffle.mode", default="device", type=str,
        description="keyBy data plane for the mesh engine: 'device' "
        "(default) ranks, exchanges and scatters the records on the "
        "device (flink_tpu_torch/parallel/shuffle.py); 'host' buckets "
        "them into [P, B] blocks on the host (bucket_by_shard).")
    SHUFFLE_HOSTS = ConfigOption(
        "shuffle.hosts", default=0, type=int,
        description="Hosts the key-group mesh spans: the (hosts, local) "
        "factorization of the shard axis. 0/1 (the default) keeps the "
        "flat exchange; > 1 routes device-mode keyBy through the "
        "two-level exchange (parallel/exchange2.py) when it divides the "
        "engine's shard count, else the flat one.")
    STAGE_PARALLELISM = ConfigOption(
        "execution.stage-parallelism", default=0, type=int,
        description="Subtask count of each keyed stage. 0 (default) runs "
        "the whole pipeline in one task; N > 0 expands the job into "
        "source subtasks and N keyed subtasks per keyed stage, threads "
        "connected through the shuffle service with key-group routing "
        "and checkpoint barriers (cluster/stage_executor.py); -1 sizes N "
        "from the data in batch mode.")
    STAGE_FALLBACK = ConfigOption(
        "execution.stage-fallback", default=False, type=bool,
        description="When execution.stage-parallelism is set but the "
        "graph shape cannot be expanded, run single-slot instead of "
        "failing the submission.")
    SOURCE_PARALLELISM = ConfigOption(
        "execution.source-parallelism", default=1, type=int,
        description="Subtask count of the source stage in stage mode. "
        "Each source subtask receives open(subtask_index, parallelism) "
        "and reads its split.")
    STAGE_MESH_DEVICES = ConfigOption(
        "execution.stage-mesh-devices", default=0, type=int,
        description="Mesh x stage composition: each keyed subtask opens "
        "its engine over this many logical shards of its own key-group "
        "range on the job's device. 0 (default) = one shard.")
    SHUFFLE_SERVICE = ConfigOption(
        "shuffle.service", default="local", type=str,
        description="Registered ShuffleService connecting subtasks: "
        "'local' (in-process bounded queues, credit-based), "
        "'sort-merge' (batch mode: partitions spill as encoded runs) or "
        "'grpc' (batches over the cluster RPC, cluster/rpc_shuffle.py).")
    SHUFFLE_CREDITS = ConfigOption(
        "shuffle.credits-per-channel", default=2, type=int,
        description="In-flight batches allowed per (producer, consumer) "
        "channel before the producer blocks.")
    LOCAL_AGG = ConfigOption(
        "execution.local-agg", default=True, type=bool,
        description="Two-phase aggregation in stage mode: pre-aggregate "
        "window contributions on the source stage before the keyed "
        "shuffle (at most one row per (key, slice) per batch). Applies "
        "when the keyed stage is an aligned window aggregation.")
    JOIN_MODE = ConfigOption(
        "join.mode", default="host", type=str,
        description="Execution plane for the DataStream interval join "
        "(KeyedStream.interval_join().between(), INNER): 'host' "
        "(default) buffers sides as columnar batches in host numpy "
        "(runtime/join_operators.py); 'device' runs the join over dual "
        "keyed row tables on the logical mesh of execution.device: both "
        "inputs ride the device exchange co-partitioned by key group, and "
        "a banded probe program gathers each batch's candidates "
        "(flink_tpu_torch/joins/). A failure on the device path fails the "
        "job; it never continues on the host operator.")
    CEP_MODE = ConfigOption(
        "cep.mode", default="host", type=str,
        description="Execution plane for SQL MATCH_RECOGNIZE: 'host' "
        "(default) runs each key's NFA on the host operator "
        "(cep/operator.py); 'device' runs the pattern on the device NFA "
        "engine (MeshCepOperator) when it compiles to the device, and "
        "otherwise plans the host operator with a counted "
        "record_host_fallback.")


class StateOptions:
    TABLE_EXEC_OVER_ENGINE = ConfigOption(
        "table.exec.over.engine", default="auto", type=str,
        description="Compute engine for OVER windowed aggregations: "
        "'device' = one torch program on execution.device computes every "
        "frame of every key per fire (float64 prefix sums, segmented "
        "scans, one global searchsorted; runtime/over_device.py); 'host' "
        "= per-key-segment NumPy prefix scans (runtime/over_agg.py); "
        "'auto' (default) = device when the frame family supports it "
        "(bounded RANGE MIN/MAX stays host). The port computes float64 on "
        "every device, so its 'auto' is the reference's 'auto' under x64.")
    TABLE_EXEC_STATE_TTL = ConfigOption(
        "table.exec.state.ttl", default=0, type=int,
        description="Idle-state retention for SQL operators, in ms: a "
        "GROUP BY accumulator or upsert-materializer key untouched this "
        "long is dropped (slot freed, snapshots shrink); a later arrival "
        "re-INSERTs. 0 (default) keeps state forever.")
    SLOT_CAPACITY = ConfigOption(
        "state.slot-table.capacity", default=1 << 20, type=int,
        description="Slot capacity per key-group shard of the keyed "
        "window state (grows by doubling).")
    MAX_DEVICE_SLOTS = ConfigOption(
        "state.slot-table.max-device-slots", default=0, type=int,
        description="Device-resident slot budget per keyed state (device "
        "memory bound). 0 = unbounded (grow by doubling). When the budget "
        "is reached, cold namespaces spill to host memory and reload "
        "transparently on access. Above parallelism 1 it is per shard of "
        "the logical mesh: the window engine spills whole namespaces "
        "(window slices), the session engine pages of rows.")
    WINDOW_LAYOUT = ConfigOption(
        "state.window-layout", default="auto", type=str,
        description="Keyed window state layout at parallelism 1: 'slots' "
        "((key, slice) slot table — the general engine, with the spill "
        "tier), 'panes' (ring of slices x stable key columns, dense on the "
        "device: fires are device reductions with no per-fire slot matrix; "
        "aligned windows without a spill tier, "
        "flink_tpu_torch/state/pane_table.py), or 'auto' (resolves to "
        "'slots', as in the reference).")
    SPILL_DIR = ConfigOption(
        "state.spill.dir", default=None, type=str,
        description="Filesystem tier for spilled state (a local path or "
        "file://; other schemes are not ported). None = spill stays in "
        "host memory.")
    SPILL_HOST_MAX_BYTES = ConfigOption(
        "state.spill.host-max-bytes", default=0, type=int,
        description="Host-memory budget for spilled namespaces before they "
        "overflow to state.spill.dir. 0 = unbounded host tier.")
    CHECKPOINT_DIR = ConfigOption(
        "state.checkpoints.dir", default=None, type=str,
        description="Directory for checkpoint snapshots.")
    NUM_RETAINED = ConfigOption(
        "state.checkpoints.num-retained", default=3, type=int,
        description="Completed checkpoints to keep on disk (the "
        "reference's state.checkpoints.num-retained). Retention anchors "
        "on the newest checkpoints that pass CRC verification and keeps "
        "every incremental base they need.")
    BACKEND = ConfigOption(
        "state.backend", default="tpu-slot-table", type=str,
        description="Keyed-state backend: 'tpu-slot-table' keeps the "
        "accumulators on execution.device (the card), with the spill "
        "tier beyond it; 'host-heap' places them on the CPU "
        "(torch.device('cpu')); state/backends.py register_state_backend "
        "adds third-party placements. Placements apply at parallelism 1.")


class MemoryOptions:
    DEVICE_MEMORY_BUDGET = ConfigOption(
        "memory.device.size", default=0, type=int,
        description="Managed device-memory budget in bytes (0: "
        "unlimited). Every stateful operator's device state reserves its "
        "footprint from one pool per job at creation and growth; a "
        "reservation past the budget fails naming every owner "
        "(core/memory.py).")


class AutoscaleOptions:
    """Elastic rescaling of mesh-sharded keyed operators: a DS2-style
    policy ticking inside the task loop, LIVE key-group migration between
    logical shard counts (``autoscale/``)."""

    ENABLED = ConfigOption(
        "autoscale.enabled", default=False, type=bool,
        description="Tick a scaling policy inside the task loop and "
        "LIVE-rescale mesh-sharded keyed operators (no stop-redeploy). "
        "Requires an operator running a mesh engine (parallelism > 1).")
    INTERVAL_MS = ConfigOption(
        "autoscale.interval-ms", default=1000, type=int,
        description="Policy sampling/decision interval.")
    UTILIZATION_TARGET = ConfigOption(
        "autoscale.utilization-target", default=0.7, type=float,
        description="Size the operator so busy fraction lands here; the "
        "headroom absorbs bursts without rescaling (DS2 utilization).")
    MIN_SHARDS = ConfigOption(
        "autoscale.min-shards", default=1, type=int,
        description="Lower bound on the logical shard count.")
    MAX_SHARDS = ConfigOption(
        "autoscale.max-shards", default=0, type=int,
        description="Upper bound on the logical shard count; 0 = the "
        "stated default (parallel/mesh.py logical_shard_ceiling: 8, or "
        "the engine's shard count if larger). Always bounded by "
        "max_parallelism and the engine's key-group range; never by the "
        "number of cards.")
    COOLDOWN_MS = ConfigOption(
        "autoscale.cooldown-ms", default=30_000, type=int,
        description="Minimum time between rescales.")
    HYSTERESIS = ConfigOption(
        "autoscale.hysteresis", default=0.25, type=float,
        description="Relative dead band: targets within this fraction of "
        "the current size are noise and ignored.")
    IMBALANCE_LIMIT = ConfigOption(
        "autoscale.imbalance-limit", default=2.0, type=float,
        description="Refuse to scale DOWN while max/mean resident rows "
        "per shard exceeds this — a hot shard under key skew is not "
        "spare capacity.")
    FIRE_BREACH_TICKS = ConfigOption(
        "autoscale.fire-breach-ticks", default=3, type=int,
        description="Consecutive policy ticks the fire-latency p99 must "
        "exceed latency.fire-deadline-ms before the fire-latency signal "
        "triggers a scale-up.")


class LatencyOptions:
    """The fire-latency tier: a watermark fire costs a bounded delta, not a
    full-window harvest, and never queues behind a whole ingest batch."""

    FIRE_DEADLINE_MS = ConfigOption(
        "latency.fire-deadline-ms", default=0, type=int,
        description="Fire-latency budget in wall-clock ms. When > 0 the "
        "task loop splits each ingest micro-batch against this budget "
        "using the measured per-record rate, advancing the watermark and "
        "harvesting landed async fires between the splits (the output is "
        "the unsplit run's). 0 (default) = whole batches.")
    PANE_PREAGG = ConfigOption(
        "latency.pane-preagg", default=True, type=bool,
        description="Incremental pane pre-aggregation for "
        "state.window-layout=panes: per-window running partials combined "
        "at absorb, so a fire gathers ONE partial ring row instead of "
        "merging the window's k slice rows (the full-window harvest, "
        "which stays the fallback and is the path for false). Float sums "
        "fold in record order rather than per-slice order, so float32 "
        "results can differ from the full harvest in the last ulp.")


class ServingOptions:
    """The queryable-state read path (``tenancy/serving.py``). The read
    replica decouples lookups from ingest: mesh engines publish a bounded
    delta at watermark boundaries into a double-buffered device-resident
    replica (``tenancy/replica.py``), serving workers resolve misses
    against the SEALED generation off the task loop, and the host hot-row
    cache absorbs repeat traffic without touching the device."""

    REPLICA = ConfigOption(
        "serving.replica", default=True, type=bool,
        description="Arm the read replica for jobs submitted to a "
        "tenancy session cluster: mesh engines publish a boundary delta "
        "per watermark (one device-to-device copy, no device-to-host "
        "copy) and lookups resolve against the sealed generation. false "
        "= every lookup takes the control-queue path, served behind the "
        "owning job's batch boundaries. Plain LocalExecutor runs never "
        "arm a replica.")
    PUBLISH_INTERVAL_MS = ConfigOption(
        "serving.replica.publish-interval-ms", default=0, type=int,
        description="Minimum milliseconds between replica publishes. 0 "
        "publishes at every watermark boundary; > 0 batches boundaries "
        "under one publish (lookup staleness stays <= the interval plus "
        "one boundary).")


class CheckpointOptions:
    INTERVAL_MS = ConfigOption(
        "execution.checkpointing.interval-ms", default=0, type=int,
        description="Checkpoint interval; 0 disables periodic checkpoints.")
    EVERY_N_BATCHES = ConfigOption(
        "execution.checkpointing.every-n-source-batches", default=0, type=int,
        description="Deterministic trigger: checkpoint every N source "
        "batches (tests/benchmarks; 0 = use the time interval). The stage "
        "executor cuts at exactly every N-th batch only when the job has "
        "one source subtask; with several it polls their summed batch "
        "count every 10 ms, so a checkpoint may come later than its N-th "
        "batch or not at all before the sources end.")
    RETAINED = ConfigOption(
        "execution.checkpointing.retained", default=3, type=int,
        description="How many completed checkpoints to keep (the legacy "
        "key: state.checkpoints.num-retained wins when set).")
    COMPRESSION = ConfigOption(
        "execution.checkpointing.compression", default=True, type=bool,
        description="Compress snapshot arrays (zlib inside .npz).")
    INCREMENTAL = ConfigOption(
        "execution.checkpointing.incremental", default=False, type=bool,
        description="Write delta checkpoints (dirty rows + tombstones) "
        "between periodic full snapshots.")
    FULL_EVERY = ConfigOption(
        "execution.checkpointing.incremental.full-every", default=10,
        type=int,
        description="Consolidate: every Nth checkpoint is a full snapshot, "
        "bounding restore-chain length.")
    UNALIGNED = ConfigOption(
        "execution.checkpointing.unaligned", default=False, type=bool,
        description="Barriers overtake in-flight data; overtaken batches "
        "are persisted as channel state, so a checkpoint completes in "
        "bounded time under backpressure. Savepoints stay aligned. Stage "
        "executor only.")


def retained_checkpoints(config) -> int:
    """Checkpoints to keep on disk: ``state.checkpoints.num-retained``
    wins when set; else the legacy ``execution.checkpointing.retained``
    holds. The one copy of the precedence rule, read by both
    executors."""
    if config.contains(StateOptions.NUM_RETAINED) or \
            not config.contains(CheckpointOptions.RETAINED):
        return config.get(StateOptions.NUM_RETAINED)
    return config.get(CheckpointOptions.RETAINED)


class WatchdogOptions:
    """The device watchdog (``runtime/watchdog.py``): deadline-tracked
    device interactions on the mesh engines and shard quarantine."""

    ENABLED = ConfigOption(
        "watchdog.enabled", default=False, type=bool,
        description="Wrap the mesh engines' synchronising device "
        "interactions (fence waits, harvests) in deadline-tracked "
        "sections; a shard past its miss budget, or one the device.lost "
        "fault point kills, is declared dead at the next batch boundary "
        "(ShardFailedError leaves execute()).")
    DEADLINE_MS = ConfigOption(
        "watchdog.deadline-ms", default=0, type=int,
        description="A device interaction slower than this records a "
        "deadline miss against its shard(s); 0 tracks heartbeats only.")
    MAX_MISSES = ConfigOption(
        "watchdog.max-misses", default=3, type=int,
        description="Consecutive deadline misses a shard survives before "
        "it is declared dead.")


class RestartOptions:
    """reference: RestartStrategyOptions (restart-strategy.* keys)."""

    STRATEGY = ConfigOption(
        "restart-strategy.type", default="fixed-delay", type=str,
        description="none | fixed-delay | exponential-delay | failure-rate.")
    MAX_ATTEMPTS = ConfigOption(
        "restart-strategy.max-attempts", default=3, type=int)
    DELAY_MS = ConfigOption(
        "restart-strategy.delay-ms", default=100, type=int)
    MAX_BACKOFF_MS = ConfigOption(
        "restart-strategy.exponential-delay.max-backoff-ms",
        default=60_000, type=int,
        description="Backoff ceiling for exponential-delay.")
    BACKOFF_MULTIPLIER = ConfigOption(
        "restart-strategy.exponential-delay.backoff-multiplier",
        default=2.0, type=float)
    JITTER_FACTOR = ConfigOption(
        "restart-strategy.exponential-delay.jitter-factor",
        default=0.0, type=float,
        description="Spread each backoff by +/- this fraction "
        "(thundering-herd protection across concurrent restarts).")
    RESET_BACKOFF_THRESHOLD_MS = ConfigOption(
        "restart-strategy.exponential-delay.reset-backoff-threshold-ms",
        default=0, type=int,
        description="After this long without failures the backoff and "
        "attempt budget reset to initial (0 = never reset).")
    FAILURE_RATE_INTERVAL_MS = ConfigOption(
        "restart-strategy.failure-rate.failure-rate-interval-ms",
        default=60_000, type=int,
        description="Sliding window for failure-rate counting.")


class ClusterOptions:
    NUM_TASK_EXECUTORS = ConfigOption(
        "cluster.task-executors", default=1, type=int)
    SLOTS_PER_EXECUTOR = ConfigOption(
        "taskmanager.numberOfTaskSlots", default=1, type=int)
    HEARTBEAT_INTERVAL_MS = ConfigOption(
        "heartbeat.interval-ms", default=500, type=int)
    HEARTBEAT_TIMEOUT_MS = ConfigOption(
        "heartbeat.timeout-ms", default=5000, type=int)
    REST_PORT = ConfigOption(
        "rest.port", default=0, type=int,
        description="REST status endpoint port; 0 = ephemeral, -1 = off.")
    RPC_PORT = ConfigOption(
        "rpc.port", default=0, type=int,
        description="Control-plane RPC port (0 = ephemeral). Standalone "
        "deployments pin it so TaskExecutor processes can join "
        "(reference: jobmanager.rpc.port).")
    RPC_BIND_ADDRESS = ConfigOption(
        "rpc.bind-address", default="127.0.0.1", type=str,
        description="Address the control-plane RPC server binds; use "
        "0.0.0.0 for cross-host standalone clusters.")
    RPC_ADVERTISED_ADDRESS = ConfigOption(
        "rpc.advertised-address", default="", type=str,
        description="Address peers use to CONNECT to this process "
        "(registered with the ResourceManager, returned in slot offers). "
        "Empty = the bind address, or the host's resolved IP when binding "
        "0.0.0.0 (reference: taskmanager.host).")


class SchedulerOptions:
    """reference: JobManagerOptions.SCHEDULER + adaptive scheduler knobs."""

    MODE = ConfigOption(
        "jobmanager.scheduler", default="default", type=str,
        description="'default' (fail fast when no resources) or 'adaptive' "
        "(wait for resources, rescale reactively on resource change).")
    RESOURCE_WAIT_TIMEOUT_MS = ConfigOption(
        "jobmanager.adaptive-scheduler.resource-wait-timeout-ms",
        default=30_000, type=int,
        description="How long WaitingForResources waits for a slot before "
        "the job fails.")
    RESOURCE_STABILIZATION_MS = ConfigOption(
        "jobmanager.adaptive-scheduler.resource-stabilization-timeout-ms",
        default=100, type=int,
        description="Settle time after a resource change before (re)acting "
        "on it.")


class HighAvailabilityOptions:
    """reference: HighAvailabilityOptions (high-availability.* keys)."""

    MODE = ConfigOption(
        "high-availability.type", default="none", type=str,
        description="'none' or 'filesystem' (file-lock leader election + "
        "persisted job graph store).")
    STORAGE_DIR = ConfigOption(
        "high-availability.storageDir", default=None, type=str,
        description="Directory for leader locks, job graph store and blobs.")
    LEASE_TIMEOUT_MS = ConfigOption(
        "high-availability.lease-timeout-ms", default=3000, type=int,
        description="Leader lease considered stale after this long without "
        "renewal.")


#: Keys the reference declares and never reads (they change nothing
#: there), so the port leaves them undeclared too: key -> why. Every key
#: the reference reads, the port reads too.
REFERENCE_KEYS_NEVER_READ = {
    "execution.checkpointing.mode":
        "the reference's checkpoints are exactly-once whatever the value",
    "execution.micro-batch.timeout-ms":
        "the reference's batches close on size or end of input only",
    "pipeline.auto-watermark-interval-ms":
        "the reference's watermarks advance once per batch",
    "pipeline.object-reuse":
        "the reference's operators never copy a batch's columns",
}

#: ``stateplane.backend.<family>`` picks the reference's Pallas or XLA
#: program per family; the port has one route per tensor device.
STATEPLANE_BACKEND_PREFIX = "stateplane.backend."


def check_unread_keys(config: Configuration) -> None:
    """Raise ``NotImplementedError`` for a ``stateplane.backend.*`` key,
    naming ROADMAP item 12h's by-design note."""
    for key in config.keys():
        if key.startswith(STATEPLANE_BACKEND_PREFIX):
            raise NotImplementedError(
                f"{key}: the port has one route per tensor device (the "
                "hand-written kernel on the card, its plain PyTorch "
                "version on the CPU), so the reference's per-family "
                "Pallas/XLA switch stays unported by design (ROADMAP.md, "
                "Queue A item 12h)")
