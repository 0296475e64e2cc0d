"""Typed configuration (port of ``flink_tpu/core/config.py``).

The options the ported paths read are carried under the reference's keys
and defaults, plus the port's own ``execution.device``. Reference keys the
port does not read are listed in ``UNREAD_KEYS`` with the values the port
already behaves as: ``check_unread_keys`` (called at ``execute()``)
raises for any other value, naming the ROADMAP item, so no such key is
ignored without a word.
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
        "device (flink_tpu_torch/parallel/shuffle.py). 'host' is not "
        "ported yet.")
    SHUFFLE_HOSTS = ConfigOption(
        "shuffle.hosts", default=0, type=int,
        description="Hosts the key-group mesh spans (the reference's "
        "two-level exchange). The port runs one flat logical mesh on one "
        "device; a value > 0 raises at execute() (ROADMAP item 12h).")
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
        "'local' (in-process bounded queues, credit-based) or "
        "'sort-merge' (batch mode: partitions spill as encoded runs).")
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
    ENABLED = ConfigOption(
        "autoscale.enabled", default=False, type=bool,
        description="The reference's live rescaling of mesh operators. "
        "Not ported: true raises at execute() (ROADMAP item 12g).")


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


class CheckpointOptions:
    INTERVAL_MS = ConfigOption(
        "execution.checkpointing.interval-ms", default=0, type=int,
        description="Checkpoint interval; 0 disables periodic checkpoints.")
    EVERY_N_BATCHES = ConfigOption(
        "execution.checkpointing.every-n-source-batches", default=0, type=int,
        description="Deterministic trigger: checkpoint every N source "
        "batches (tests/benchmarks; 0 = use the time interval).")
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


#: Reference keys the port does not read, each with the values the port
#: already behaves as and the ROADMAP item that would honour the rest.
#: ``check_unread_keys`` raises at execute() for any other value, so no
#: such key is dropped without a word.
UNREAD_KEYS = (
    (AutoscaleOptions.ENABLED, lambda v: not v, "live autoscaling", "12g"),
    (DeploymentOptions.SHUFFLE_HOSTS, lambda v: v <= 0,
     "the two-level exchange", "12h"),
)

#: ``stateplane.backend.<family>`` picks the reference's Pallas or XLA
#: program per family; the port has one route per tensor device.
STATEPLANE_BACKEND_PREFIX = "stateplane.backend."


def check_unread_keys(config: Configuration) -> None:
    """Raise ``NotImplementedError`` for every reference key in ``config``
    set to a value the port cannot honour, naming its ROADMAP item."""
    for key in config.keys():
        if key.startswith(STATEPLANE_BACKEND_PREFIX):
            raise NotImplementedError(
                f"{key}: the port has one route per tensor device (the "
                "hand-written kernel on the card, its plain PyTorch "
                "version on the CPU), so the reference's per-family "
                "Pallas/XLA switch is rejected (ROADMAP.md, Queue A item "
                "12h and Queue B)")
    for option, honoured, feature, item in UNREAD_KEYS:
        if option.key in config.keys() and not honoured(config.get(option)):
            raise NotImplementedError(
                f"{option.key}={config.get(option)!r}: {feature} is not "
                f"ported to flink_tpu_torch yet (ROADMAP.md, Queue A item "
                f"{item})")
