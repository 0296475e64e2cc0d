"""The port's checkpoint layer (``flink_tpu_torch/checkpoint``, the
executor's checkpoint loop, ``execute(restore_from=)``) on the CPU.

- Storage integrity (the counterparts of ``tests/test_chaos.py``'s
  checkpoint-integrity tests): manifest CRCs, truncation, a bit flip, a
  missing file, the fallback past corrupt checkpoints, a manifest-less
  directory, the torn-write fault point and the recoverable write/read
  faults.
- The on-disk format across the packages: a directory written by
  ``flink_tpu.checkpoint.storage`` reads equal in the port and the other
  way round, full checkpoints and incremental chains, bit for bit.
- Incremental checkpoints (``tests/test_incremental.py``): the slot
  table's delta rows and tombstones, a delta chain equal to a full
  snapshot, the incremental end-to-end restore, chain-aware retention,
  and a savepoint inside the root that must not seed a delta chain.
- The executor (``tests/test_checkpointing.py``): a job crashes after
  ~60 % of its stream and a fresh job restores from the checkpoint root;
  the union of both sinks equals the uninterrupted run, bit for bit —
  tumbling, sliding and session windows, at P=1 and P=8, incremental off
  and on. A missing checkpoint raises; retention keeps the newest.
- ``prepare_restore`` claim and no-claim (``tests/test_savepoints.py``).

Inputs come from numpy seeds. Tolerance: none.
"""

import os

import numpy as np
import pytest

from flink_tpu.checkpoint import storage as jstorage
from flink_tpu_torch import Configuration, StreamExecutionEnvironment
from flink_tpu_torch.chaos import injection as chaos
from flink_tpu_torch.chaos.injection import FaultPlan, FaultRule
from flink_tpu_torch.checkpoint import storage as tstorage
from flink_tpu_torch.checkpoint.savepoint import (
    RestoreMode,
    check_savepoint_target,
    is_savepoint,
    prepare_restore,
    write_savepoint,
)
from flink_tpu_torch.checkpoint.storage import (
    CheckpointCorruptedError,
    CheckpointStorage,
    apply_table_delta,
    read_checkpoint_chain,
    read_manifest,
    read_snapshot_dir,
    resolve_snapshot_dir,
)
from flink_tpu_torch.connectors.sinks import CollectSink
from flink_tpu_torch.connectors.sources import DataGenSource
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
from flink_tpu_torch.state.slot_table import SlotTable
from flink_tpu_torch.windowing.aggregates import SumAggregate
from flink_tpu_torch.windowing.assigners import (
    EventTimeSessionWindows,
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)

_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def assert_state_equal(got, want, path="state"):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_state_equal(g, w, f"{path}.{k}")
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, (path, k)
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{path}.{k}")
        else:
            assert g == w, (path, k)


# ----------------------------------------------------- storage integrity

def _write(root, cid, n=64):
    st = CheckpointStorage(root)
    rng = np.random.default_rng(cid)
    st.write_checkpoint(cid, "job", {"op": {
        "key_id": np.arange(n, dtype=np.int64),
        "namespace": np.arange(n, dtype=np.int64),
        "leaf_0": rng.random(n).astype(np.float32),
        "host_meta": {"positions": [cid, 1, 2]},
    }})
    return st


def test_manifest_carries_crcs_and_roundtrips(tmp_path):
    st = _write(str(tmp_path), 1)
    m = read_manifest(st._dir(1))
    assert m["file_crcs"] and all(
        isinstance(v, int) for v in m["file_crcs"].values())
    state = read_snapshot_dir(st._dir(1))
    assert len(state["op"]["key_id"]) == 64
    assert state["op"]["host_meta"] == {"positions": [1, 1, 2]}


def test_truncated_npz_detected_with_clear_error(tmp_path):
    st = _write(str(tmp_path), 1)
    npz = os.path.join(st._dir(1), "op-op.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(CheckpointCorruptedError, match="op-op.npz.*CRC32"):
        read_snapshot_dir(st._dir(1))


def test_single_bitflip_detected(tmp_path):
    st = _write(str(tmp_path), 1)
    pkl = os.path.join(st._dir(1), "op-op.meta.pkl")
    size = os.path.getsize(pkl)
    with open(pkl, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(CheckpointCorruptedError, match="corrupt"):
        read_snapshot_dir(st._dir(1))


def test_missing_file_detected(tmp_path):
    st = _write(str(tmp_path), 1)
    os.remove(os.path.join(st._dir(1), "op-op.npz"))
    with pytest.raises(CheckpointCorruptedError, match="missing"):
        read_snapshot_dir(st._dir(1))


def test_latest_checkpoint_falls_back_past_corruption(tmp_path):
    """Truncate one npz in chk-3, flip a byte in chk-2: the verified newest
    complete id falls back to chk-1."""
    root = str(tmp_path)
    st = _write(root, 1)
    _write(root, 2)
    _write(root, 3)
    npz3 = os.path.join(st._dir(3), "op-op.npz")
    with open(npz3, "r+b") as f:
        f.truncate(os.path.getsize(npz3) // 2)
    npz2 = os.path.join(st._dir(2), "op-op.npz")
    with open(npz2, "r+b") as f:
        f.seek(5)
        f.write(b"\xff")
    assert st.latest_checkpoint_id() == 3
    assert st.latest_checkpoint_id(verify=True) == 1


def test_manifestless_dir_never_counts(tmp_path):
    st = _write(str(tmp_path), 1)
    os.makedirs(os.path.join(str(tmp_path), "chk-9"))
    assert st.latest_checkpoint_id() == 1
    assert st.latest_checkpoint_id(verify=True) == 1


@pytest.mark.parametrize("kind", ["drop", "corrupt"])
def test_torn_write_fault_is_detectable(tmp_path, kind):
    """An injected torn write (rename durable, bytes not) leaves a
    checkpoint that READS as corrupt, never as state."""
    plan = FaultPlan(rules=[
        FaultRule(pattern="checkpoint.write.torn", nth=1, kind=kind)])
    with chaos.chaos_active(plan, seed=0) as c:
        st = CheckpointStorage(str(tmp_path))
        st.write_checkpoint(1, "job", {"op": {
            "key_id": np.arange(512, dtype=np.int64)}})
        assert c.faults_injected["checkpoint.write.torn"] == 1
    with pytest.raises(CheckpointCorruptedError):
        read_snapshot_dir(st._dir(1))
    assert st.latest_checkpoint_id(verify=True) is None


def test_torn_point_rejects_raise_kind(tmp_path):
    """A raise rule on checkpoint.write.torn does not fire: the point sits
    after the atomic rename, where the checkpoint is durable."""
    plan = FaultPlan(rules=[
        FaultRule(pattern="checkpoint.write.torn", nth=1)])
    with chaos.chaos_active(plan, seed=0) as c:
        st = CheckpointStorage(str(tmp_path))
        st.write_checkpoint(1, "job", {"op": {
            "key_id": np.arange(8, dtype=np.int64)}})
        assert c.faults_injected == {}
    assert len(read_snapshot_dir(st._dir(1))["op"]["key_id"]) == 8


def test_recoverable_write_and_read_faults_retry(tmp_path):
    plan = FaultPlan(rules=[
        FaultRule(pattern="checkpoint.write", nth=1, recoverable=True),
        FaultRule(pattern="checkpoint.read", nth=1, recoverable=True),
    ])
    with chaos.chaos_active(plan, seed=0) as c:
        st = CheckpointStorage(str(tmp_path))
        st.write_checkpoint(1, "job", {"op": {
            "key_id": np.arange(8, dtype=np.int64)}})
        state = read_snapshot_dir(st._dir(1))
        assert len(state["op"]["key_id"]) == 8
        assert c.retries == 2 and c.recoveries == 2
        assert c.faults_injected["checkpoint.write"] == 1
        assert c.faults_injected["checkpoint.read"] == 1


# ------------------------------------------------ the format on disk

def _states(seed, delta=False):
    rng = np.random.default_rng(seed)
    n = 300
    table = {
        "key_id": rng.integers(0, 1000, n).astype(np.int64),
        "namespace": (rng.integers(0, 5, n) * 1000).astype(np.int64),
        "key_group": rng.integers(0, 128, n).astype(np.int32),
        "leaf_0": rng.standard_normal(n).astype(np.float32),
        "leaf_1": rng.integers(0, 50, n).astype(np.int64),
    }
    if delta:
        table.update({"__delta__": np.asarray(True),
                      "freed_namespaces": np.asarray([2000], np.int64),
                      "tombstone_key_id": np.empty(0, np.int64),
                      "tombstone_namespace": np.empty(0, np.int64)})
    return {
        "3:window_agg": {
            "windower": {"table": table, "pending": [4000, 5000],
                         "watermark": 3999, "slice_last_window": {1: 2}},
            "key_values": {}, "keys_hashed": False},
        "0:DataGenSource": {"source": {"emitted": 1234}},
    }


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("writer,reader", [
    (jstorage, tstorage), (tstorage, jstorage)])
def test_checkpoint_dirs_read_equal_across_packages(writer, reader,
                                                    compress, tmp_path):
    """Full checkpoint + delta chain written by one package: the other
    reads the same states (and materializes the same chain)."""
    root = str(tmp_path / "ck")
    w = writer.CheckpointStorage(root, compress=compress)
    w.write_checkpoint(1, "job", _states(1))
    w.write_checkpoint(2, "job", _states(2, delta=True),
                       extra={"incremental": True, "base": 1})
    r = reader.CheckpointStorage(root)
    assert r.latest_checkpoint_id(verify=True) == 2
    for cid in (1, 2):
        assert_state_equal(r.read_checkpoint(cid),
                           writer.read_snapshot_dir(os.path.join(
                               root, f"chk-{cid}")))
    assert_state_equal(
        reader.read_checkpoint_chain(os.path.join(root, "chk-2")),
        writer.read_checkpoint_chain(os.path.join(root, "chk-2")))
    assert (reader.checkpoint_chain_ids(root, 2)
            == writer.checkpoint_chain_ids(root, 2) == [2, 1])


# ----------------------------------------------------------- incremental

def table_rows(tbl):
    return {(int(k), int(n)): float(v)
            for k, n, v in zip(tbl["key_id"], tbl["namespace"],
                               tbl["leaf_0"])}


def test_delta_tracks_only_dirty_rows():
    t = SlotTable(SumAggregate("v"), capacity=1024, device="cpu")
    k1 = np.array([1, 2, 3], dtype=np.int64)
    slots = t.lookup_or_insert(k1, np.full(3, 10, dtype=np.int64))
    t.scatter(slots, (np.array([1.0, 2.0, 3.0], dtype=np.float32),))
    base = t.snapshot()
    s2 = t.lookup_or_insert(np.array([2], dtype=np.int64),
                            np.array([10], dtype=np.int64))
    t.scatter(s2, (np.array([5.0], dtype=np.float32),))
    delta = t.snapshot_delta()
    assert table_rows(delta) == {(2, 10): 7.0}
    assert len(delta["freed_namespaces"]) == 0
    assert table_rows(apply_table_delta(base, delta)) == {
        (1, 10): 1.0, (2, 10): 7.0, (3, 10): 3.0}


def test_delta_tombstones_freed_namespaces_and_pairs():
    t = SlotTable(SumAggregate("v"), capacity=1024, device="cpu")
    keys = np.array([1, 2], dtype=np.int64)
    t.scatter(t.lookup_or_insert(keys, np.full(2, 10, dtype=np.int64)),
              (np.ones(2, dtype=np.float32),))
    t.scatter(t.lookup_or_insert(keys, np.full(2, 20, dtype=np.int64)),
              (np.ones(2, dtype=np.float32),))
    base = t.snapshot()
    t.free_namespaces([10])
    t.free_slots(t.index.lookup(np.array([2], np.int64),
                                np.array([20], np.int64)))
    delta = t.snapshot_delta()
    assert 10 in delta["freed_namespaces"].tolist()
    assert delta["tombstone_key_id"].tolist() == [2]
    assert delta["tombstone_namespace"].tolist() == [20]
    assert set(table_rows(apply_table_delta(base, delta))) == {(1, 20)}


@pytest.mark.parametrize("budget", [0, 1024])
def test_delta_chain_equals_full(budget):
    """A full snapshot + N deltas materializes to the final full snapshot's
    rows — with and without the namespace spill tier (spilled dirty
    namespaces travel in the deltas)."""
    t = SlotTable(SumAggregate("v"), capacity=1024, device="cpu",
                  max_device_slots=budget)
    rng = np.random.default_rng(3)
    base, deltas = None, []
    for step in range(6):
        keys = rng.integers(0, 700, 400).astype(np.int64)
        # three namespaces a batch, the window moving on: older
        # namespaces spill under the budget
        ns = (step + rng.integers(0, 3, 400)).astype(np.int64) * 10
        vals = rng.random(400).astype(np.float32)
        t.upsert(keys, ns, (vals,))
        if step == 2:
            t.free_namespaces([0])
        if step == 0:
            base = t.snapshot()
        else:
            deltas.append(t.snapshot_delta())
    if budget:
        assert len(t.spill) > 0
    materialized = base
    for d in deltas:
        materialized = apply_table_delta(materialized, d)
    assert table_rows(materialized) == table_rows(t.snapshot())


def test_delta_metadata_replaces_base_data_dicts(tmp_path):
    """Host metadata keyed by data (a session windower's intervals per key)
    is written whole in every delta, so the chain takes the delta's map —
    also when it was empty and the codec pruned it. The reference's merge
    keeps the base's keys (ROADMAP.md Queue C item R2): a session fired
    between the two checkpoints would come back after a restore."""
    def op(sessions, leaf):
        return {"op": {"windower": {
            "table": {"key_id": np.asarray([7], np.int64),
                      "namespace": np.asarray([1], np.int64),
                      "key_group": np.asarray([3], np.int32),
                      "leaf_0": np.asarray([leaf], np.float32)},
            "sessions": sessions, "next_sid": 3}}}

    base = op({7: [(0, 10, 1)], 8: [(5, 15, 2)]}, 1.0)
    for delta_sessions, want in (({7: [(0, 20, 1)]}, {7: [(0, 20, 1)]}),
                                 ({}, {})):
        root = str(tmp_path / f"ck{len(want)}")
        st = CheckpointStorage(root)
        st.write_checkpoint(1, "job", base)
        delta = op(delta_sessions, 2.0)
        delta["op"]["windower"]["table"].update({
            "__delta__": np.asarray(True),
            "freed_namespaces": np.asarray([2], np.int64)})
        st.write_checkpoint(2, "job", delta,
                            extra={"incremental": True, "base": 1})
        got = read_checkpoint_chain(os.path.join(root, "chk-2"))
        assert got["op"]["windower"].get("sessions", {}) == want
        ref = jstorage.read_checkpoint_chain(os.path.join(root, "chk-2"))
        assert 8 in ref["op"]["windower"]["sessions"]


@pytest.mark.parametrize("leaf,ok", [
    (np.asarray([1.5, -2.0], np.float64), True),      # exact in float32
    (np.asarray([0.1, 2.0], np.float64), False),      # 0.1 is not
    (np.asarray([3, 4], np.int64), True),
])
def test_restore_casts_leaves_only_without_loss(leaf, ok):
    """A snapshot leaf of another dtype restores when the cast keeps every
    value and fails loudly otherwise — as the reference's restore."""
    from flink_tpu.state.slot_table import SlotTable as JSlotTable
    from flink_tpu.windowing.aggregates import SumAggregate as JSum

    snap = {"key_id": np.asarray([1, 2], np.int64),
            "namespace": np.asarray([10, 10], np.int64),
            "key_group": np.asarray([0, 0], np.int32), "leaf_0": leaf}
    for t in (SlotTable(SumAggregate("v"), capacity=1024, device="cpu"),
              JSlotTable(JSum("v"), capacity=1024)):
        if ok:
            t.restore(snap)
            np.testing.assert_array_equal(
                t.snapshot()["leaf_0"], leaf.astype(np.float32))
        else:
            with pytest.raises(RuntimeError, match="schema incompatible"):
                t.restore(snap)


def run_windowed(tmp_path, subdir, total, extra_cfg=None, restore=None):
    cfg = {
        "execution.device": "cpu",
        "execution.micro-batch.size": 256,
        "state.checkpoints.dir": str(tmp_path / subdir),
        "execution.checkpointing.every-n-source-batches": 1,
    }
    cfg.update(extra_cfg or {})
    env = StreamExecutionEnvironment(Configuration(cfg))
    sink = CollectSink()
    (env.add_source(DataGenSource(total_records=total, num_keys=30,
                                  events_per_second_of_eventtime=10_000),
                    WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key").window(TumblingEventTimeWindows.of(1000))
        .sum("value").sink_to(sink))
    r = env.execute("inc-job", restore_from=restore)
    return sink, r


def _by_window(sink):
    return {(int(x["key"]), int(x["window_start"])): float(x["sum_value"])
            for x in sink.rows()}


INC = {"execution.checkpointing.incremental": True,
       "execution.checkpointing.incremental.full-every": 4}


def test_incremental_restore_matches_full(tmp_path):
    sink_full, _ = run_windowed(tmp_path, "full", 20_480)
    sink_inc, r = run_windowed(tmp_path, "inc", 20_480, INC)
    a, b = _by_window(sink_full), _by_window(sink_inc)
    assert a == b
    root = str(tmp_path / "inc")
    manifests = [read_manifest(os.path.join(root, d))
                 for d in os.listdir(root) if d.startswith("chk-")]
    assert any(m["extra"].get("incremental") for m in manifests)
    assert any(c["incremental"] for c in r.metrics["checkpoints"])
    # the resumed run (from the latest delta) completes the longer stream
    sink_resumed, _ = run_windowed(tmp_path, "inc", 30_720, INC,
                                   restore=root)
    res = _by_window(sink_resumed)
    assert res
    sink_oracle, _ = run_windowed(tmp_path, "oracle30", 30_720)
    # run 1's end-of-input flush fired its last window partially; the
    # resumed run fires it complete
    assert {**b, **res} == _by_window(sink_oracle)


def test_retain_keeps_chain_bases_alive(tmp_path):
    root = str(tmp_path / "inc2")
    run_windowed(tmp_path, "inc2", 15_000,
                 {"execution.checkpointing.incremental": True,
                  "execution.checkpointing.incremental.full-every": 50,
                  "state.checkpoints.num-retained": 2})
    dirs = sorted(d for d in os.listdir(root) if d.startswith("chk-"))
    latest = max(int(d[4:]) for d in dirs)
    assert read_checkpoint_chain(os.path.join(root, f"chk-{latest}"))
    full_dirs = [d for d in dirs
                 if not read_manifest(os.path.join(root, d))
                 ["extra"].get("incremental")]
    assert full_dirs, "the full base must have survived retention"


def test_savepoint_inside_root_is_not_a_delta_base(tmp_path):
    """Restoring from a savepoint that lives inside the checkpoint root
    must not seed the delta chain (its id would alias a sibling chk-<id>):
    the first checkpoint after the restore is full."""
    root = str(tmp_path / "ck")
    run_windowed(tmp_path, "ck", 10_240, INC)
    sp = os.path.join(root, "sp-in-root")
    ids = sorted(int(d[4:]) for d in os.listdir(root)
                 if d.startswith("chk-"))
    write_savepoint(sp, "inc-job",
                    read_checkpoint_chain(resolve_snapshot_dir(root)),
                    checkpoint_id=ids[-1] - 1)
    assert is_savepoint(sp)
    before = {d for d in os.listdir(root) if d.startswith("chk-")}
    run_windowed(tmp_path, "ck", 20_480, INC, restore=sp)
    new_ids = sorted(int(d[4:]) for d in os.listdir(root)
                     if d.startswith("chk-") and d not in before)
    assert new_ids
    first = read_manifest(os.path.join(root, f"chk-{new_ids[0]}"))
    assert not first["extra"].get("incremental")
    assert read_checkpoint_chain(os.path.join(root, f"chk-{new_ids[-1]}"))


# -------------------------------------------------------------- executor

class FailingMap:
    """Raises after letting ``fail_after`` records through."""

    def __init__(self, fail_after):
        self.seen = 0
        self.fail_after = fail_after

    def __call__(self, batch):
        self.seen += len(batch)
        if self.seen > self.fail_after:
            raise RuntimeError("injected failure")
        return batch


TOTAL = 30_000


def build_pipeline(env, sink, assigner, total=TOTAL, fail_after=None):
    src = DataGenSource(total_records=total, num_keys=500,
                        events_per_second_of_eventtime=10_000, seed=11)
    ds = env.from_source(
        src, WatermarkStrategy.for_bounded_out_of_orderness(0))
    fn = FailingMap(fail_after) if fail_after is not None else (lambda b: b)
    # the same name either way: the same stable id in the checkpoint
    ds = ds.map(fn, name="failmap")
    ds.key_by("key").window(assigner).sum("value").sink_to(sink)


def collect_results(sink):
    out = {}
    for r in sink.result().to_rows():
        # last write wins: a window re-fired after the restore overwrites
        out[(r["key"], r["window_start"], r["window_end"])] = \
            np.float32(r["sum_value"]).view(np.uint32)
    return out


ASSIGNERS = {
    "tumbling": lambda: TumblingEventTimeWindows.of(1000),
    "sliding": lambda: SlidingEventTimeWindows.of(2000, 1000),
    "sessions": lambda: EventTimeSessionWindows.with_gap(40),
}


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("parallelism", [1, 8])
@pytest.mark.parametrize("window", list(ASSIGNERS))
def test_crash_restore_matches_clean_run(tmp_path, window, parallelism,
                                         incremental):
    ckpt = str(tmp_path / "ckpts")
    base = {"execution.device": "cpu", "execution.micro-batch.size": 1000,
            "parallelism.default": parallelism,
            "state.slot-table.capacity": 1 << 12}
    env = StreamExecutionEnvironment(Configuration(base))
    clean_sink = CollectSink()
    build_pipeline(env, clean_sink, ASSIGNERS[window]())
    env.execute("clean")
    expected = collect_results(clean_sink)
    assert expected

    conf = Configuration({
        **base, "state.checkpoints.dir": ckpt,
        "execution.checkpointing.every-n-source-batches": 4,
        "execution.checkpointing.incremental": incremental,
        "execution.checkpointing.incremental.full-every": 2})
    env2 = StreamExecutionEnvironment(conf)
    sink2 = CollectSink()
    build_pipeline(env2, sink2, ASSIGNERS[window](),
                   fail_after=int(TOTAL * 0.6))
    with pytest.raises(RuntimeError, match="injected failure"):
        env2.execute("crashing")
    store = CheckpointStorage(ckpt)
    latest = store.latest_checkpoint_id()
    assert latest is not None
    if incremental:
        assert read_manifest(store._dir(latest))["extra"].get("incremental")

    env3 = StreamExecutionEnvironment(conf)
    sink3 = CollectSink()
    build_pipeline(env3, sink3, ASSIGNERS[window]())
    r = env3.execute("restored", restore_from=ckpt)
    assert r.metrics["restore_ms"] > 0
    assert r.metrics["records_emitted_by_sources"] < TOTAL
    got = collect_results(sink2)
    got.update(collect_results(sink3))
    assert got == expected


def test_restore_missing_checkpoint_raises(tmp_path):
    env = StreamExecutionEnvironment(Configuration({
        "execution.device": "cpu", "execution.micro-batch.size": 100}))
    build_pipeline(env, CollectSink(), TumblingEventTimeWindows.of(1000),
                   total=100)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        env.execute(restore_from=str(tmp_path / "nothing"))


def test_restore_from_environment_variable(tmp_path, monkeypatch):
    """``FLINK_TPU_RESTORE_FROM`` names the restore target when
    ``restore_from`` is not given (the reference's CLI hook)."""
    monkeypatch.setenv("FLINK_TPU_RESTORE_FROM", str(tmp_path / "nothing"))
    env = StreamExecutionEnvironment(Configuration({
        "execution.device": "cpu", "execution.micro-batch.size": 100}))
    build_pipeline(env, CollectSink(), TumblingEventTimeWindows.of(1000),
                   total=100)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        env.execute()


def test_checkpoint_retention(tmp_path):
    ckpt = str(tmp_path / "ck")
    env = StreamExecutionEnvironment(Configuration({
        "execution.device": "cpu",
        "execution.micro-batch.size": 200,
        "state.checkpoints.dir": ckpt,
        "execution.checkpointing.every-n-source-batches": 2,
        "state.checkpoints.num-retained": 2,
    }))
    build_pipeline(env, CollectSink(), TumblingEventTimeWindows.of(1000),
                   total=10_000)
    r = env.execute()
    names = [n for n in os.listdir(ckpt) if n.startswith("chk-")]
    assert len(names) <= 2
    assert len(r.metrics["checkpoints"]) == 25
    assert all(c["bytes"] > 0 for c in r.metrics["checkpoints"])


# ------------------------------------------------------------ savepoints

def _count_job(env, total):
    from flink_tpu_torch.windowing.aggregates import CountAggregate

    (env.add_source(DataGenSource(total_records=total, num_keys=50,
                                  events_per_second_of_eventtime=5_000),
                    WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key").window(TumblingEventTimeWindows.of(1000))
        .aggregate(CountAggregate()).sink_to(CollectSink()))


def _conf(ck, every=2):
    return Configuration({
        "execution.device": "cpu", "execution.micro-batch.size": 512,
        "state.checkpoints.dir": ck,
        "execution.checkpointing.every-n-source-batches": every})


def _make_savepoint(tmp_path, total=10_000):
    ck = str(tmp_path / "ck-old")
    env = StreamExecutionEnvironment(_conf(ck, every=3))
    _count_job(env, total)
    env.execute("ck-job")
    sp = str(tmp_path / "the-savepoint")
    check_savepoint_target(sp)
    write_savepoint(sp, "ck-job",
                    read_checkpoint_chain(resolve_snapshot_dir(ck)))
    with pytest.raises(FileExistsError):
        check_savepoint_target(sp)
    return sp


@pytest.mark.parametrize("mode", ["no-claim", "claim"])
def test_restore_mode_claim_and_no_claim(tmp_path, mode):
    """no-claim leaves the savepoint intact; claim deletes it once a newer
    checkpoint subsumes it."""
    sp = _make_savepoint(tmp_path)
    env = StreamExecutionEnvironment(_conf(str(tmp_path / "ck-new")))
    _count_job(env, 20_000)
    env.execute("resume", restore_from=sp, restore_mode=mode)
    assert os.path.exists(os.path.join(sp, "manifest.json")) == (
        RestoreMode.of(mode) is RestoreMode.NO_CLAIM)


def test_claim_never_deletes_own_chain(tmp_path):
    ck = str(tmp_path / "ck-own")
    env = StreamExecutionEnvironment(_conf(ck, every=3))
    _count_job(env, 5_000)
    env.execute("first")
    env2 = StreamExecutionEnvironment(_conf(ck, every=3))
    _count_job(env2, 10_000)
    env2.execute("second", restore_from=ck, restore_mode="claim")
    assert resolve_snapshot_dir(ck)
    snap_dir, claimed = prepare_restore(ck, "CLAIM", own_checkpoint_root=ck)
    assert claimed.mode is RestoreMode.CLAIM
    claimed.on_checkpoint_complete(os.path.join(ck, "chk-999"))
    assert os.path.isdir(snap_dir)  # a sibling of the own chain survives
