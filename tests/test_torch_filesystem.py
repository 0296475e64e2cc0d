"""Two-phase commit, the bucketed FileSink, the FileSource and the
'filesystem' SQL table connector of the port against the reference, on
the CPU.

The cases are those of ``tests/test_two_phase.py``, ``tests/test_file_sink.py``
and ``tests/test_filesystem_sql.py``. Each runs in both packages on the
same seeded rows, each in its own directory; the committed rows compare
byte for byte (as multisets where part-file names, which carry a random
suffix in both packages, decide the read order). The reference's failover
cases run on its MiniCluster with a restart strategy, which is ROADMAP
item 12 in the port; here the same job crashes through
``env.execute()`` and a fresh environment resumes with
``restore_from=`` in both packages, and the committed output holds every
window exactly once. The port adds a crash between a durable checkpoint
and its commit: the restore re-commits that checkpoint's parts, and no
row is committed twice.
"""

import collections
import json
import os

import numpy as np
import pytest

from tests.test_torch_sql import PKGS, assert_batches_equal


def _fs(p):
    return p.mod("connectors.filesystem")


def _tp(p):
    return p.mod("connectors.two_phase")


def _batch(p, vals, ts=None):
    rec = p.records
    return p.RecordBatch({
        "v": np.asarray(vals, dtype=np.int64),
        rec.TIMESTAMP_FIELD: np.asarray(
            ts if ts is not None else [0] * len(vals), dtype=np.int64)})


class _C:
    operator_index = 0
    max_parallelism = 128
    device = "cpu"


def both(tmp_path, fn):
    """``fn(p, directory)`` in each package, each in its own directory;
    returns {package name: result}."""
    return {name: fn(p, str(tmp_path / name)) for name, p in PKGS.items()}


def _same(out):
    assert out["port"] == out["reference"]
    return out["port"]


# ------------------------------------------------------ two-phase protocol


def test_commit_is_idempotent_and_publishes_atomically(tmp_path):
    def run(p, d):
        sink = _tp(p).ExactlyOnceFileSink(d)
        sink.open()
        sink.write(p.RecordBatch.from_pydict({"v": np.asarray([1, 2])}))
        seen = [len(sink.read_committed_rows(d))]
        committables = sink.prepare_commit()
        seen.append(len(sink.read_committed_rows(d)))
        sink.commit(committables)
        rows = sink.read_committed_rows(d)
        sink.commit(committables)          # re-commit after a failover
        return seen, rows, sink.read_committed_rows(d)

    seen, rows, again = _same(both(tmp_path, run))
    assert seen == [0, 0] and [r["v"] for r in rows] == [1, 2]
    assert again == rows


def test_lost_committable_fails_loudly(tmp_path):
    def run(p, d):
        sink = _tp(p).ExactlyOnceFileSink(d)
        sink.open()
        sink.write(p.RecordBatch.from_pydict({"v": np.asarray([1])}))
        committables = sink.prepare_commit()
        os.remove(committables[0]["pending"])
        with pytest.raises(IOError, match="committable lost"):
            sink.commit(committables)
        return True

    _same(both(tmp_path, run))


def _op(p, d):
    op = _tp(p).TwoPhaseSinkOperator(_tp(p).ExactlyOnceFileSink(d))
    op.open(_C())
    return op


def _vals(p, d):
    return sorted(r["v"] for r in
                  _tp(p).ExactlyOnceFileSink.read_committed_rows(d))


def _inprogress(d):
    return [n for n in os.listdir(d) if n.endswith(".inprogress")]


def test_restore_recommits_and_discards_unsealed(tmp_path):
    def run(p, d):
        op = _op(p, d)
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([1, 2])}))
        state = op.snapshot_state()                 # sealed, checkpointed
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([3, 4])}))
        # crash: neither commit nor another checkpoint happened
        _op(p, d).restore_state(state)
        return _vals(p, d), _inprogress(d)

    assert _same(both(tmp_path, run)) == ([1, 2], [])


def test_dispose_aborts_instead_of_committing(tmp_path):
    def run(p, d):
        op = _op(p, d)
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([1, 2])}))
        state = op.snapshot_state()
        op.notify_checkpoint_complete(1)
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([3, 4])}))
        op.dispose()                                # the crash path
        after_crash = (_vals(p, d), bool(_inprogress(d)))
        _op(p, d).restore_state(state)
        return after_crash, _vals(p, d), _inprogress(d)

    assert _same(both(tmp_path, run)) == (([1, 2], True), [1, 2], [])


def test_savepoint_then_checkpoint_commits_all_sealed(tmp_path):
    def run(p, d):
        op = _op(p, d)
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([1])}))
        op.snapshot_state()                         # savepoint: sealed
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([2])}))
        op.snapshot_state()                         # checkpoint
        op.notify_checkpoint_complete(1)
        return _vals(p, d)

    assert _same(both(tmp_path, run)) == [1, 2]


def test_crash_between_checkpoint_and_commit_recommits_once(tmp_path):
    """The checkpoint holding the sealed parts is durable but the commit
    never ran (the crash falls between them): restoring from it commits
    those parts, and a second restore (a replayed recovery) adds
    nothing."""
    def run(p, d):
        op = _op(p, d)
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([1, 2])}))
        op.snapshot_state()
        op.notify_checkpoint_complete(1)
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([3])}))
        state = op.snapshot_state()                 # durable, uncommitted
        op.process_batch(p.RecordBatch.from_pydict({"v": np.asarray([4])}))
        op.dispose()
        before = _vals(p, d)
        _op(p, d).restore_state(state)
        once = _vals(p, d)
        _op(p, d).restore_state(state)
        return before, once, _vals(p, d), _inprogress(d)

    assert _same(both(tmp_path, run)) == ([1, 2], [1, 2, 3], [1, 2, 3], [])


# --------------------------------------------------- executor failover

def _windows_job(p, env, sink, total, fail_after=None):
    """DataGen -> (a map that fails once past ``fail_after`` records) ->
    tumbling 500 ms SUM per key -> ``sink``."""
    seen = [0]

    def fail(b):
        seen[0] += len(b)
        if fail_after is not None and seen[0] > fail_after:
            raise RuntimeError("injected failure")
        return b

    src = p.mod("connectors.sources").DataGenSource(
        total_records=total, num_keys=10,
        events_per_second_of_eventtime=10_000)
    wm = p.mod("runtime.watermarks").WatermarkStrategy
    win = p.mod("windowing.assigners").TumblingEventTimeWindows
    (env.from_source(src, wm.for_bounded_out_of_orderness(0))
        .map(fail, name="poison").key_by("key").window(win.of(500))
        .sum("value").sink_to(sink))


def _file_sink(p, out):
    return _fs(p).FileSink(out, ["key", "window_start", "sum_value"],
                           fmt="json",
                           bucket_assigner=_fs(p).ColumnBucketAssigner("key"))


@pytest.mark.parametrize("parallelism", [1, 8])
def test_file_sink_exactly_once_under_failover(tmp_path, parallelism):
    total = 20_000

    def run(p, d):
        out, ck = os.path.join(d, "out"), os.path.join(d, "ck")
        cfg = {"execution.micro-batch.size": 256,
               "parallelism.default": parallelism,
               "state.checkpoints.dir": ck,
               "execution.checkpointing.every-n-source-batches": 2}
        env = p.Env(p.config(**cfg))
        _windows_job(p, env, _file_sink(p, out), total, fail_after=12_000)
        with pytest.raises(RuntimeError, match="injected failure"):
            env.execute("file-sink-failover")
        committed_at_crash = len(_fs(p).read_committed_rows(out))
        env2 = p.Env(p.config(**cfg))
        _windows_job(p, env2, _file_sink(p, out), total)
        env2.execute("file-sink-failover", restore_from=ck)
        rows = [json.loads(r) for r in _fs(p).read_committed_rows(out)]
        seen = {}
        for r in rows:
            k = (r["key"], r["window_start"])
            assert k not in seen, f"window committed twice: {k}"
            seen[k] = np.float32(r["sum_value"]).view(np.uint32).item()
        return committed_at_crash, sorted(os.listdir(out)), seen

    at_crash, buckets, seen = _same(both(tmp_path, run))
    assert 0 < at_crash < 40
    assert buckets == [str(k) for k in range(10)] and len(seen) == 40


def test_two_phase_sink_through_sink_to_commits_on_checkpoint(tmp_path):
    """``sink_to`` wraps a ``TwoPhaseCommitSink`` in
    ``TwoPhaseSinkOperator`` and the executor commits once a checkpoint
    is durable: after a crash the committed rows are exactly those of
    the windows fired before the last checkpoint, and the resumed run
    commits each window once."""
    total = 20_000

    def run(p, d):
        out, ck = os.path.join(d, "out"), os.path.join(d, "ck")
        cfg = {"execution.micro-batch.size": 256,
               "state.checkpoints.dir": ck,
               "execution.checkpointing.every-n-source-batches": 2}
        env = p.Env(p.config(**cfg))
        sink = _tp(p).ExactlyOnceFileSink(out)
        _windows_job(p, env, sink, total, fail_after=9_000)
        kinds = {t.name: type(t.operator_factory()).__name__
                 for t in env._sinks}
        with pytest.raises(RuntimeError, match="injected failure"):
            env.execute("2pc")
        at_crash = len(sink.read_committed_rows(out))
        env2 = p.Env(p.config(**cfg))
        _windows_job(p, env2, _tp(p).ExactlyOnceFileSink(out), total)
        env2.execute("2pc", restore_from=ck)
        per = collections.Counter(
            (r["key"], r["window_start"])
            for r in sink.read_committed_rows(out))
        return kinds, at_crash, per

    kinds, at_crash, per = _same(both(tmp_path, run))
    assert kinds == {"sink": "TwoPhaseSinkOperator"}
    assert at_crash > 0 and len(per) == 40 and set(per.values()) == {1}


def test_executor_crash_between_checkpoint_and_commit(tmp_path,
                                                      monkeypatch):
    """A crash after checkpoint 10 is durable but before its commit (it
    seals the parts of the second window, fired after 10,000 records):
    the restore from it commits those parts, and the whole run commits
    every window exactly once (the port's executor only)."""
    p = PKGS["port"]
    total = 20_000
    op_cls = _tp(p).TwoPhaseSinkOperator
    notify = op_cls.notify_checkpoint_complete

    def crash_on_10(self, checkpoint_id):
        if checkpoint_id == 10:
            raise RuntimeError("crash before commit")
        notify(self, checkpoint_id)

    out, ck = str(tmp_path / "out"), str(tmp_path / "ck")
    cfg = {"execution.micro-batch.size": 256, "state.checkpoints.dir": ck,
           "execution.checkpointing.every-n-source-batches": 4}
    monkeypatch.setattr(op_cls, "notify_checkpoint_complete", crash_on_10)
    env = p.Env(p.config(**cfg))
    _windows_job(p, env, _file_sink(p, out), total)
    with pytest.raises(RuntimeError, match="crash before commit"):
        env.execute("j")
    monkeypatch.setattr(op_cls, "notify_checkpoint_complete", notify)
    committed_1 = len(_fs(p).read_committed_rows(out))
    env2 = p.Env(p.config(**cfg))
    _windows_job(p, env2, _file_sink(p, out), total)
    env2.execute("j", restore_from=ck)
    rows = [json.loads(r) for r in _fs(p).read_committed_rows(out)]
    per = collections.Counter((r["key"], r["window_start"]) for r in rows)
    assert len(per) == 40 and set(per.values()) == {1}
    assert committed_1 == 10            # the first window's rows only


# ---------------------------------------------------------------- FileSink


def _committed(p, d, binary=False):
    return sorted(_fs(p).read_committed_rows(d, binary=binary))


def test_nothing_visible_before_commit(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(d, ["v"], fmt="json")
        sink.open(0)
        sink.write(_batch(p, [1, 2, 3]))
        seen = [_committed(p, d)]
        pend = sink.prepare_commit()
        seen.append(_committed(p, d))
        sink.commit(pend)
        sink.commit(pend)                       # idempotent
        return seen, _committed(p, d)

    seen, rows = _same(both(tmp_path, run))
    assert seen == [[], []]
    assert sorted(json.loads(r)["v"] for r in rows) == [1, 2, 3]


def test_datetime_bucketing_by_event_time(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(
            d, ["v"], fmt="json",
            bucket_assigner=_fs(p).DateTimeBucketAssigner("%Y-%m-%d--%H"))
        sink.open(0)
        hour = 3_600_000
        sink.write(_batch(p, [1, 2, 3], ts=[0, hour, hour]))
        sink.commit(sink.prepare_commit())
        buckets = sorted(os.listdir(d))
        return buckets, [_committed(p, os.path.join(d, b)) for b in buckets]

    buckets, rows = _same(both(tmp_path, run))
    assert buckets == ["1970-01-01--00", "1970-01-01--01"]
    assert [json.loads(r)["v"] for r in rows[0]] == [1]


def test_column_bucketing_and_rolling(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(
            d, ["v"], fmt="json",
            bucket_assigner=_fs(p).ColumnBucketAssigner("v"))
        sink.open(0)
        sink.write(_batch(p, [7, 8, 7]))
        sink.commit(sink.prepare_commit())
        rolled = os.path.join(d, "rolled")
        sink2 = _fs(p).FileSink(
            rolled, ["v"], fmt="json",
            rolling_policy=_fs(p).RollingPolicy(max_part_records=2))
        sink2.open(0)
        for i in range(5):
            sink2.write(_batch(p, [i]))
        sink2.commit(sink2.prepare_commit())
        parts = [f for f in os.listdir(rolled)
                 if not f.endswith(".inprogress")]
        return sorted(os.listdir(d)), len(parts), _committed(p, rolled)

    buckets, parts, rows = _same(both(tmp_path, run))
    assert buckets == ["7", "8", "rolled"] and parts == 3
    assert sorted(json.loads(r)["v"] for r in rows) == [0, 1, 2, 3, 4]


class _U16Le:
    """A binary format (length-prefixed framing): each value as two
    little-endian bytes, so 10 (0x0A, the newline) is a payload byte."""

    binary = True

    def __init__(self, p):
        self.p = p

    def open(self):
        pass

    def serialize_batch(self, batch):
        return [int(v).to_bytes(2, "little") for v in batch["v"].tolist()]

    def deserialize_batch(self, raw):
        return self.p.RecordBatch.from_pydict({"v": np.asarray(
            [int.from_bytes(r, "little") for r in raw], dtype=np.int64)})


def test_binary_framing_roundtrips_through_sink_and_source(tmp_path):
    """Binary rows use the u32 length-prefixed framing in both packages
    (the reference's avro cases; the port's avro format is ROADMAP item
    12, so a two-byte format stands in for it)."""
    def run(p, d):
        fmt = _U16Le(p)
        sink = _fs(p).FileSink(d, ["v"], fmt=fmt)
        sink.open(0)
        sink.write(_batch(p, [10, 7, 1000, 2570]))
        sink.commit(sink.prepare_commit())
        raw = _fs(p).read_committed_rows(d, binary=True)
        src = _fs(p).FileSource(d, fmt)
        src.open()
        got = src.poll_batch(100)["v"].tolist()
        return raw, got, src.poll_batch(100)

    raw, got, tail = _same(both(tmp_path, run))
    assert len(raw) == 4 and got == [10, 7, 1000, 2570] and tail is None


def test_avro_format_raises_naming_its_item_in_the_port(tmp_path):
    with pytest.raises(NotImplementedError, match="item 12"):
        _fs(PKGS["port"]).FileSink(str(tmp_path), ["v"], fmt="avro",
                                   types=["BIGINT"])


def test_csv_format_through_the_seam(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(d, ["v"], fmt="csv")
        sink.open(0)
        sink.write(_batch(p, [5, 6]))
        sink.commit(sink.prepare_commit())
        return [r.strip() for r in _fs(p).read_committed_rows(d)]

    assert _same(both(tmp_path, run)) == [b"5", b"6"]


def test_abort_uncommitted_cleans_inprogress_and_spares_peers(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(d, ["v"], fmt="json")
        sink.open(0)
        sink.write(_batch(p, [1]))
        pend = sink.prepare_commit()
        sink.write(_batch(p, [2]))              # unsealed leftover
        peer = _fs(p).FileSink(d, ["v"], fmt="json")
        peer.open(1)
        peer.write(_batch(p, [10]))
        peer_pend = peer.prepare_commit()       # sealed, uncommitted
        peer.write(_batch(p, [11]))             # freshly open part
        restored = _fs(p).FileSink(d, ["v"], fmt="json")
        restored.open(0)
        restored.abort_uncommitted(pend)
        restored.commit(pend)
        left = sorted(f.split("-")[1] for f in os.listdir(d)
                      if f.endswith(".inprogress"))
        peer.commit(peer_pend)
        return left, sorted(json.loads(r)["v"]
                            for r in _committed(p, d))

    assert _same(both(tmp_path, run)) == (["1", "1"], [1, 10])


def test_text_framing_rejects_raw_newlines_loudly(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(d, ["s"], fmt="csv", types=["STRING"])
        sink.open(0)
        with pytest.raises(ValueError, match="raw newline"):
            sink.write(p.RecordBatch(
                {"s": np.array(["a\nb"], dtype=object)}))
        return True

    _same(both(tmp_path, run))


# --------------------------------------------------------------- FileSource


def _deser(p, cols, types):
    return p.mod("connectors.formats").resolve_format("json", cols, types)[0]


def test_file_source_restore_survives_directory_growth(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(d, ["v"], fmt="json")
        sink.open(0)
        for v in (1, 2):
            sink.write(p.RecordBatch({"v": np.array([v])}))
            sink.commit(sink.prepare_commit())
        src = _fs(p).FileSource(d, _deser(p, ["v"], ["BIGINT"]))
        src.open(0, 1)
        first = src.poll_batch(10)["v"].tolist()
        pos = src.snapshot_position()
        sink.write(p.RecordBatch({"v": np.array([99])}))
        sink.commit(sink.prepare_commit())
        src2 = _fs(p).FileSource(d, _deser(p, ["v"], ["BIGINT"]))
        src2.open(0, 1)
        src2.restore_position(pos)
        rest = []
        while (b := src2.poll_batch(10)) is not None:
            rest.extend(b["v"].tolist())
        return sorted(first + rest)

    assert _same(both(tmp_path, run)) == [1, 2]


def test_file_source_honors_max_records_and_midfile_restore(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(d, ["v"], fmt="json")
        sink.open(0)
        sink.write(p.RecordBatch({"v": np.arange(10)}))
        sink.commit(sink.prepare_commit())
        src = _fs(p).FileSource(d, _deser(p, ["v"], ["BIGINT"]))
        src.open(0, 1)
        head = src.poll_batch(4)["v"].tolist()
        pos = src.snapshot_position()
        src2 = _fs(p).FileSource(d, _deser(p, ["v"], ["BIGINT"]))
        src2.open(0, 1)
        src2.restore_position(pos)
        got = []
        while (b := src2.poll_batch(3)) is not None:
            assert len(b) <= 3
            got.extend(b["v"].tolist())
        return head, pos["row"], got

    assert _same(both(tmp_path, run)) == ([0, 1, 2, 3], 4,
                                          [4, 5, 6, 7, 8, 9])


def test_file_source_reads_buckets_and_restores_position(tmp_path):
    def run(p, d):
        sink = _fs(p).FileSink(d, ["k", "v"], fmt="json",
                               bucket_assigner=_fs(p).ColumnBucketAssigner(
                                   "k"))
        sink.open(0)
        sink.write(p.RecordBatch({"k": np.array([1, 2, 1]),
                                  "v": np.array([10.0, 20.0, 30.0])}))
        sink.commit(sink.prepare_commit())
        deser = _deser(p, ["k", "v"], ["BIGINT", "DOUBLE"])
        src = _fs(p).FileSource(d, deser)
        src.open(0, 1)
        b = src.poll_batch(1 << 16)
        got = list(zip(b["k"].tolist(), b["v"].tolist()))
        src2 = _fs(p).FileSource(d, deser)
        src2.open(0, 1)
        src2.restore_position(src.snapshot_position())
        while (b := src2.poll_batch(1 << 16)) is not None:
            got.extend(zip(b["k"].tolist(), b["v"].tolist()))
        return sorted(got)

    assert _same(both(tmp_path, run)) == [(1, 10.0), (1, 30.0), (2, 20.0)]


# --------------------------------------------------------------------- SQL


def _seed_topic(p, topic, n=3000, keys=20):
    broker = p.FakeBroker.get("default")
    broker.create_topic(topic, 1)
    rng = np.random.default_rng(8)
    ks = rng.integers(0, keys, n).astype(np.int64)
    vs = np.round(rng.random(n), 6)
    ts = np.arange(n, dtype=np.int64) * 4
    broker.append(topic, 0, p.RecordBatch.from_pydict(
        {"key": ks, "value": vs, "ts": ts}, timestamps=ts))
    return ks, vs, ts


@pytest.mark.parametrize("parallelism", [1, 8])
def test_insert_into_filesystem_then_select_back(tmp_path, parallelism):
    """SQL aggregate -> INSERT INTO a bucketed filesystem table -> a
    second job SELECTs the committed files back: the committed rows and
    the read-back rows equal the reference's."""
    def run(p, d):
        p.FakeBroker.reset()
        ks, vs, ts = _seed_topic(p, "fs_in")
        cfg = {"execution.micro-batch.size": 500,
               "parallelism.default": parallelism}
        tenv = p.tenv(cfg)
        tenv.execute_sql(
            "CREATE TABLE fs_in (key BIGINT, value DOUBLE, ts BIGINT, "
            "WATERMARK FOR ts AS ts) "
            "WITH ('connector'='kafka', 'topic'='fs_in')")
        tenv.execute_sql(
            "CREATE TABLE warehouse (key BIGINT, window_end BIGINT, "
            f"total DOUBLE) WITH ('connector'='filesystem', 'path'='{d}', "
            "'format'='json', 'sink.bucket-by'='key')")
        tenv.execute_sql(
            "INSERT INTO warehouse SELECT key, window_end, SUM(value) AS "
            "total FROM TABLE(TUMBLE(TABLE fs_in, DESCRIPTOR(ts), INTERVAL "
            "'1' SECOND)) GROUP BY key, window_start, window_end")
        buckets = sorted(os.listdir(d))
        rows = sorted(_fs(p).read_committed_rows(d))
        tenv2 = p.tenv(cfg)
        tenv2.execute_sql(
            "CREATE TABLE warehouse (key BIGINT, window_end BIGINT, "
            f"total DOUBLE) WITH ('connector'='filesystem', 'path'='{d}', "
            "'format'='json')")
        back = tenv2.execute_sql(
            "SELECT key, window_end, total FROM warehouse").to_batch()
        order = np.lexsort((back["window_end"], back["key"]))
        return buckets, rows, back.take(order), (ks, vs, ts)

    out = both(tmp_path, run)
    assert out["port"][:2] == out["reference"][:2]
    assert_batches_equal(out["port"][2], out["reference"][2])
    buckets, rows, back, (ks, vs, ts) = out["port"]
    assert buckets == sorted(str(k) for k in set(ks.tolist()))
    oracle = collections.defaultdict(float)
    for k, v, t in zip(ks.tolist(), vs.tolist(), ts.tolist()):
        oracle[(k, (t // 1000 + 1) * 1000)] += v
    got = {(r["key"], r["window_end"]): r["total"]
           for r in map(json.loads, rows)}
    assert set(got) == set(oracle)
    # float32 SUM leaves against a float64 oracle, ~250 adds a window
    assert max(abs(got[k] - oracle[k]) for k in oracle) < 1e-4
    assert len(back) == len(oracle)
