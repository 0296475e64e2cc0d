"""The port's Kafka connector, split framework and formats against the
reference, on the CPU.

Each scenario runs in both packages (``FakeBroker``, ``KafkaSource`` over
``SplitSource``, ``KafkaSink``, ``formats.py``, and the pipelines and SQL
jobs over them on ``execution.device: cpu``) and compares what comes out
batch by batch, every column bit for bit: fetched batches and offsets,
the split assignment, snapshot positions, windowed sums, sink topics,
raw JSON bytes. The cases are those of ``tests/test_kafka.py``,
``tests/test_source_v2.py`` and ``tests/test_formats.py``; a crash and
``restore_from=`` of a Kafka job checks that the offsets ride the port's
checkpoints (exactly once against the reference's uninterrupted run).
"""

import json

import numpy as np
import pytest

from tests.test_torch_mesh_sessions import _bits
from tests.test_torch_sql import (  # noqa: F401 (autouse fixture)
    PKGS,
    assert_batches_equal,
    fresh_brokers,
)


def deep_equal(a, b, path="$"):
    """Structural equality with arrays (and RecordBatches) bit for bit."""
    if hasattr(a, "columns") and hasattr(b, "columns"):
        assert_batches_equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            deep_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            deep_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        if a.dtype == object:
            assert a.tolist() == b.tolist(), path
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)
    else:
        assert a == b or (a != a and b != b), path


def both(scenario):
    """Run ``scenario(pkg)`` in each package; hold the port's result to
    the reference's; return the port's."""
    out = {n: scenario(p) for n, p in PKGS.items()}
    deep_equal(out["port"], out["reference"])
    return out["port"]


def _produce(p, topic, n=5000, keys=50, parts=4, broker="default",
             start_i=0):
    rows = [{"key": i % keys, "value": float(i % 97) / 7.0,
             "ts": (start_i + i) * 2} for i in range(n)]
    p.FakeBroker.get(broker).produce_rows(
        topic, rows, partition_by="key", num_partitions=parts,
        timestamp_field="ts")
    return rows


def _drain(src, size):
    out = []
    while True:
        b = src.poll_batch(size)
        if b is None:
            return out
        if len(b):
            out.append(b)


# ---------------------------------------------------------------- broker


def test_broker_append_fetch_offsets():
    def scenario(p):
        b = p.FakeBroker.get()
        b.create_topic("t", 2)
        bases = (b.append("t", 0, p.RecordBatch.from_pydict(
            {"x": np.arange(5)})), b.append("t", 0, p.RecordBatch.from_pydict(
                {"x": np.arange(5, 9)})))
        batch, nxt = b.fetch("t", 0, 2, 4)
        none, nxt2 = b.fetch("t", 0, 9, 10)
        return [bases, batch, nxt, none is None, nxt2,
                b.end_offset("t", 0), b.end_offset("t", 1)]

    out = both(scenario)
    assert out[0] == (0, 5) and out[2] == 6 and out[5] == 9
    np.testing.assert_array_equal(out[1]["x"], [2, 3, 4, 5])


def test_produce_rows_partitions_like_the_reference():
    def scenario(p):
        _produce(p, "t", n=777, keys=13, parts=5)
        b = p.FakeBroker.get()
        return [b.fetch("t", part, 0, 10_000)[0] for part in range(5)]

    both(scenario)


# ---------------------------------------------------------------- source


@pytest.mark.parametrize("size", [97, 500, 4096])
def test_reads_all_partitions_in_the_reference_order(size):
    def scenario(p):
        _produce(p, "t1", n=3000, parts=4)
        src = p.kafka.KafkaSource("t1", timestamp_field="ts")
        src.open(0, 1)
        return _drain(src, size)

    out = both(scenario)
    assert sum(len(b) for b in out) == 3000


def test_partition_rebalance_on_parallelism_change():
    def scenario(p):
        _produce(p, "t2", n=100, parts=6)
        owned = {}
        for P in (2, 3):
            owned[P] = []
            for sub in range(P):
                s = p.kafka.KafkaSource("t2")
                s.open(sub, P)
                owned[P].append(sorted(
                    st.split.split_id for st in s._states.values()))
        return owned

    owned = both(scenario)
    assert owned[2][0] == ["t2-0", "t2-2", "t2-4"]
    assert owned[3][1] == ["t2-1", "t2-4"]


def test_unbounded_discovers_new_partitions():
    def scenario(p):
        _produce(p, "t3", n=200, parts=2)
        src = p.kafka.KafkaSource("t3", bounded=False)
        src.open(0, 1)
        got = []
        for _ in range(50):
            batch = src.poll_batch(100)
            if batch is not None and len(batch):
                got.append(batch)
            if sum(len(b) for b in got) >= 200:
                break
        p.FakeBroker.get().add_partitions("t3", 3)
        p.FakeBroker.get().append("t3", 2, p.RecordBatch.from_pydict(
            {"key": np.arange(7), "value": np.ones(7), "ts": np.arange(7)}))
        for _ in range(50):
            batch = src.poll_batch(100)
            if batch is not None and len(batch):
                got.append(batch)
            if sum(len(b) for b in got) >= 207:
                break
        return got

    assert sum(len(b) for b in both(scenario)) == 207


@pytest.mark.parametrize("polls", [1, 4, 9])
def test_offsets_survive_snapshot_restore(polls):
    def scenario(p):
        _produce(p, "t4", n=2000, parts=3)
        src = p.kafka.KafkaSource("t4")
        src.open(0, 1)
        seen = []
        for _ in range(polls):
            b = src.poll_batch(123)
            if b is not None and len(b):
                seen.append(b)
        pos = src.snapshot_position()
        restored = p.kafka.KafkaSource("t4")
        restored.open(0, 1)
        restored.restore_position(pos)
        return [seen, pos, _drain(restored, 321)]

    seen, _, rest = both(scenario)
    assert sum(map(len, seen)) + sum(map(len, rest)) == 2000


def test_split_source_coordinator_and_enumerator_state():
    def scenario(p):
        sv2 = p.mod("connectors.source_v2")
        c = sv2.SourceCoordinator(parallelism=3)
        splits = [sv2.SourceSplit(f"s{i}") for i in range(7)]
        a = c.assign(splits)
        c2 = sv2.SourceCoordinator(parallelism=3)
        c2.restore_state(c.snapshot_state())
        return [a, c2.assign(splits), c.snapshot_state(),
                [s.split_id for s in c.splits_for(1, splits)]]

    out = both(scenario)
    assert sorted(out[0].values()) == [0, 0, 0, 1, 1, 2, 2]


def _write_file(p, path, start, n, step=1000):
    sink = p.mod("connectors.sinks").BinaryFileSink(str(path))
    sink.open()
    sink.write(p.RecordBatch.from_pydict(
        {"k": np.arange(start, start + n) % 7, "v": np.ones(n),
         "ts": np.arange(start, start + n) * step}))
    sink.close()


def test_file_source_splits_checkpoint_restore(tmp_path):
    def scenario(p):
        d = tmp_path / p.name
        d.mkdir()
        for i in range(4):
            _write_file(p, d / f"p{i}.ftb", i * 50, 25)
        sv2 = p.mod("connectors.source_v2")
        src = sv2.file_source(str(d / "p*.ftb"), timestamp_field="ts")
        src.open()
        seen = [src.poll_batch(100) for _ in range(2)]
        snap = src.snapshot_position()
        src.close()
        src2 = sv2.file_source(str(d / "p*.ftb"), timestamp_field="ts")
        src2.restore_position(snap)
        src2.open()
        rest = _drain(src2, 100)
        src2.close()
        return [seen, rest, src2.current_watermark()]

    seen, rest, _ = both(scenario)
    ts = np.concatenate([b["ts"] for b in seen + rest])
    assert len(ts) == 100 and len(set(ts.tolist())) == 100


def test_alignment_and_idleness_follow_the_reference():
    def scenario(p):
        sv2 = p.mod("connectors.source_v2")
        Source = p.mod("connectors.sources").Source

        class Scripted(Source):
            def __init__(self, ts_list):
                self.batches = [p.RecordBatch.from_pydict(
                    {"ts": [t]}, timestamps=[t]) for t in ts_list]

            def poll_batch(self, max_records):
                return self.batches.pop(0) if self.batches else None

        class Stalled(Source):
            def poll_batch(self, max_records):
                return p.RecordBatch({})

        def enum(ids, bounded):
            class E(sv2.FileSplitEnumerator):
                def __init__(self):
                    self._done, self.bounded = False, bounded

                def discover(self):
                    if self._done:
                        return []
                    self._done = True
                    return [sv2.SourceSplit(i) for i in ids]

                def snapshot_state(self):
                    return {}
            return E()

        readers = {"slow": Scripted([0, 10, 20, 30]),
                   "fast": Scripted([0, 1000, 2000, 3000])}
        src = sv2.SplitSource(enum(["slow", "fast"], True),
                              lambda s: readers[s.split_id],
                              alignment_max_drift_ms=500)
        src.open()
        emitted = [int(b.timestamps[0]) for b in _drain(src, 10)]
        now = [0.0]
        r2 = {"stalled": Stalled(), "flowing": Scripted(
            [1000 * (i + 1) for i in range(8)])}
        idle = sv2.SplitSource(enum(["stalled", "flowing"], False),
                               lambda s: r2[s.split_id],
                               idle_timeout_ms=5_000, clock=lambda: now[0])
        idle.open()
        wms = []
        for i in range(6):
            if i == 4:
                now[0] = 10.0
            idle.poll_batch(10)
            wms.append(idle.current_watermark())
        return [emitted, wms]

    emitted, wms = both(scenario)
    assert emitted.index(2000) > emitted.index(30)
    assert wms[3] is None and wms[4] is not None


# ------------------------------------------------------------- pipelines


def _window_job(p, topic, batch, extra=None):
    env = p.Env(p.config(**{"execution.micro-batch.size": batch,
                            **(extra or {})}))
    src = p.kafka.KafkaSource(topic, timestamp_field="ts")
    sink = p.CollectSink()
    assigners = p.mod("windowing.assigners")
    (env.from_source(src, src.watermark_strategy(0))
     .key_by("key").window(assigners.TumblingEventTimeWindows.of(1000))
     .sum("value").sink_to(sink))
    return env, sink


def test_windowed_sum_over_kafka_equals_reference():
    def scenario(p):
        _produce(p, "t5", n=6000, keys=40, parts=4)
        env, sink = _window_job(p, "t5", 777)
        env.execute("kafka-window")
        return sink.result()

    out = both(scenario)
    assert len(out) > 0


def test_crash_restore_is_exactly_once(tmp_path):
    """The port's Kafka job crashes mid-stream and resumes from its last
    checkpoint: the offsets in the checkpoint replay exactly the records
    after it, so the union of both runs' windows equals the reference's
    uninterrupted run, bit for bit."""
    from tests.test_checkpointing import FailingMap

    def want_scenario():
        p = PKGS["reference"]
        _produce(p, "t6", n=8000, keys=60, parts=4)
        env, sink = _window_job(p, "t6", 500)
        env.execute("whole")
        return {(r["key"], r["window_end"]): r["sum_value"]
                for r in sink.rows()}

    want = want_scenario()
    p = PKGS["port"]
    _produce(p, "t6", n=8000, keys=60, parts=4)
    conf = {"execution.micro-batch.size": 500,
            "state.checkpoints.dir": str(tmp_path / "ck"),
            "execution.checkpointing.every-n-source-batches": 3}

    def build(env, sink, fail_after):
        src = p.kafka.KafkaSource("t6", timestamp_field="ts")
        assigners = p.mod("windowing.assigners")
        (env.from_source(src, src.watermark_strategy(0))
         .map(FailingMap(fail_after), name="failmap")
         .key_by("key").window(assigners.TumblingEventTimeWindows.of(1000))
         .sum("value").sink_to(sink))

    env = p.Env(p.config(**conf))
    s1 = p.CollectSink()
    build(env, s1, 4000)
    with pytest.raises(RuntimeError, match="injected"):
        env.execute("crashing")
    env2 = p.Env(p.config(**conf))
    s2 = p.CollectSink()
    build(env2, s2, 10**12)
    env2.execute("restored", restore_from=str(tmp_path / "ck"))
    got = {}
    for r in s1.rows() + s2.rows():
        got[(r["key"], r["window_end"])] = r["sum_value"]
    assert set(got) == set(want)
    for k in want:
        assert np.float32(got[k]).view(np.uint32) == \
            np.float32(want[k]).view(np.uint32), k


def test_kafka_sink_roundtrip_equals_reference():
    def scenario(p):
        _produce(p, "t7", n=1000, keys=10, parts=2)
        env = p.Env(p.config(**{"execution.micro-batch.size": 300}))
        src = p.kafka.KafkaSource("t7", timestamp_field="ts")
        env.from_source(src, src.watermark_strategy(0)) \
           .sink_to(p.kafka.KafkaSink("t7-out", partition_by="key",
                                      num_partitions=3))
        env.execute("copy")
        b = p.FakeBroker.get()
        return [b.fetch("t7-out", part, 0, 10_000)[0] for part in range(3)]

    assert sum(len(b) for b in both(scenario) if b is not None) == 1000


# ------------------------------------------------------------------ SQL


def _sql_table(tenv, name, topic, fmt=None):
    opts = f"'connector'='kafka', 'topic'='{topic}'" + (
        f", 'format'='{fmt}'" if fmt else "")
    tenv.execute_sql(f"CREATE TABLE {name} (key BIGINT, value DOUBLE, "
                     f"ts BIGINT, WATERMARK FOR ts AS ts) WITH ({opts})")


def test_group_by_hop_over_kafka_equals_reference():
    def scenario(p):
        _produce(p, "bids", n=6000, keys=30, parts=4)
        tenv = p.tenv({"execution.micro-batch.size": 1024})
        _sql_table(tenv, "bids", "bids")
        return tenv.execute_sql("""
            SELECT key, window_end, SUM(value) AS total
            FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts),
                           INTERVAL '1' SECOND, INTERVAL '2' SECONDS))
            GROUP BY key, window_start, window_end""").to_batch()

    assert len(both(scenario)) > 0


def test_registered_table_replays_across_queries():
    def scenario(p):
        _produce(p, "replay_t", n=500, keys=5, parts=2)
        tenv = p.tenv({"execution.micro-batch.size": 128})
        _sql_table(tenv, "replay_t", "replay_t")
        return [tenv.execute_sql("SELECT key, value FROM replay_t")
                .to_batch() for _ in range(2)]

    first, second = both(scenario)
    assert len(first) == len(second) == 500


def test_insert_into_kafka_table_equals_reference():
    def scenario(p):
        _produce(p, "src8", n=2000, keys=20, parts=2)
        tenv = p.tenv({"execution.micro-batch.size": 512})
        _sql_table(tenv, "src8", "src8")
        tenv.execute_sql(
            "CREATE TABLE out8 (key BIGINT, window_end BIGINT, "
            "total DOUBLE) WITH ('connector'='kafka', 'topic'='out8', "
            "'sink.partitions'='2', 'sink.partition-by'='key')")
        tenv.execute_sql("""
            INSERT INTO out8
            SELECT key, window_end, SUM(value) AS total
            FROM TABLE(TUMBLE(TABLE src8, DESCRIPTOR(ts),
                              INTERVAL '1' SECOND))
            GROUP BY key, window_start, window_end""")
        b = p.FakeBroker.get()
        return [b.fetch("out8", part, 0, 10_000)[0] for part in range(2)]

    assert sum(len(b) for b in both(scenario)) > 0


def test_upsert_kafka_sink_with_primary_key_equals_reference():
    def scenario(p):
        _produce(p, "src9", n=400, keys=7, parts=2)
        tenv = p.tenv({"execution.micro-batch.size": 64})
        _sql_table(tenv, "src9", "src9")
        tenv.execute_sql(
            "CREATE TABLE out9 (key BIGINT, n BIGINT, s DOUBLE, "
            "PRIMARY KEY (key) NOT ENFORCED) WITH ('connector'='kafka', "
            "'topic'='out9')")
        tenv.execute_sql("INSERT INTO out9 SELECT key, COUNT(*) AS n, "
                         "SUM(value) AS s FROM src9 GROUP BY key")
        return p.FakeBroker.get().fetch("out9", 0, 0, 100_000)[0]

    assert len(both(scenario)) > 0


# --------------------------------------------------------------- formats


def test_json_schema_deserialize_serialize_equal_reference():
    def scenario(p):
        f = p.mod("connectors.formats")
        s = f.JsonRowDeserializationSchema(
            ["k", "v", "name"], ["BIGINT", "DOUBLE", "STRING"])
        b = s.deserialize_batch([
            b'{"k": 1, "v": 2.5, "name": "x"}',
            b'{"k": 2, "v": 7, "name": "y", "extra": true}',
            b'{"k": 3, "name": "z"}'])
        skip = f.JsonRowDeserializationSchema(
            ["k"], ["BIGINT"], ignore_parse_errors=True).deserialize_batch(
            [b'{"k": 1}', b"not json", b'{"k": "abc"}', b'{"k": 2}'])
        ser = f.JsonRowSerializationSchema(["k", "v"])
        raw = ser.serialize_batch(p.RecordBatch.from_pydict(
            {"k": np.asarray([5, 6], dtype=np.int64),
             "v": np.asarray([1.5, 2.5])}))
        de, ser2 = f.resolve_format("csv", ["k", "v"], ["BIGINT", "DOUBLE"])
        csv = de.deserialize_batch(ser2.serialize_batch(
            p.RecordBatch.from_pydict({"k": np.asarray([1, 2]),
                                       "v": np.asarray([0.5, 1.5])})))
        errs = []
        for call in (lambda: f.JsonRowDeserializationSchema(
                ["k"], ["BIGINT"]).deserialize_batch([b"not json"]),
                lambda: f.resolve_format("nope", ["a"], [None])):
            with pytest.raises(Exception) as e:
                call()
            # the registered list names what a process has imported
            # (the reference's avro format registers itself on import)
            errs.append((type(e.value).__name__,
                         str(e.value).split(" (registered")[0]))
        return [b, skip, list(raw), csv, errs]

    b, skip, raw, csv, errs = both(scenario)
    assert b["k"].tolist() == [1, 2, 3] and np.isnan(b["v"][2])
    assert skip["k"].tolist() == [1, 2]
    assert "deserialize" in errs[0][1] and "unknown format" in errs[1][1]


def test_json_topic_roundtrips_through_sql():
    def scenario(p):
        broker = p.FakeBroker.get("default")
        broker.create_topic("jin", 2)
        rng = np.random.default_rng(8)
        n = 3000
        ks = rng.integers(0, 20, n).astype(np.int64)
        vs = np.round(rng.random(n), 6)
        ts = np.arange(n, dtype=np.int64) * 4
        for part in range(2):
            m = ks % 2 == part
            recs = [json.dumps({"key": int(k), "value": float(v),
                                "ts": int(t)}).encode()
                    for k, v, t in zip(ks[m], vs[m], ts[m])]
            broker.append_raw("jin", part, recs, timestamps=ts[m])
        broker.create_topic("jin2", 1)
        broker.append_raw("jin2", 0, [b'{"key": 1, "value": 2.0, "ts": 0}',
                                      b"garbage{{{",
                                      b'{"key": 2, "value": 3.0, "ts": 10}'])
        tenv = p.tenv({"execution.micro-batch.size": 500})
        _sql_table(tenv, "jin", "jin", "json")
        tenv.execute_sql(
            "CREATE TABLE jout (key BIGINT, window_end BIGINT, "
            "total DOUBLE) WITH ('connector'='kafka', 'topic'='jout', "
            "'format'='json', 'sink.partitions'='2', "
            "'sink.partition-by'='key')")
        tenv.execute_sql("""
            INSERT INTO jout
            SELECT key, window_end, SUM(value) AS total
            FROM TABLE(TUMBLE(TABLE jin, DESCRIPTOR(ts),
                              INTERVAL '1' SECOND))
            GROUP BY key, window_start, window_end""")
        tenv.execute_sql(
            "CREATE TABLE jin2 (key BIGINT, value DOUBLE, ts BIGINT, "
            "WATERMARK FOR ts AS ts) WITH ('connector'='kafka', "
            "'topic'='jin2', 'format'='json', "
            "'json.ignore-parse-errors'='true')")
        skipped = tenv.execute_sql("SELECT key, value FROM jin2").to_batch()
        raw = [broker.fetch("jout", part, 0, 100_000)[0]
               for part in range(2)]
        return [raw, skipped]

    raw, skipped = both(scenario)
    assert sum(len(b) for b in raw) > 0
    assert sorted(skipped["key"].tolist()) == [1, 2]
