"""The port's upsert materializer and upsert Kafka sink against the
reference, on the CPU.

``UpsertMaterializeOperator`` gets the same changelog batches in both
packages and its output batches and snapshots are compared bit for bit,
in order; the SQL jobs of ``tests/test_upsert_sink.py`` (an updating
GROUP BY into a PRIMARY KEY Kafka table, a sink key that differs from the
changelog key, a crash and restore) compare the raw upsert topics.
"""

import collections
import os

import numpy as np
import pytest

from tests.test_torch_kafka import both, deep_equal
from tests.test_torch_sql import PKGS, fresh_brokers  # noqa: F401


class _Ctx:
    max_parallelism = 128
    operator_index = 0
    parallelism = 1
    device = "cpu"


def _batch(p, rows):
    return p.RecordBatch.from_pydict(
        {k: np.asarray([r[k] for r in rows]) for k in rows[0]})


def _op(p, keys, **kw):
    op = p.mod("table.upsert_materializer").UpsertMaterializeOperator(
        keys, **kw)
    op.open(_Ctx())
    return op


K = "__rowkind__"
INS, UB, UA, DEL = 0, 1, 2, 3
TS = "__ts__"

#: tests/test_upsert_sink.py's operator cases: sink keys and the
#: changelog batches fed one after another
OPERATOR_CASES = {
    "collapses_changelog_to_last_row_wins": (["k"], [[
        {"k": 1, "v": 10.0, K: INS}, {"k": 1, "v": 10.0, K: UB},
        {"k": 1, "v": 20.0, K: UA}, {"k": 2, "v": 5.0, K: INS}]]),
    "update_then_delete_emits_tombstone": (["k"], [
        [{"k": 7, "v": 1.0, K: INS}],
        [{"k": 7, "v": 1.0, K: UB}, {"k": 7, "v": 2.0, K: UA}],
        [{"k": 7, "v": 2.0, K: DEL}],
        [{"k": 7, "v": 3.0, K: INS}]]),
    "unchanged_value_suppressed": (["k"], [
        [{"k": 1, "v": 4.0, K: INS}], [{"k": 1, "v": 4.0, K: UA}]]),
    "retraction_matches_despite_restamped_ts": (["v"], [
        [{"g": 2, "v": 5.0, TS: 100, K: INS},
         {"g": 1, "v": 5.0, TS: 200, K: INS}],
        [{"g": 1, "v": 5.0, TS: 999, K: UB},
         {"g": 1, "v": 6.0, TS: 999, K: UA}]]),
}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_materializer_case_equals_reference(case):
    keys, batches = OPERATOR_CASES[case]

    def scenario(p):
        op = _op(p, keys)
        return [op.process_batch(_batch(p, b)) for b in batches] + [
            op.snapshot_state()]

    out = both(scenario)
    if case == "update_then_delete_emits_tombstone":
        assert [b[0][K].tolist() for b in out[1:4]] == [[UA], [DEL], [INS]]


@pytest.mark.parametrize("seed", [0, 1])
def test_materializer_seeded_changelog_equals_reference(seed):
    """A GroupAgg changelog (two keys per sink key, deletes) through the
    materializer: every output batch and the final snapshot."""
    rng = np.random.default_rng(seed)
    batches = []
    cur = {}
    for _ in range(8):
        rows = []
        for g in rng.integers(0, 9, 12).tolist():
            new = float(rng.integers(0, 4))
            if g in cur:
                rows.append({"g": g, "v": cur[g], K: UB})
                if rng.random() < 0.2:
                    rows[-1][K] = DEL
                    del cur[g]
                    continue
                rows.append({"g": g, "v": new, K: UA})
            else:
                rows.append({"g": g, "v": new, K: INS})
            cur[g] = new
        batches.append(rows)

    def scenario(p):
        op = _op(p, ["v"])
        return [op.process_batch(_batch(p, b)) for b in batches] + [
            op.snapshot_state()]

    both(scenario)


def test_snapshot_restore_key_group_filter_equals_reference():
    def scenario(p):
        op = _op(p, ["k"])
        op.process_batch(_batch(p, [{"k": k, "v": float(k), K: INS}
                                    for k in range(50)]))
        snap = op.snapshot_state()
        kg = p.mod("state.keygroups")
        groups = kg.assign_key_groups(kg.hash_keys_to_i64(np.arange(50)),
                                      128)
        keep = {int(g) for g in groups[:25]}
        op2 = _op(p, ["k"])
        op2.restore_state(snap, key_group_filter=keep)
        return [sorted(k[0] for k in op2._rows), op2.snapshot_state()]

    kept, _ = both(scenario)
    assert 0 < len(kept) < 50


def test_ttl_expiry_equals_reference():
    def scenario(p):
        now = [0]
        op = _op(p, ["k"], ttl_ms=100, clock=lambda: now[0])
        out = []
        for t, rows in ((0, [{"k": 1, "v": 1.0, K: INS},
                             {"k": 2, "v": 2.0, K: INS}]),
                        (80, [{"k": 1, "v": 1.0, K: UB},
                              {"k": 1, "v": 3.0, K: UA}]),
                        (200, [{"k": 2, "v": 9.0, K: INS}])):
            now[0] = t
            out.append(op.process_batch(_batch(p, rows)))
        return out + [sorted(op._rows)]

    both(scenario)


# ------------------------------------------------------------------ SQL


def _produce(p, topic, n, keys):
    broker = p.FakeBroker.get("default")
    broker.create_topic(topic, 2)
    rng = np.random.default_rng(3)
    ks = rng.integers(0, keys, n).astype(np.int64)
    vs = rng.random(n).astype(np.float64)
    ts = np.arange(n, dtype=np.int64) * 10
    for part in range(2):
        m = ks % 2 == part
        broker.append(topic, part, p.RecordBatch.from_pydict(
            {"key": ks[m], "value": vs[m], "ts": ts[m]}, timestamps=ts[m]))
    return ks


def _topic(p, topic, parts):
    b = p.FakeBroker.get()
    return [b.fetch(topic, part, 0, 1 << 30)[0] for part in range(parts)]


def _compact(batches, key_col):
    current = {}
    for b in batches:
        if b is None:
            continue
        for r in b.to_rows():
            if r[K] == DEL:
                current.pop(r[key_col], None)
            else:
                current[r[key_col]] = r
    return current


def _src_table(tenv, name):
    tenv.execute_sql(f"CREATE TABLE {name} (key BIGINT, value DOUBLE, "
                     "ts BIGINT, WATERMARK FOR ts AS ts) "
                     f"WITH ('connector'='kafka', 'topic'='{name}')")


def test_plain_group_by_into_upsert_kafka_equals_reference():
    def scenario(p):
        ks = _produce(p, "ub1", n=5000, keys=40)
        tenv = p.tenv({"execution.micro-batch.size": 500})
        _src_table(tenv, "ub1")
        tenv.execute_sql(
            "CREATE TABLE out_up (key BIGINT, cnt BIGINT, "
            "PRIMARY KEY (key) NOT ENFORCED) WITH ('connector'='kafka', "
            "'topic'='out_up', 'sink.partitions'='2')")
        tenv.execute_sql("INSERT INTO out_up "
                         "SELECT key, COUNT(*) AS cnt FROM ub1 GROUP BY key")
        return [ks, _topic(p, "out_up", 2)]

    ks, topic = both(scenario)
    current = _compact(topic, "key")
    assert {k: r["cnt"] for k, r in current.items()} == \
        dict(collections.Counter(ks.tolist()))
    assert all(not (b[K] == UB).any() for b in topic)


def test_append_sink_still_rejected():
    for p in PKGS.values():
        _produce(p, "ub2", n=100, keys=5)
        tenv = p.tenv({"execution.micro-batch.size": 50})
        _src_table(tenv, "ub2")
        tenv.execute_sql("CREATE TABLE out_append (key BIGINT, cnt BIGINT) "
                         "WITH ('connector'='kafka', 'topic'='out_append')")
        with pytest.raises(p.PlanError, match="append-only"):
            tenv.execute_sql("INSERT INTO out_append SELECT key, COUNT(*) "
                             "AS cnt FROM ub2 GROUP BY key")


def test_sink_pk_differs_from_changelog_key_equals_reference():
    def scenario(p):
        _produce(p, "ub3", n=900, keys=5)
        tenv = p.tenv({"execution.micro-batch.size": 100})
        _src_table(tenv, "ub3")
        tenv.execute_sql("CREATE TABLE out_pk (cnt BIGINT, PRIMARY KEY "
                         "(cnt) NOT ENFORCED) WITH ('connector'='kafka', "
                         "'topic'='out_pk')")
        tenv.execute_sql("INSERT INTO out_pk SELECT COUNT(*) AS cnt FROM ub3")
        return _topic(p, "out_pk", 1)

    topic = both(scenario)
    assert sorted(r["cnt"] for r in _compact(topic, "cnt").values()) == [900]


def test_crash_restore_effective_exactly_once(tmp_path):
    """The port's updating SQL job into an upsert Kafka table crashes and
    resumes from its checkpoint: the compacted topic equals the
    reference's uninterrupted run's."""
    from tests.test_checkpointing import FailingMap

    query = ("INSERT INTO out_cr SELECT key, COUNT(*) AS cnt FROM t "
             "GROUP BY key")

    def build(p, env, fail_after=None):
        tenv = p.TEnv(env)
        src = p.mod("connectors.sources").DataGenSource(
            total_records=8_000, num_keys=60,
            events_per_second_of_eventtime=10_000, seed=9)
        wm = p.mod("runtime.watermarks").WatermarkStrategy
        ds = env.from_source(src, wm.for_bounded_out_of_orderness(0))
        ds = ds.map(FailingMap(fail_after) if fail_after else (lambda b: b),
                    name="failmap")
        tenv.create_temporary_view("t", ds, columns=["key", "value"])
        tenv.execute_sql(
            "CREATE TABLE out_cr (key BIGINT, cnt BIGINT, "
            "PRIMARY KEY (key) NOT ENFORCED) WITH ('connector'='kafka', "
            "'topic'='out_cr', 'sink.partitions'='2')")
        return tenv

    ref = PKGS["reference"]
    build(ref, ref.Env(ref.config(**{"execution.micro-batch.size": 400}))
          ).execute_sql(query)
    want = _compact(_topic(ref, "out_cr", 2), "key")

    p = PKGS["port"]
    conf = {"execution.micro-batch.size": 400,
            "state.checkpoints.dir": str(tmp_path / "ck"),
            "execution.checkpointing.every-n-source-batches": 4}
    with pytest.raises(RuntimeError, match="injected failure"):
        build(p, p.Env(p.config(**conf)), 5_000).execute_sql(query)
    os.environ["FLINK_TPU_RESTORE_FROM"] = str(tmp_path / "ck")
    try:
        build(p, p.Env(p.config(**conf))).execute_sql(query)
    finally:
        os.environ.pop("FLINK_TPU_RESTORE_FROM", None)
    got = _compact(_topic(p, "out_cr", 2), "key")
    deep_equal({k: r["cnt"] for k, r in got.items()},
               {k: r["cnt"] for k, r in want.items()})
    assert sum(r["cnt"] for r in got.values()) == 8_000
