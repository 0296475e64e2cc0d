"""The port's rule-based SQL optimizer, UNION ALL, INSERT INTO and the
catalog statements against the reference, on the CPU.

Every statement of ``tests/test_sql_optimizer.py`` is parsed and
optimized in both packages and the optimized ASTs compared (their
reprs: the dataclass trees, node for node); the rewrites' own helpers
(``fold_constants``, ``split_conjuncts``) likewise. The queries that
execute compare their rows bit for bit (joins as multisets), with the
optimizer on and off, and the errors compare type and text.
"""

import pytest

from tests.test_torch_sql import (
    PKGS,
    _row_sorted,
    _views,
    assert_batches_equal,
    both_results,
)

OPTIMIZE_SQL = [
    "SELECT a FROM t WHERE a > 1 + 2 * 3",
    "SELECT a FROM t WHERE a > 1 AND 1 = 1",
    "SELECT a FROM t WHERE 5 BETWEEN 1 AND 9 AND a < 2",
    "SELECT a FROM t WHERE a > 1 OR 1 = 0",
    "SELECT a FROM t WHERE NOT (2 > 3) AND a * (4 - 2) > 10 / 5",
    "SELECT b.x FROM b JOIN c ON b.k = c.k "
    "WHERE b.x > 5 AND c.y < 3 AND b.x < c.y + 100",
    "SELECT b.x FROM b LEFT JOIN c ON b.k = c.k WHERE b.x > 5 AND c.y < 3",
    "SELECT b.x FROM b JOIN c ON b.k = c.k WHERE x > 5",
    "SELECT v FROM (SELECT a + 1 AS v FROM t) WHERE v > 10",
    "SELECT * FROM (SELECT a, ROW_NUMBER() OVER (PARTITION BY k ORDER BY a "
    "DESC) AS rn FROM t) WHERE rn <= 3",
    "SELECT s FROM (SELECT k, SUM(v) AS s FROM t GROUP BY k) WHERE s > 10",
    "SELECT k, v FROM A WHERE v > 10 AND 2 = 2 UNION ALL SELECT k, v FROM B "
    "WHERE 1 + 1 = 3 OR v > 1",
    "SELECT auction, COUNT(*) AS n FROM TABLE(TUMBLE(TABLE bid, "
    "DESCRIPTOR(t), INTERVAL '10' SECOND)) WHERE price > 1 AND 1 = 1 "
    "GROUP BY auction, window_start, window_end",
]


@pytest.mark.parametrize("i", range(len(OPTIMIZE_SQL)))
def test_optimized_ast_equals_reference(i):
    out = {}
    for name, p in PKGS.items():
        stmt = p.optimizer.optimize(p.parser.parse(OPTIMIZE_SQL[i]))
        where = getattr(stmt, "where", None)
        out[name] = (repr(stmt), repr(p.optimizer.split_conjuncts(where))
                     if where is not None else None)
    assert out["port"] == out["reference"]


def test_fold_constants_equals_reference():
    for sql in ("SELECT 1 + 2 * 3 AS x, 4 > 3 AS y, 7 - 9 AS z FROM t",
                "SELECT CASE WHEN 1 < 2 THEN 'a' ELSE 'b' END AS c FROM t"):
        got = [repr([PKGS[n].optimizer.fold_constants(i.expr)
                     for i in PKGS[n].parser.parse(sql).items])
               for n in ("port", "reference")]
        assert got[0] == got[1]


def test_join_results_identical_with_and_without_the_optimizer(monkeypatch):
    rows_l = [{"k": i % 5, "x": float(i), "t": i * 10} for i in range(200)]
    rows_r = [{"k": i % 5, "y": float(i % 7), "t": i * 10}
              for i in range(200)]
    sql = ("SELECT L.k, L.x, R.y FROM L JOIN R ON L.x = R.y "
           "WHERE L.x > 2 AND R.y < 5")
    setup = _views(("L", rows_l, "t"), ("R", rows_r, "t"))
    cfg = {"execution.micro-batch.size": 64}
    optimized = both_results(setup, sql, cfg, ordered=False)
    import flink_tpu_torch.table.environment as te

    monkeypatch.setattr(te, "optimize", lambda s: s)
    p = PKGS["port"]
    t = p.tenv(cfg)
    setup(p, t)
    plain = t.execute_sql(sql).to_batch()
    assert_batches_equal(_row_sorted(plain), _row_sorted(optimized))
    assert len(plain) > 0


def _errors(setup, sql, cfg=None):
    msgs = []
    for p in PKGS.values():
        t = p.tenv(cfg)
        setup(p, t)
        with pytest.raises(Exception) as e:
            t.execute_sql(sql).collect()
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]
    return msgs[1][1]


_A = [{"k": i, "v": float(i), "t": i * 10} for i in range(50)]
_B = [{"k": i + 100, "v": float(i), "t": i * 10} for i in range(30)]
_B2 = [{"k": i, "v": float(i + 100), "t": i * 10} for i in range(20)]


def test_union_all_equals_reference():
    out = both_results(_views(("A", _A, "t"), ("B", _B, "t")),
                       "SELECT k, v FROM A WHERE v > 10 UNION ALL "
                       "SELECT k, v FROM B",
                       {"execution.micro-batch.size": 64}, ordered=False)
    assert len(out) == 39 + 30
    out = both_results(_views(("A", _A[:20], "t"), ("B", _B2, "t")),
                       "SELECT v FROM A UNION ALL SELECT v FROM B "
                       "ORDER BY v DESC LIMIT 3",
                       {"execution.micro-batch.size": 64})
    assert out["v"].tolist() == [119.0, 118.0, 117.0]


def test_union_errors_equal_reference():
    a = _views(("A", [{"k": 1, "v": 1.0, "t": 0}], "t"))
    assert "identical columns" in _errors(
        a, "SELECT k FROM A UNION ALL SELECT v FROM A")
    assert "changelog" in _errors(
        _views(("A", [{"k": i % 3, "v": float(i), "t": i * 10}
                      for i in range(30)], "t")),
        "SELECT k, SUM(v) AS s FROM A GROUP BY k UNION ALL "
        "SELECT k, SUM(v) AS s FROM A GROUP BY k")
    assert "outermost" in _errors(
        _views(("A", _A[:20], "t")),
        "SELECT k FROM (SELECT k FROM A ORDER BY k LIMIT 3)")

    def mixed(p, t):
        t.create_temporary_view("A", t.from_collection(
            [{"k": 1, "v": 1.0, "t": 0}], timestamp_field="t"))
        t.create_temporary_view("B", t.from_collection(
            [{"k": 2, "v": 2.0}]), columns=["k", "v"])

    assert "event time" in _errors(
        mixed, "SELECT k, v FROM A UNION ALL SELECT k, v FROM B",
        {"execution.micro-batch.size": 64})


def test_fluent_union_all_equals_reference():
    out = {}
    for name, p in PKGS.items():
        t = p.tenv({"execution.micro-batch.size": 64})
        ta = t.from_collection(_A[:10], timestamp_field="t")
        tb = t.from_collection(_B[:10], timestamp_field="t")
        out[name] = _row_sorted(ta.union_all(tb).execute().to_batch())
    assert_batches_equal(out["port"], out["reference"])
    assert len(out["port"]) == 20


def test_show_tables_and_describe_equal_reference():
    out = {}
    for name, p in PKGS.items():
        t = p.tenv()
        rows = [{"a": 1, "p": 2.0, "t": 0}]
        for v in ("bids", "asks"):
            t.create_temporary_view(v, t.from_collection(
                rows, timestamp_field="t"))
        t.execute_sql("CREATE VIEW agg AS SELECT a, COUNT(*) AS n FROM "
                      "bids GROUP BY a")
        out[name] = [t.execute_sql("SHOW TABLES"),
                     t.execute_sql("DESCRIBE bids"),
                     t.execute_sql("DESC agg")]
        with pytest.raises(p.PlanError, match="not registered"):
            t.execute_sql("DESCRIBE nope")
    assert out["port"] == out["reference"]
    assert out["port"][0] == ["agg", "asks", "bids"]


def _insert(p, sink, sql, cols, rows, cfg=None):
    t = p.tenv(cfg or {"execution.micro-batch.size": 64})
    t.create_temporary_view("src", t.from_collection(
        rows, timestamp_field="t"))
    t.create_sink_table("out", sink, columns=cols)
    t.execute_sql(sql)
    return sink.result()


def test_insert_into_sinks_equal_reference():
    rows = [{"k": i % 3, "v": float(i), "t": i * 10} for i in range(100)]
    out = {}
    for name, p in PKGS.items():
        class ChangelogSink(p.CollectSink):
            supports_changelog = True

        out[name] = [
            _insert(p, p.CollectSink(), "INSERT INTO out SELECT k, v * 2 AS "
                    "doubled FROM src WHERE v > 50", ["k", "doubled"], rows),
            _insert(p, ChangelogSink(), "INSERT INTO out SELECT k, SUM(v) "
                    "AS s FROM src GROUP BY k", ["k", "s"], rows,
                    {"execution.micro-batch.size": 8})]
    for g, w in zip(out["port"], out["reference"]):
        assert_batches_equal(g, w)
    assert "__rowkind__" in out["port"][1].columns


def test_insert_into_errors_equal_reference():
    rows = [{"k": i % 3, "v": float(i), "t": i * 10} for i in range(30)]
    msgs = []
    for p in PKGS.values():
        t = p.tenv()
        t.create_temporary_view("src", t.from_collection(
            rows, timestamp_field="t"))
        t.create_sink_table("out", p.CollectSink(), columns=["k", "s"])
        got = []
        for sql in ("INSERT INTO out SELECT k, SUM(v) AS s FROM src "
                    "GROUP BY k", "INSERT INTO nowhere SELECT k FROM src",
                    "INSERT INTO out SELECT k FROM src"):
            with pytest.raises(p.PlanError) as e:
                t.execute_sql(sql)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert "append-only" in msgs[1][0]
    assert "not a registered sink" in msgs[1][1]
