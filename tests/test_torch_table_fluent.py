"""The port's fluent Table API against the reference, on the CPU.

Every fluent query of ``tests/test_table_fluent.py`` is built in both
packages over the same seeded bids: its plan (the transformation graph
the planner lowers it to, node by node) and its materialized rows (bit
for bit) equal the reference's, and equal the port's own SQL spelling of
the query. Join rows are compared as multisets (see
``tests/test_torch_sql.py``).
"""

import numpy as np
import pytest

from tests.test_torch_sql import PKGS, _row_sorted, assert_batches_equal


def _bids(p, t_env, n=4000):
    rng = np.random.default_rng(3)
    rows = [{"auction": int(rng.integers(30)),
             "price": float(rng.integers(1, 100)), "t": i * 5}
            for i in range(n)]
    table = t_env.from_collection(rows, timestamp_field="t")
    t_env.create_temporary_view("bid", table)
    return table


def _sides(p, t_env, seed, n, lcol, rcol):
    rng = np.random.default_rng(seed)
    left = [{"k": int(rng.integers(8)), lcol: float(i % 11), "t": i * 7}
            for i in range(n)]
    right = [{"k": int(rng.integers(8)), rcol: float(i % 11), "t": i * 7}
             for i in range(n)]
    lt = t_env.from_collection(left, timestamp_field="t").alias("L")
    rt = t_env.from_collection(right, timestamp_field="t").alias("R")
    t_env.create_temporary_view("L", lt)
    t_env.create_temporary_view("R", rt)
    return lt, rt


def _graph(table):
    """The plan: (name, kind) of every transformation, depth first."""
    out, seen = [], set()

    def walk(t):
        if id(t) in seen:
            return
        seen.add(id(t))
        for i in t.inputs:
            walk(i)
        out.append((t.name, t.kind, bool(t.keyed)))

    walk(table.stream.transformation)
    return out


def _q(name):
    """name -> (build fluent table, SQL spelling, ordered)"""
    def select_where(p, f, te):
        b = _bids(p, te)
        return (b.where((f.col("price") > 50) & (f.col("auction") < 10))
                .select(f.col("auction"),
                        (f.col("price") * 2).alias("double_price")))

    def distinct(p, f, te):
        return _bids(p, te, 500).select(f.col("auction")).distinct()

    def fetch(p, f, te):
        return (_bids(p, te, 500).select(f.col("auction"), f.col("price"))
                .order_by(f.col("price").desc()).fetch(5))

    def group_by(p, f, te):
        return (_bids(p, te).group_by(f.col("auction"))
                .select(f.col("auction"),
                        f.col("price").sum().alias("total"),
                        f.count_star().alias("n")))

    def tumble(p, f, te):
        return (_bids(p, te).window(f.Tumble.over(2000).on(f.col("t"))
                                    .alias("w"))
                .group_by("w", f.col("auction"))
                .select(f.col("auction"), f.col("window_end"),
                        f.count_star().alias("bids")))

    def slide(p, f, te):
        return (_bids(p, te).window(f.Slide.over(4000, 2000)
                                    .on(f.col("t")).alias("w"))
                .group_by("w", f.col("auction"))
                .select(f.col("auction"), f.col("window_start"),
                        f.col("price").max().alias("top")))

    def session(p, f, te):
        return (_bids(p, te, 600).window(f.Session.with_gap(20)
                                         .on(f.col("t")).alias("w"))
                .group_by("w", f.col("auction"))
                .select(f.col("auction"), f.col("window_end"),
                        f.col("price").avg().alias("mean")))

    def arith(p, f, te):
        return (_bids(p, te, 200)
                .select(f.col("auction"),
                        (100 - f.col("price")).alias("inv"),
                        (2 * f.col("price")).alias("dbl")))

    def join_keys(p, f, te):
        lt, rt = _sides(p, te, 4, 150, "x", "y")
        return lt.join(rt, f.col("L.k") == f.col("R.k"))

    def join_values(p, f, te):
        lt, rt = _sides(p, te, 9, 300, "x", "y")
        return lt.join(rt, f.col("x") == f.col("y"))

    return {
        "select_where": (select_where, "SELECT auction, price * 2 AS "
                         "double_price FROM bid WHERE price > 50 AND "
                         "auction < 10", True),
        "distinct": (distinct, "SELECT DISTINCT auction FROM bid", True),
        "fetch": (fetch, "SELECT auction, price FROM bid ORDER BY price "
                  "DESC LIMIT 5", True),
        "group_by": (group_by, "SELECT auction, SUM(price) AS total, "
                     "COUNT(*) AS n FROM bid GROUP BY auction", True),
        "tumble": (tumble, "SELECT auction, window_end, COUNT(*) AS bids "
                   "FROM TABLE(TUMBLE(TABLE bid, DESCRIPTOR(t), INTERVAL "
                   "'2' SECOND)) GROUP BY auction, window_start, "
                   "window_end", True),
        "slide": (slide, "SELECT auction, window_start, MAX(price) AS top "
                  "FROM TABLE(HOP(TABLE bid, DESCRIPTOR(t), INTERVAL '2' "
                  "SECOND, INTERVAL '4' SECOND)) GROUP BY auction, "
                  "window_start, window_end", True),
        "session": (session, None, True),
        "arith": (arith, "SELECT auction, 100 - price AS inv, 2 * price AS "
                  "dbl FROM bid", True),
        "join_keys": (join_keys, "SELECT * FROM L JOIN R ON L.k = R.k",
                      False),
        "join_values": (join_values, "SELECT * FROM L JOIN R ON L.x = R.y",
                        False),
    }[name]


CASES = ["select_where", "distinct", "fetch", "group_by", "tumble", "slide",
         "session", "arith", "join_keys", "join_values"]


@pytest.mark.parametrize("case", CASES)
def test_fluent_query_plan_and_rows_equal_reference(case):
    build, sql, ordered = _q(case)
    graphs, rows, sqls = {}, {}, {}
    for name, p in PKGS.items():
        te = p.tenv({"execution.micro-batch.size": 128})
        table = build(p, p.fluent, te)
        graphs[name] = _graph(table)
        rows[name] = table.execute().to_batch()
        if sql is not None:
            sqls[name] = te.execute_sql(sql).to_batch()
    assert graphs["port"] == graphs["reference"]
    norm = (lambda b: b) if ordered else _row_sorted
    assert_batches_equal(norm(rows["port"]), norm(rows["reference"]))
    assert len(rows["port"]) > 0
    if sql is not None:
        # the fluent query and its SQL spelling: the same rows (as in
        # the reference test, order-free: the two plans' row order may
        # differ)
        assert_batches_equal(_row_sorted(rows["port"]),
                             _row_sorted(sqls["port"]))


def test_fluent_misuse_errors_equal_reference():
    msgs = []
    for p in PKGS.values():
        te = p.tenv()
        b = _bids(p, te, 50)
        with pytest.raises(p.PlanError) as e:
            b.order_by(p.fluent.col("price")).fetch(2).select(
                p.fluent.col("auction"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "terminal" in msgs[0]
