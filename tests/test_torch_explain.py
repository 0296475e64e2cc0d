"""The job graph (chaining, ``to_json``, the execution graph's key-group
ranges) and ``EXPLAIN`` of the port against the reference, on the CPU.

The job-graph cases are those of ``tests/test_job_graph.py`` that need no
cluster (the stage planner and the REST plan endpoint are ROADMAP item 12
in the port): the same pipeline built in both packages gives the same
vertices, edges and ``to_json``. The ``EXPLAIN`` cases are
``tests/test_sql_optimizer.py``'s ``TestExplain`` plus one statement of
every plannable shape — window TVFs at P=1 and P=8, Top-N, GROUP BY,
OVER, the lookup join, the interval join, MATCH_RECOGNIZE, UNION ALL,
ORDER BY / LIMIT and ML_PREDICT: the text equals the reference's
character for character.
"""

import numpy as np
import pytest

from tests.test_torch_sql import PKGS


def _jg(p):
    return p.mod("graph.job_graph")


def _pipeline(p, parallelism=None):
    env = p.Env(p.config())
    src = p.mod("connectors.sources").DataGenSource(
        total_records=100, num_keys=10, events_per_second_of_eventtime=1000)
    wm = p.mod("runtime.watermarks").WatermarkStrategy
    win = p.mod("windowing.assigners").TumblingEventTimeWindows
    ds = env.add_source(src, wm.for_bounded_out_of_orderness(0))
    ds = ds.map(lambda b: b, name="m1").map(lambda b: b, name="m2")
    s = ds.key_by("key").window(win.of(1000)).sum("value")
    if parallelism:
        s.transformation.parallelism = parallelism
    s.sink_to(p.CollectSink())
    return env


def _both_graphs(build, default_parallelism):
    out = {}
    for name, p in PKGS.items():
        jg = _jg(p).build_job_graph(build(p).get_stream_graph(),
                                    default_parallelism=default_parallelism)
        out[name] = jg
    assert out["port"].to_json() == out["reference"].to_json()
    return out["port"]


def test_linear_pipeline_chains_into_two_vertices():
    jg = _both_graphs(_pipeline, 1)
    assert len(jg.vertices) == 2 and len(jg.edges) == 1
    assert jg.edges[0].ship == "HASH" and jg.edges[0].key_field == "key"
    names = [v.name for v in jg.vertices]
    assert "m1" in names[0] and "m2" in names[0] and "sink" in names[1]


def test_parallelism_mismatch_breaks_chain():
    def build(p):
        env = p.Env(p.config())
        src = p.mod("connectors.sources").DataGenSource(
            total_records=10, num_keys=2, events_per_second_of_eventtime=100)
        wm = p.mod("runtime.watermarks").WatermarkStrategy
        m = env.add_source(src, wm.for_bounded_out_of_orderness(0)).map(
            lambda b: b, name="m1")
        m.transformation.parallelism = 4
        m.map(lambda b: b, name="m2").sink_to(p.CollectSink())
        return env

    jg = _both_graphs(build, 1)
    assert [v.parallelism for v in jg.vertices] == [1, 4]
    assert [e.ship for e in jg.edges] == ["REBALANCE"]


def test_same_key_parallelism_change_reshuffles():
    def build(p):
        env = p.Env(p.config())
        src = p.mod("connectors.sources").DataGenSource(
            total_records=10, num_keys=2, events_per_second_of_eventtime=100)
        wm = p.mod("runtime.watermarks").WatermarkStrategy
        win = p.mod("windowing.assigners").TumblingEventTimeWindows
        agg = env.add_source(src, wm.for_bounded_out_of_orderness(0)) \
            .key_by("key").window(win.of(1000)).sum("value")
        agg.transformation.parallelism = 4
        second = agg.key_by("key").window(win.of(2000)).sum("sum_value")
        second.transformation.parallelism = 2
        second.sink_to(p.CollectSink())
        return env

    jg = _both_graphs(build, 1)
    hash_edges = [e for e in jg.edges if e.ship == "HASH"]
    assert len(hash_edges) == 2
    assert all(e.key_field == "key" for e in hash_edges)


def test_plan_json_shape():
    plan = _both_graphs(_pipeline, 8).to_json()
    assert {n["id"] for n in plan["nodes"]} == {0, 1}
    keyed = [n for n in plan["nodes"] if n.get("key_field")]
    assert keyed and keyed[0]["parallelism"] == 8
    assert plan["edges"][0]["ship_strategy"] == "HASH"


def test_side_output_and_broadcast_edges_as_the_reference():
    def build(p):
        env = p.Env(p.config())
        proc = p.mod("runtime.process")
        tag = proc.OutputTag("late")

        class Split(proc.ProcessFunction):
            def process_batch(self, batch, ctx):
                ctx.collect(batch)
                ctx.output(tag, batch)

        rows = [{"k": i % 3, "v": float(i), "ts": i} for i in range(20)]
        main = env.from_collection(rows, timestamp_field="ts").process(
            Split())
        main.get_side_output(tag).sink_to(p.CollectSink(), name="side")
        rules = env.from_collection(rows, timestamp_field="ts")

        class Join(proc.BroadcastProcessFunction):
            def process_batch(self, batch, ctx, state):
                ctx.collect(batch)

            def process_broadcast(self, batch, ctx, state):
                pass

        main.connect(rules.broadcast()).process(Join()).sink_to(
            p.CollectSink(), name="main")
        return env

    jg = _both_graphs(build, 1)
    assert {e.ship for e in jg.edges} >= {"SIDE", "BROADCAST"}


@pytest.mark.parametrize("parallelism,max_parallelism", [(4, 128), (2, 16),
                                                         (8, 128)])
def test_execution_graph_key_groups_partition_exactly(parallelism,
                                                      max_parallelism):
    egs = {}
    for name, p in PKGS.items():
        jg = _jg(p).build_job_graph(_pipeline(p).get_stream_graph(),
                                    default_parallelism=parallelism)
        egs[name] = _jg(p).ExecutionGraph(jg, max_parallelism=max_parallelism)
    got = [(ev.name, ev.subtask_index, ev.key_group_range and (
        ev.key_group_range.start, ev.key_group_range.end))
        for ev in egs["port"].execution_vertices]
    want = [(ev.name, ev.subtask_index, ev.key_group_range and (
        ev.key_group_range.start, ev.key_group_range.end))
        for ev in egs["reference"].execution_vertices]
    assert got == want
    keyed = [r for _, _, r in got if r is not None]
    assert len(keyed) == parallelism
    covered = sorted(g for a, b in keyed for g in range(a, b + 1))
    assert covered == list(range(max_parallelism))
    eg = egs["port"]
    keyed_v = [v for v in eg.job_graph.vertices if v.key_field][0]
    subs = eg.subtasks_of(keyed_v)
    assert subs[0].name.endswith(f"(1/{parallelism})")


# ------------------------------------------------------------------ EXPLAIN


def _bid_rows(n=200, seed=3):
    rng = np.random.default_rng(seed)
    return [{"auction": int(a), "bidder": int(b), "price": float(c),
             "ts": int(t)} for a, b, c, t in zip(
                 rng.integers(0, 20, n), rng.integers(0, 50, n),
                 rng.integers(1, 100, n), np.arange(n) * 10)]


def _setup(p, tenv):
    tenv.create_temporary_view("bid", tenv.from_collection(
        _bid_rows(), timestamp_field="ts"))
    tenv.create_temporary_view("bid2", tenv.from_collection(
        _bid_rows(seed=4), timestamp_field="ts"))
    tenv.create_lookup_table(
        "auctions", p.mod("connectors.lookup").TableLookupFunction(
            [{"id": i, "category": i % 5} for i in range(20)],
            key_column="id"), ["id", "category"])
    ml = p.mod("ml.models")
    tenv.create_temporary_model("scale", ml.FunctionModel(
        lambda cols: {"y": np.asarray(cols["x"], np.float64) * 2},
        ["x"], ["y"]))
    tenv.execute_sql(
        "CREATE VIEW AuctionBids AS SELECT auction, COUNT(*) AS num, "
        "window_start, window_end FROM TABLE(HOP(TABLE bid, DESCRIPTOR(ts), "
        "INTERVAL '2' SECOND, INTERVAL '10' SECOND)) GROUP BY auction, "
        "window_start, window_end")


EXPLAINED = {
    "tumble_where_folded": (
        "SELECT auction, COUNT(*) AS n FROM TABLE(TUMBLE(TABLE bid, "
        "DESCRIPTOR(ts), INTERVAL '10' SECOND)) WHERE price > 1 AND 1 = 1 "
        "GROUP BY auction, window_start, window_end"),
    "row4_hop_sum": (
        "SELECT auction AS key, window_end, SUM(price) AS total FROM "
        "TABLE(HOP(TABLE bid, DESCRIPTOR(ts), INTERVAL '2' SECOND, "
        "INTERVAL '10' SECONDS)) GROUP BY auction, window_start, "
        "window_end"),
    "q5_top_n": (
        "SELECT auction, num, window_end FROM (SELECT auction, num, "
        "window_end, ROW_NUMBER() OVER (PARTITION BY window_end ORDER BY "
        "num DESC) AS rownum FROM AuctionBids) WHERE rownum <= 1"),
    "group_by": "SELECT auction, SUM(price) AS s FROM bid GROUP BY auction",
    "over_range": (
        "SELECT auction, SUM(price) OVER (PARTITION BY auction ORDER BY ts "
        "RANGE BETWEEN INTERVAL '10' SECOND PRECEDING AND CURRENT ROW) AS "
        "s, COUNT(*) OVER (PARTITION BY auction ORDER BY ts RANGE BETWEEN "
        "INTERVAL '10' SECOND PRECEDING AND CURRENT ROW) AS n FROM bid"),
    "lookup_join": (
        "SELECT b.auction, b.price, a.category FROM bid AS b JOIN auctions "
        "FOR SYSTEM_TIME AS OF b.ts AS a ON b.auction = a.id"),
    "join_pushdown": (
        "SELECT L.price FROM bid AS L JOIN bid2 AS R ON L.auction = "
        "R.auction WHERE L.price > 5"),
    "interval_join": (
        "SELECT L.auction, R.price FROM bid AS L JOIN bid2 AS R ON "
        "L.auction = R.auction AND R.ts BETWEEN L.ts - INTERVAL '1' SECOND "
        "AND L.ts"),
    "match_recognize": (
        "SELECT * FROM bid MATCH_RECOGNIZE (PARTITION BY auction ORDER BY ts "
        "MEASURES FIRST(A.price) AS p0 PATTERN (A B) DEFINE A AS price < "
        "50, B AS price >= 50)"),
    "union_order_limit": (
        "SELECT auction, price FROM bid UNION ALL SELECT auction, price "
        "FROM bid2 ORDER BY price DESC LIMIT 5"),
    "ml_predict": (
        "SELECT * FROM ML_PREDICT(TABLE bid, MODEL scale, DESCRIPTOR(price))"),
    "cast_case_between": (
        "SELECT CAST(price AS INT) AS p, CASE WHEN price > 50 THEN 1 ELSE 0 "
        "END AS hi FROM bid WHERE auction BETWEEN 1 AND 3 AND NOT (price < 2)"),
}


def _explain_both(sql, cfg=None, how="statement"):
    out = {}
    for name, p in PKGS.items():
        tenv = p.tenv(cfg or {})
        _setup(p, tenv)
        if how == "statement":
            out[name] = tenv.execute_sql("EXPLAIN " + sql)
        elif how == "explain_sql":
            out[name] = tenv.explain_sql(sql)
        else:
            out[name] = tenv.explain_sql_statement(
                p.parser.parse("EXPLAIN " + sql))
    assert out["port"] == out["reference"], (out["port"], out["reference"])
    return out["port"]


@pytest.mark.parametrize("case", sorted(EXPLAINED))
@pytest.mark.parametrize("parallelism", [1, 8])
def test_explain_text_equals_the_reference(case, parallelism):
    text = _explain_both(EXPLAINED[case],
                         {"parallelism.default": parallelism})
    assert text.startswith("== Optimized Logical Plan ==")
    assert "== Physical Plan (chained job graph) ==" in text


@pytest.mark.parametrize("how", ["explain_sql", "explain_sql_statement"])
def test_explain_entry_points_equal_the_reference(how):
    text = _explain_both(EXPLAINED["tumble_where_folded"], how=how)
    assert "1 = 1" not in text and "(price > 1)" in text
    assert "HASH key=auction" in text


def test_explain_join_pushdown_visible():
    text = _explain_both(EXPLAINED["join_pushdown"])
    assert "JOIN" in text and "WHERE (L.price > 5)" in text


def test_explain_rejects_a_statement_as_the_reference():
    msgs = {}
    for name, p in PKGS.items():
        tenv = p.tenv()
        _setup(p, tenv)
        with pytest.raises(p.PlanError, match="EXPLAIN supports") as e:
            tenv.explain_sql("CREATE VIEW v AS SELECT auction FROM bid")
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]
