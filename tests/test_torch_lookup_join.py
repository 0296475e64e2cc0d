"""The lookup join (dimension-table enrichment) of the port against the
reference, on the CPU.

The cases are those of ``tests/test_lookup_join.py``: each runs the same
dimension table and the same rows through both packages'
``LookupJoinOperator`` (the operator, its LRU cache with TTL, the
negative cache) or through both packages' SQL (``create_lookup_table`` and
``JOIN dim FOR SYSTEM_TIME AS OF``), and compares the rows in order, bit
for bit, and the lookup and cache-hit counts exactly. Then a seeded
stream of 20k orders over 2,000 keys is enriched at parallelism 1 and 8
and compared likewise.
"""

import numpy as np
import pytest

from tests.test_torch_sql import PKGS, assert_batches_equal


def _dim(p):
    return p.mod("connectors.lookup").TableLookupFunction(
        [{"cur": 1, "name": "EUR", "factor": 1.1},
         {"cur": 2, "name": "GBP", "factor": 1.3}],
        key_column="cur")


class _Ctx:
    max_parallelism = 128
    operator_index = 0
    device = "cpu"


def _batch(p, curs):
    return p.RecordBatch.from_pydict(
        {"cur": np.asarray(curs, dtype=np.int64),
         "amount": np.arange(len(curs), dtype=np.float64)})


def _op(p, fn=None, **kw):
    op = p.mod("connectors.lookup").LookupJoinOperator(
        fn if fn is not None else _dim(p), "cur", **kw)
    op.open(_Ctx())
    return op


def _both(steps, **kw):
    """Run ``steps(p, op) -> [batches]`` on each package's operator;
    hold the port's batches equal to the reference's and return them."""
    out = {}
    for name, p in PKGS.items():
        op = _op(p, **kw)
        out[name] = (steps(p, op), op)
    for got, want in zip(out["port"][0], out["reference"][0]):
        assert_batches_equal(got, want)
    assert len(out["port"][0]) == len(out["reference"][0])
    assert (out["port"][1].lookups, out["port"][1].cache_hits) == (
        out["reference"][1].lookups, out["reference"][1].cache_hits)
    return out["port"]


def test_inner_drops_misses():
    batches, _ = _both(lambda p, op: op.process_batch(_batch(p, [1, 9, 2])))
    assert list(batches[0]["name"]) == ["EUR", "GBP"]
    assert batches[0]["amount"].tolist() == [0.0, 2.0]


def test_left_outer_pads_misses():
    batches, _ = _both(lambda p, op: op.process_batch(_batch(p, [1, 9])),
                       left_outer=True)
    assert batches[0]["amount"].tolist() == [0.0, 1.0]
    assert list(batches[0]["name"])[0] == "EUR"


def test_declared_schema_stable_across_all_miss_batches():
    batches, _ = _both(
        lambda p, op: op.process_batch(_batch(p, [1]))
        + op.process_batch(_batch(p, [9])),
        right_columns=["cur", "name", "factor"], left_outer=True)
    assert set(batches[0].names()) == set(batches[1].names())


def test_cache_bounds_lookup_calls():
    def steps(p, op):
        out = []
        counts = []
        for curs in ([1, 2, 1, 2], [2, 1], [9], [9]):
            out += op.process_batch(_batch(p, curs))
            counts.append(op.lookups)
        assert counts == [1, 1, 2, 2]
        return out

    _, op = _both(steps, cache_size=10)
    assert op.counters() == {"lookups": 2, "cache_hits": 3,
                             "cache_misses": 3}


def test_cache_off_by_default_sees_live_updates():
    def steps(p, op):
        first = op.process_batch(_batch(p, [9]))
        op.fn._by_key[9] = {"cur": 9, "name": "JPY", "factor": 0.007}
        return first + op.process_batch(_batch(p, [9]))

    batches, _ = _both(steps, right_columns=["cur", "name", "factor"],
                       left_outer=True)
    assert list(batches[1]["name"]) == ["JPY"]


def test_cache_ttl_expires_entries(monkeypatch):
    import time as _time

    clock = [0.0]
    monkeypatch.setattr(_time, "monotonic", lambda: clock[0])

    def steps(p, op):
        clock[0] = 0.0
        out = op.process_batch(_batch(p, [1]))
        clock[0] = 0.5
        out += op.process_batch(_batch(p, [1]))
        assert op.lookups == 1
        op.fn._by_key[1] = {"cur": 1, "name": "EUR2", "factor": 2.0}
        clock[0] = 1.5
        out += op.process_batch(_batch(p, [1]))
        assert op.lookups == 2
        return out

    batches, _ = _both(steps, cache_size=10, cache_ttl_ms=1000)
    assert list(batches[2]["name"]) == ["EUR2"]


# ------------------------------------------------------------------- SQL

ORDERS_DDL = ("CREATE TABLE lkp_orders (cur BIGINT, amount DOUBLE, "
              "ts BIGINT, WATERMARK FOR ts AS ts) "
              "WITH ('connector'='kafka', 'topic'='lkp_orders')")


def _setup(curs, amounts, ts, dim_rows=None, cache_size=0):
    def setup(p, tenv):
        broker = p.FakeBroker.get("default")
        broker.create_topic("lkp_orders", 1)
        broker.append("lkp_orders", 0, p.RecordBatch.from_pydict(
            {"cur": curs, "amount": amounts, "ts": ts}, timestamps=ts))
        tenv.execute_sql(ORDERS_DDL)
        fn = (_dim(p) if dim_rows is None else
              p.mod("connectors.lookup").TableLookupFunction(
                  dim_rows, key_column="cur"))
        tenv.create_lookup_table("rates_dim", fn, ["cur", "name", "factor"],
                                 cache_size=cache_size)
    return setup


ENRICH = ("SELECT o.amount * r.factor AS conv, r.name FROM lkp_orders AS o "
          "JOIN rates_dim FOR SYSTEM_TIME AS OF o.ts AS r ON o.cur = r.cur")


def _sql_both(setup, sql, cfg):
    out = {}
    for name, p in PKGS.items():
        p.FakeBroker.reset()
        tenv = p.tenv(cfg)
        setup(p, tenv)
        out[name] = tenv.execute_sql(sql).to_batch()
    assert_batches_equal(out["port"], out["reference"])
    return out["port"]


def test_sql_enrichment_query():
    ts = np.asarray([1000, 2000, 3000], dtype=np.int64)
    got = _sql_both(_setup(np.asarray([1, 9, 2], dtype=np.int64),
                           np.asarray([10.0, 20.0, 30.0]), ts),
                    ENRICH, {"execution.micro-batch.size": 2})
    assert sorted(zip(np.round(got["conv"], 2).tolist(),
                      got["name"].tolist())) == [(11.0, "EUR"),
                                                 (39.0, "GBP")]


def test_sql_wrong_key_column_rejected_as_the_reference():
    ts = np.asarray([1000], dtype=np.int64)
    msgs = {}
    for name, p in PKGS.items():
        p.FakeBroker.reset()
        tenv = p.tenv()
        _setup(np.asarray([1], dtype=np.int64), np.asarray([1.0]), ts)(
            p, tenv)
        with pytest.raises(p.PlanError, match="keyed by") as e:
            tenv.execute_sql(
                "SELECT o.amount FROM lkp_orders AS o JOIN rates_dim FOR "
                "SYSTEM_TIME AS OF o.ts AS r ON o.cur = r.name")
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]


@pytest.mark.parametrize("parallelism", [1, 8])
def test_sql_left_join_seeded_stream_with_cache(parallelism):
    """20k orders over 2,000 currencies, 1,500 of them in a dimension
    table of 1,500 rows, LEFT JOIN with the LRU cache on (500 entries):
    rows equal the reference's bit for bit in order."""
    rng = np.random.default_rng(21)
    n, keys = 20_000, 2_000
    curs = rng.integers(0, keys, n).astype(np.int64)
    amounts = np.round(rng.random(n) * 100, 2)
    ts = np.arange(n, dtype=np.int64) * 3
    dim_rows = [{"cur": int(k), "name": f"c{k % 37}",
                 "factor": float(np.float32(1 + (k % 11) / 10))}
                for k in rng.permutation(keys)[:1500]]
    got = _sql_both(
        _setup(curs, amounts, ts, dim_rows, cache_size=500),
        "SELECT o.cur, o.amount, r.name, r.factor FROM lkp_orders AS o "
        "LEFT JOIN rates_dim FOR SYSTEM_TIME AS OF o.ts AS r "
        "ON o.cur = r.cur",
        {"execution.micro-batch.size": 1 << 11,
         "parallelism.default": parallelism})
    assert len(got) == n
    present = {r["cur"] for r in dim_rows}
    hit = np.isin(got["cur_l"], list(present))
    assert np.isnan(np.asarray(got["factor"], np.float64)[~hit]).all()


@pytest.mark.parametrize("parallelism", [1, 8])
def test_sql_enriched_stream_feeds_a_hop_window(parallelism):
    """Phase 21(b)'s shape at a cut size: bids enriched with their
    auction's category by an INNER lookup join (cache on), then HOP(2 s,
    10 s) SUM(price) GROUP BY auction, category: rows equal the
    reference's bit for bit in order, at P=1 and on the mesh engine at
    P=8."""
    rng = np.random.default_rng(22)
    n, keys = 12_000, 400
    auction = rng.integers(0, keys, n).astype(np.int64)
    price = rng.integers(1, 1000, n).astype(np.float64)
    ts = np.arange(n, dtype=np.int64)

    def setup(p, tenv):
        broker = p.FakeBroker.get("default")
        broker.create_topic("bids", 1)
        broker.append("bids", 0, p.RecordBatch.from_pydict(
            {"auction": auction, "price": price, "ts": ts}, timestamps=ts))
        tenv.execute_sql(
            "CREATE TABLE bids (auction BIGINT, price DOUBLE, ts BIGINT, "
            "WATERMARK FOR ts AS ts) WITH ('connector'='kafka', "
            "'topic'='bids')")
        tenv.create_lookup_table(
            "auctions", p.mod("connectors.lookup").TableLookupFunction(
                [{"id": int(k), "category": int(k % 7)}
                 for k in range(keys)], key_column="id"),
            ["id", "category"], cache_size=1 << 10)
        tenv.execute_sql(
            "CREATE VIEW enriched AS SELECT b.auction, b.price, b.ts, "
            "a.category FROM bids AS b JOIN auctions FOR SYSTEM_TIME AS OF "
            "b.ts AS a ON b.auction = a.id")

    got = _sql_both(
        setup,
        "SELECT auction, category, window_end, SUM(price) AS total FROM "
        "TABLE(HOP(TABLE enriched, DESCRIPTOR(ts), INTERVAL '2' SECOND, "
        "INTERVAL '10' SECOND)) GROUP BY auction, category, window_start, "
        "window_end",
        {"execution.micro-batch.size": 1 << 11,
         "parallelism.default": parallelism})
    assert len(got) > keys
    assert (np.asarray(got["category"]) == np.asarray(got["auction"]) % 7
            ).all()
