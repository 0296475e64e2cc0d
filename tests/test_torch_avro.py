"""The port's Avro format (``flink_tpu_torch/connectors/avro.py``) against
the reference's (``flink_tpu/connectors/avro.py``): the same schemas give
the same bytes and the same decoded rows, schema evolution resolves the
same way, and ``'format'='avro'`` runs through SQL over Kafka with the
reference's rows. Counterparts of every test in ``tests/test_avro.py``,
each run through both packages."""

import collections
import json

import numpy as np
import pytest

from tests.test_torch_sql import (  # noqa: F401 (autouse fixture)
    PKGS,
    assert_batches_equal,
    fresh_brokers,
)

V1_JSON = {"type": "record", "name": "Bid", "fields": [
    {"name": "auction", "type": "int"},
    {"name": "price", "type": "double"},
    {"name": "bidder", "type": ["null", "string"], "default": None}]}
# evolved: auction promoted int->long, a NEW field region with a default,
# price unchanged, bidder dropped by the reader
V2_JSON = {"type": "record", "name": "Bid", "fields": [
    {"name": "auction", "type": "long"},
    {"name": "price", "type": "double"},
    {"name": "region", "type": "string", "default": "emea"}]}


def _avro(p):
    return p.mod("connectors.avro")


def _both(fn):
    out = {name: fn(p, _avro(p)) for name, p in PKGS.items()}
    assert out["port"] == out["reference"]
    return out["port"]


# ------------------------------------------------------------ binary core


def test_roundtrip_primitives_and_unions():
    def run(p, a):
        v1 = a.parse_schema(json.dumps(V1_JSON))
        b1 = a.encode_record(v1, {"auction": 7, "price": 2.5,
                                  "bidder": "alice"})
        b2 = a.encode_record(v1, {"auction": -3, "price": 0.0,
                                  "bidder": None})
        return b1, b2, a.decode_record(v1, v1, b1), \
            a.decode_record(v1, v1, b2)

    b1, b2, d1, d2 = _both(run)
    assert d1 == {"auction": 7, "price": 2.5, "bidder": "alice"}
    assert d2["bidder"] is None


def test_zigzag_edge_values():
    def run(p, a):
        s = a.parse_schema('{"type":"record","name":"R","fields":'
                           '[{"name":"x","type":"long"}]}')
        out = []
        for v in (0, -1, 1, 63, -64, 64, 2**40, -2**40, 2**62, -2**63):
            b = a.encode_record(s, {"x": v})
            out.append((b, a.decode_record(s, s, b)["x"]))
        return out

    out = _both(run)
    assert [v for _, v in out] == [0, -1, 1, 63, -64, 64, 2**40, -2**40,
                                   2**62, -2**63]


def test_nested_record_array_map_enum_fixed():
    schema = json.dumps({
        "type": "record", "name": "Outer", "fields": [
            {"name": "tags", "type": {"type": "array", "items": "string"}},
            {"name": "attrs", "type": {"type": "map", "values": "long"}},
            {"name": "color", "type": {"type": "enum", "name": "C",
                                       "symbols": ["RED", "BLUE"]}},
            {"name": "id", "type": {"type": "fixed", "name": "Id",
                                    "size": 4}},
            {"name": "flag", "type": "boolean"},
            {"name": "f", "type": "float"},
            {"name": "blob", "type": "bytes"},
            {"name": "inner", "type": {
                "type": "record", "name": "Inner", "fields": [
                    {"name": "v", "type": "double"}]}},
        ]})
    d = {"tags": ["a", "b"], "attrs": {"x": 1, "y": -2}, "color": "BLUE",
         "id": b"\x00\x01\x02\x03", "flag": True, "f": 1.5,
         "blob": b"\xff\n", "inner": {"v": 1.25}}

    def run(p, a):
        s = a.parse_schema(schema)
        b = a.encode_record(s, d)
        return b, a.decode_record(s, s, b)

    b, back = _both(run)
    assert back == d


class TestSchemaEvolution:
    def test_reader_evolves_over_writer(self):
        def run(p, a):
            v1, v2 = (a.parse_schema(json.dumps(s))
                      for s in (V1_JSON, V2_JSON))
            payload = a.encode_record(
                v1, {"auction": 42, "price": 9.5, "bidder": "bob"})
            return a.decode_record(v1, v2, payload)

        got = _both(run)
        assert got == {"auction": 42, "price": 9.5, "region": "emea"}
        assert isinstance(got["auction"], int)

    def test_added_field_without_default_fails_loudly(self):
        for p in PKGS.values():
            a = _avro(p)
            v1 = a.parse_schema(json.dumps(V1_JSON))
            v_bad = a.parse_schema(json.dumps({
                "type": "record", "name": "Bid", "fields": [
                    {"name": "auction", "type": "int"},
                    {"name": "price", "type": "double"},
                    {"name": "must_have", "type": "string"}]}))
            payload = a.encode_record(
                v1, {"auction": 1, "price": 1.0, "bidder": None})
            with pytest.raises(ValueError, match="must_have"):
                a.decode_record(v1, v_bad, payload)

    def test_field_matched_by_alias(self):
        def run(p, a):
            v1 = a.parse_schema(json.dumps(V1_JSON))
            renamed = a.parse_schema(json.dumps({
                "type": "record", "name": "Bid", "fields": [
                    {"name": "auction_id", "aliases": ["auction"],
                     "type": "int"},
                    {"name": "price", "type": "double"},
                    {"name": "bidder", "type": ["null", "string"],
                     "default": None}]}))
            payload = a.encode_record(
                v1, {"auction": 5, "price": 2.0, "bidder": None})
            return a.decode_record(v1, renamed, payload)["auction_id"]

        assert _both(run) == 5

    def test_union_promotion(self):
        def run(p, a):
            w = a.parse_schema('{"type":"record","name":"R","fields":'
                               '[{"name":"x","type":["null","int"]}]}')
            r = a.parse_schema('{"type":"record","name":"R","fields":'
                               '[{"name":"x","type":["null","double"]}]}')
            return a.decode_record(w, r, a.encode_record(w, {"x": 3}))["x"]

        assert _both(run) == 3.0

    def test_enum_default_and_unknown_symbol(self):
        def run(p, a):
            w = a.parse_schema(json.dumps({
                "type": "enum", "name": "E", "symbols": ["A", "B", "Z"]}))
            r = a.parse_schema(json.dumps({
                "type": "enum", "name": "E", "symbols": ["A", "B"],
                "default": "A"}))
            return [a.decode_record(w, r, a.encode_record(w, s))
                    for s in ("B", "Z")]

        assert _both(run) == ["B", "A"]

    def test_unresolvable_types_raise(self):
        for p in PKGS.values():
            a = _avro(p)
            w = a.parse_schema('"string"')
            r = a.parse_schema('"long"')
            with pytest.raises(ValueError, match="cannot resolve"):
                a.decode_record(w, r, a.encode_record(w, "x"))
            with pytest.raises(ValueError, match="unknown Avro type"):
                a.parse_schema('"Nope"')


# ----------------------------------------------------------- batch seam


def test_batch_roundtrip_with_evolution():
    def run(p, a):
        v1, v2 = (a.parse_schema(json.dumps(s)) for s in (V1_JSON, V2_JSON))
        ser = a.AvroRowSerializationSchema(["auction", "price", "bidder"],
                                           v1)
        batch = p.RecordBatch.from_pydict({
            "auction": np.arange(5, dtype=np.int64),
            "price": np.linspace(1, 2, 5),
            "bidder": np.asarray(["u%d" % i for i in range(5)],
                                 dtype=object)})
        raw = ser.serialize_batch(batch)
        de = a.AvroRowDeserializationSchema(
            ["auction", "price", "region"], ["BIGINT", "DOUBLE", "STRING"],
            v2, writer_schema=v1)
        out = de.deserialize_batch(raw)
        return raw, out["auction"].tolist(), out["price"].tolist(), \
            list(out["region"])

    raw, auctions, prices, regions = _both(run)
    assert auctions == list(range(5))
    assert regions == ["emea"] * 5


def test_ignore_parse_errors_skips_a_bad_record():
    def run(p, a):
        de, ser = p.mod("connectors.formats").resolve_format(
            "avro", ["k"], ["BIGINT"], {"avro.ignore-parse-errors": "true"})
        good = ser.serialize_batch(p.RecordBatch.from_pydict(
            {"k": np.asarray([4, 5], dtype=np.int64)}))
        out = de.deserialize_batch([good[0], b"\x02", good[1]])
        return out["k"].tolist(), de.last_surviving

    assert _both(run) == ([4, 5], [0, 2])


def test_resolve_format_ddl_options():
    def run(p, a):
        de, _ = p.mod("connectors.formats").resolve_format(
            "avro", ["auction", "price", "region"],
            ["BIGINT", "DOUBLE", "STRING"],
            {"avro.schema": json.dumps(V2_JSON),
             "avro.writer-schema": json.dumps(V1_JSON)})
        v1 = a.parse_schema(json.dumps(V1_JSON))
        out = de.deserialize_batch([a.encode_record(
            v1, {"auction": 3, "price": 4.5, "bidder": "x"})])
        return out["auction"].tolist(), list(out["region"])

    assert _both(run) == ([3], ["emea"])


def test_schema_derived_from_ddl_when_unspecified():
    def run(p, a):
        de, ser = p.mod("connectors.formats").resolve_format(
            "avro", ["k", "v"], ["BIGINT", "DOUBLE"], {})
        b = p.RecordBatch.from_pydict({
            "k": np.asarray([1, 2], dtype=np.int64),
            "v": np.asarray([0.5, 1.5])})
        raw = ser.serialize_batch(b)
        back = de.deserialize_batch(raw)
        return raw, back["k"].tolist(), back["v"].tolist(), \
            a.schema_from_ddl("row", ["k", "v"], ["BIGINT", "DOUBLE"])

    raw, k, v, schema = _both(run)
    assert (k, v) == ([1, 2], [0.5, 1.5])


# ------------------------------------------------------- SQL over Kafka


def test_avro_topic_roundtrips_through_sql_with_evolution():
    """A v1-encoded Avro topic read through CREATE TABLE under the v2
    reader schema ('format'='avro'): the evolved column takes its default
    on every row, and the GROUP BY counts equal the reference's."""
    rng = np.random.default_rng(4)
    n = 2000
    ks = rng.integers(0, 10, n)
    ts = np.arange(n, dtype=np.int64) * 4
    reader, writer = json.dumps(V2_JSON), json.dumps(V1_JSON)
    out = {}
    for name, p in PKGS.items():
        a = _avro(p)
        v1 = a.parse_schema(writer)
        broker = p.FakeBroker.get("default")
        broker.create_topic("ain", 1)
        broker.append_raw("ain", 0, [a.encode_record(
            v1, {"auction": int(k), "price": float(k) * 0.5,
                 "bidder": None}) for k in ks], timestamps=ts)
        env = p.Env(p.config(**{"execution.micro-batch.size": 500}))
        tenv = p.TEnv(env)
        tenv.execute_sql(
            "CREATE TABLE ain (auction BIGINT, price DOUBLE, region STRING) "
            "WITH ('connector'='kafka', 'topic'='ain', 'format'='avro', "
            f"'avro.schema'='{reader}', 'avro.writer-schema'='{writer}')")
        psink = p.CollectSink()
        tenv.sql_query("SELECT auction, region FROM ain WHERE auction < 3"
                       ).to_data_stream().sink_to(psink)
        env.execute("avro-projection")
        sink = p.CollectSink()
        tenv.sql_query("SELECT auction, COUNT(*) AS n FROM ain "
                       "GROUP BY auction").to_data_stream().sink_to(sink)
        env.execute("avro-sql")
        finals = {}
        for r in sink.result().to_rows():
            finals[r["auction"]] = r["n"]
        out[name] = (psink.result(), finals)
    assert_batches_equal(out["port"][0], out["reference"][0])
    assert out["port"][1] == out["reference"][1] == dict(
        collections.Counter(int(k) for k in ks))
    assert set(out["port"][0]["region"].tolist()) == {"emea"}


def test_avro_hop_sum_equals_the_raw_format():
    """23(g)'s shape at a CPU size: the same events as Avro under an
    evolved reader and as raw JSON give the same HOP(2 s, 10 s)
    ``SUM(value)`` rows, in both packages."""
    rng = np.random.default_rng(1)
    n = 20_000
    keys = rng.integers(0, 100, n)
    vals = rng.random(n).astype(np.float32)
    ts = np.arange(n, dtype=np.int64) * 10
    w1 = {"type": "record", "name": "E", "fields": [
        {"name": "k", "type": "long"}, {"name": "value", "type": "float"},
        {"name": "ts", "type": "long"}]}
    r2 = {"type": "record", "name": "E", "fields": [
        {"name": "k", "type": "long"}, {"name": "value", "type": "float"},
        {"name": "ts", "type": "long"},
        {"name": "src", "type": "string", "default": "v1"}]}
    query = ("SELECT k, window_end, SUM(value) AS s FROM TABLE(HOP("
             "TABLE {t}, DESCRIPTOR(ts), INTERVAL '2' SECOND, "
             "INTERVAL '10' SECOND)) GROUP BY k, window_start, window_end")
    out = {}
    for name, p in PKGS.items():
        a = _avro(p)
        broker = p.FakeBroker.get("default")
        writer = a.parse_schema(json.dumps(w1))
        broker.create_topic("av", 2)
        broker.create_topic("js", 2)
        for part in range(2):
            sel = slice(part, n, 2)
            broker.append_raw("av", part, [
                a.encode_record(writer, {"k": int(k), "value": float(v),
                                         "ts": int(t)})
                for k, v, t in zip(keys[sel], vals[sel], ts[sel])],
                timestamps=ts[sel])
            broker.append_raw("js", part, [
                json.dumps({"k": int(k), "value": float(v),
                            "ts": int(t)}).encode()
                for k, v, t in zip(keys[sel], vals[sel], ts[sel])],
                timestamps=ts[sel])
        rows = {}
        for topic, fmt in (("av", "avro"), ("js", "json")):
            tenv = p.tenv({"execution.micro-batch.size": 4096})
            extra = (f", 'avro.schema'='{json.dumps(r2)}', "
                     f"'avro.writer-schema'='{json.dumps(w1)}'"
                     if fmt == "avro" else "")
            tenv.execute_sql(
                f"CREATE TABLE {topic} (k BIGINT, value FLOAT, ts BIGINT, "
                "WATERMARK FOR ts AS ts) WITH ('connector'='kafka', "
                f"'topic'='{topic}', 'format'='{fmt}'{extra})")
            rows[fmt] = tenv.execute_sql(query.format(t=topic)).to_batch()
        out[name] = rows
    for name in PKGS:
        assert_batches_equal(out[name]["avro"], out[name]["json"])
    assert_batches_equal(out["port"]["avro"], out["reference"]["avro"])
    assert len(out["port"]["avro"]) > 100
