"""OVER aggregates of the port against the reference, on the CPU.

The host engine (``runtime/over_agg.py``) is NumPy in both packages, so
its rows must equal the reference's bit for bit and in emission order,
operator by operator and through SQL. The device engine
(``runtime/over_device.py``, torch ops on ``execution.device``, here the
CPU) is held to the reference's own tolerance against the host engine,
``rtol=2e-4, atol=1e-5`` (``tests/test_over_device.py``): its float64
prefix sums associate differently from NumPy's per-segment ones, and the
reference's device program runs float32 without x64. COUNT, MIN and MAX,
the keys, the timestamps, the passthrough column and the row order
compare exactly. The cases are those of ``tests/test_over_agg.py`` and
``tests/test_over_device.py``, plus the port's own: the counted degrade,
the ``auto`` engine's deviation, and snapshots carried across packages
through ``convert.from_jax_over_state``.
"""

import collections

import numpy as np
import pytest
import torch

from tests.test_torch_mesh_sessions import _bits
from tests.test_torch_sql import PKGS, assert_batches_equal

FUNCS = ["SUM", "COUNT", "AVG", "MIN", "MAX"]
#: the reference's tolerance for the device engine against the host
#: engine (tests/test_over_device.py:68-71)
RTOL, ATOL = 2e-4, 1e-5
#: the port's device engine against its own host engine: both float64
TIGHT_ATOL = 1e-9


class _Ctx:
    max_parallelism = 128
    device = "cpu"


def ops(pkg):
    over = pkg.mod("runtime.over_agg")
    dev = pkg.mod("runtime.over_device")
    return over.OverAggOperator, dev.DeviceOverAggOperator


def _stream(pkg, rng, n_batches=6, rows_per_batch=40, n_keys=7, ts_step=50):
    """tests/test_over_device.py's stream: random batches with rising
    watermarks, every row above the previous watermark."""
    rec = pkg.records
    batches, wms = [], []
    wm = 0
    for _ in range(n_batches):
        new_wm = wm + ts_step * 10
        ts = rng.integers(wm + 1, new_wm + ts_step * 3, size=rows_per_batch)
        keys = rng.integers(0, n_keys, size=rows_per_batch)
        batches.append(rec.RecordBatch(
            {rec.KEY_ID_FIELD: keys.astype(np.int64),
             "k": keys.astype(np.int64),
             "x": rng.normal(size=rows_per_batch).round(3),
             rec.TIMESTAMP_FIELD: ts.astype(np.int64)}))
        wms.append(new_wm)
        wm = new_wm
    return batches, wms


def _streams(seed, **kw):
    return {name: _stream(p, np.random.default_rng(seed), **kw)
            for name, p in PKGS.items()}


def _run(op, batches, wms):
    outs = []
    op.open(_Ctx())
    for b, wm in zip(batches, wms):
        op.process_batch(b)
        outs.extend(op.process_watermark(wm))
    outs.extend(op.close())
    return type(batches[0]).concat(outs) if outs else None


def _specs(funcs=FUNCS):
    return [(f, None if f == "COUNT" else "x", f"__o{i}__")
            for i, f in enumerate(funcs)]


def _assert_device_close(want, got, specs, atol=ATOL, rtol=RTOL,
                         exact=("COUNT", "MIN", "MAX")):
    """``got`` (a device engine's rows) against ``want`` (a host
    engine's): keys, timestamps, the passthrough column and the row
    order exactly; COUNT/MIN/MAX exactly; SUM/AVG within tolerance.
    Returns the largest absolute error seen."""
    assert (want is None) == (got is None)
    if want is None:
        return 0.0
    assert len(want) == len(got)
    for c in ("k", "x"):
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]))
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    worst = 0.0
    for func, _, name in specs:
        a = np.asarray(got[name], dtype=np.float64)
        b = np.asarray(want[name], dtype=np.float64)
        if func in exact:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=name)
            worst = max(worst, float(np.max(np.abs(a - b), initial=0.0)))
    return worst


# ------------------------------------------------------------ host engine


@pytest.mark.parametrize("mode,preceding,funcs", [
    ("ROWS", None, FUNCS), ("RANGE", None, FUNCS), ("ROWS", 5, FUNCS),
    ("ROWS", 0, FUNCS), ("RANGE", 300, FUNCS), ("RANGE", 1, FUNCS),
])
def test_host_engine_equals_reference_bit_for_bit(mode, preceding, funcs):
    streams = _streams(42)
    out = {name: _run(ops(p)[0]("k", _specs(funcs), mode=mode,
                                preceding=preceding), *streams[name])
           for name, p in PKGS.items()}
    assert_batches_equal(out["port"], out["reference"])


def test_host_engine_snapshot_equals_reference_and_restores_across():
    streams = _streams(9)
    snaps, ops_ = {}, {}
    for name, p in PKGS.items():
        op = ops(p)[0]("k", _specs(), mode="RANGE", preceding=400)
        op.open(_Ctx())
        batches, wms = streams[name]
        for b, wm in zip(batches[:3], wms[:3]):
            op.process_batch(b)
            op.process_watermark(wm)
        op.process_batch(batches[3])        # pending rows in the snapshot
        snaps[name], ops_[name] = op.snapshot_state(), op
    want, got = snaps["reference"], snaps["port"]
    assert got["over_emitted_wm"] == want["over_emitted_wm"]
    assert got["over_context"].keys() == want["over_context"].keys()
    for k in want["over_context"]:
        for c in want["over_context"][k]:
            np.testing.assert_array_equal(
                _bits(got["over_context"][k][c]),
                _bits(want["over_context"][k][c]))
    # a port operator restored from the reference's snapshot continues
    # with the reference's rows
    from flink_tpu_torch.convert import from_jax_over_state

    p = PKGS["port"]
    op = ops(p)[0]("k", _specs(), mode="RANGE", preceding=400)
    op.open(_Ctx())
    op.restore_state(from_jax_over_state(want))
    outs = {"port": [], "reference": []}
    for name, o in (("port", op), ("reference", ops_["reference"])):
        batches, wms = streams[name]
        outs[name].extend(o.process_watermark(wms[3]))
        for b, wm in zip(batches[4:], wms[4:]):
            o.process_batch(b)
            outs[name].extend(o.process_watermark(wm))
        outs[name].extend(o.close())
    assert_batches_equal(p.RecordBatch.concat(outs["port"]),
                         PKGS["reference"].RecordBatch.concat(
                             outs["reference"]))


def test_range_peer_rows_share_frames():
    """SQL RANGE frames include the current row's rowtime PEERS
    (tests/test_over_agg.py)."""
    got = {}
    for name, p in PKGS.items():
        op = ops(p)[0]("k", [("SUM", "v", "s")], mode="RANGE",
                       preceding=10_000)
        op.open(_Ctx())
        op.process_batch(p.RecordBatch.from_pydict(
            {"k": np.asarray([1, 1, 1]), "v": np.asarray([1.0, 2.0, 4.0])},
            timestamps=np.asarray([100, 100, 200])))
        out = op.process_watermark(10_000)[0]
        got[name] = out
    assert_batches_equal(got["port"], got["reference"])
    assert got["port"]["s"].tolist() == [3.0, 3.0, 7.0]


# ------------------------------------------------------------ SQL surface


def _data(n=3000, keys=25, seed=11):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, keys, n).astype(np.int64)
    vs = np.round(rng.random(n), 4)
    ts = np.arange(n, dtype=np.int64) * 7
    return ks, vs, ts


def _mk_table(p, tenv, topic, ks, vs, ts, parts=2, watermark=True):
    broker = p.FakeBroker.get("default")
    broker.create_topic(topic, parts)
    for part in range(parts):
        m = ks % parts == part
        broker.append(topic, part, p.RecordBatch.from_pydict(
            {"key": ks[m], "value": vs[m], "ts": ts[m]}, timestamps=ts[m]))
    wm = ", WATERMARK FOR ts AS ts" if watermark else ""
    tenv.execute_sql(
        f"CREATE TABLE {topic} (key BIGINT, value DOUBLE, ts BIGINT{wm}) "
        f"WITH ('connector'='kafka', 'topic'='{topic}')")


def _sql_both(sql, data, engine="host", **cfg):
    out = {}
    for name, p in PKGS.items():
        p.FakeBroker.reset()
        tenv = p.tenv({"execution.micro-batch.size": 257,
                       "table.exec.over.engine": engine, **cfg})
        _mk_table(p, tenv, "t", *data)
        out[name] = tenv.execute_sql(sql).to_batch()
    return out


def _oracle(ks, vs, ts, mode, preceding, func):
    """tests/test_over_agg.py's per-key frames (unique timestamps)."""
    per_key = collections.defaultdict(list)
    for k, v, t in sorted(zip(ks, vs, ts), key=lambda r: (r[0], r[2])):
        per_key[k].append((t, v))
    out = {}
    for k, rows in per_key.items():
        tss = [t for t, _ in rows]
        vals = [v for _, v in rows]
        for i in range(len(rows)):
            if preceding is None:
                lo = 0
            elif mode == "ROWS":
                lo = max(i - preceding, 0)
            else:
                lo = next(j for j in range(i + 1)
                          if tss[j] >= tss[i] - preceding)
            frame = vals[lo:i + 1]
            out[(k, tss[i])] = {
                "SUM": sum(frame), "COUNT": float(len(frame)),
                "AVG": sum(frame) / len(frame), "MIN": min(frame),
                "MAX": max(frame)}[func]
    return out


def _check_oracle(batch, oracle, col="r"):
    assert len(batch) == len(oracle)
    for k, t, r in zip(batch["key"].tolist(), batch["ts"].tolist(),
                       batch[col].tolist()):
        assert r == pytest.approx(oracle[(k, t)], rel=1e-6), (k, t)


@pytest.mark.parametrize("func", ["SUM", "AVG", "MIN", "MAX"])
def test_sql_rows_preceding(func):
    data = _data()
    sql = (f"SELECT key, ts, {func}(value) OVER (PARTITION BY key ORDER BY "
           "ts ROWS BETWEEN 10 PRECEDING AND CURRENT ROW) AS r FROM t")
    out = _sql_both(sql, data)
    assert_batches_equal(out["port"], out["reference"])
    _check_oracle(out["port"], _oracle(*data, "ROWS", 10, func))
    dev = _sql_both(sql, data, engine="device")["port"]
    _assert_device_close(_as_k(out["port"]), _as_k(dev),
                         [(func, "value", "r")])


def _as_k(batch):
    """The SQL rows in the shape ``_assert_device_close`` reads."""
    cols = dict(batch.columns)
    cols["k"] = cols["key"]
    cols["x"] = cols.get("value", cols["key"])
    return type(batch)(cols)


def test_sql_range_interval_preceding():
    data = _data()
    sql = ("SELECT key, ts, value, SUM(value) OVER (PARTITION BY key ORDER "
           "BY ts RANGE BETWEEN INTERVAL '1' SECOND PRECEDING AND CURRENT "
           "ROW) AS r FROM t")
    out = _sql_both(sql, data)
    assert_batches_equal(out["port"], out["reference"])
    _check_oracle(out["port"], _oracle(*data, "RANGE", 1000, "SUM"))


def test_sql_unbounded_preceding_default_frame():
    data = _data(n=1500)
    sql = ("SELECT key, ts, COUNT(*) OVER (PARTITION BY key ORDER BY ts) "
           "AS r FROM t")
    out = _sql_both(sql, data)
    assert_batches_equal(out["port"], out["reference"])
    _check_oracle(out["port"], _oracle(*data, "RANGE", None, "COUNT"))


def test_sql_multiple_aggs_one_window():
    data = _data(n=1200)
    out = _sql_both(
        "SELECT key, ts, SUM(value) OVER (PARTITION BY key ORDER BY ts ROWS "
        "BETWEEN 4 PRECEDING AND CURRENT ROW) AS s, COUNT(*) OVER (PARTITION "
        "BY key ORDER BY ts ROWS BETWEEN 4 PRECEDING AND CURRENT ROW) AS c "
        "FROM t", data)
    assert_batches_equal(out["port"], out["reference"])
    _check_oracle(out["port"], _oracle(*data, "ROWS", 4, "SUM"), "s")
    _check_oracle(out["port"], _oracle(*data, "ROWS", 4, "COUNT"), "c")


def test_sql_alias_cannot_clobber_source_column():
    data = _data(n=200)
    out = _sql_both(
        "SELECT value AS v, SUM(value) OVER (PARTITION BY key ORDER BY ts "
        "ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) AS value FROM t", data)
    assert_batches_equal(out["port"], out["reference"])
    assert sorted(out["port"]["v"].tolist()) == sorted(data[1].tolist())


BAD_OVER = {
    "mixed_window_specs": (
        "same window",
        "SELECT key, SUM(value) OVER (PARTITION BY key ORDER BY ts ROWS "
        "BETWEEN 4 PRECEDING AND CURRENT ROW) AS a, SUM(value) OVER "
        "(PARTITION BY key ORDER BY ts ROWS BETWEEN 9 PRECEDING AND CURRENT "
        "ROW) AS b FROM t", True),
    "order_by_non_time": (
        "event-time",
        "SELECT key, SUM(value) OVER (PARTITION BY key ORDER BY value ROWS "
        "BETWEEN 4 PRECEDING AND CURRENT ROW) AS a FROM t", True),
    "no_time_attribute": (
        "event-time",
        "SELECT key, MAX(value) OVER (PARTITION BY key ORDER BY value) AS m "
        "FROM t", False),
    "nested_over": (
        "top-level",
        "SELECT key, SUM(value) OVER (PARTITION BY key ORDER BY ts) + 1 AS r "
        "FROM t", True),
}


@pytest.mark.parametrize("case", sorted(BAD_OVER))
def test_sql_bad_over_raises_as_the_reference(case):
    match, sql, watermark = BAD_OVER[case]
    msgs = {}
    for name, p in PKGS.items():
        p.FakeBroker.reset()
        tenv = p.tenv()
        _mk_table(p, tenv, "t", *_data(n=50), watermark=watermark)
        with pytest.raises(p.PlanError, match=match) as e:
            tenv.execute_sql(sql)
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]


def test_fractional_rows_frame_rejected():
    for p in PKGS.values():
        with pytest.raises(p.parser.SqlParseError, match="whole row count"):
            p.parser.parse("SELECT SUM(v) OVER (PARTITION BY k ORDER BY ts "
                           "ROWS BETWEEN 2.7 PRECEDING AND CURRENT ROW) "
                           "FROM t")


# ---------------------------------------------------------- device engine


@pytest.mark.parametrize("mode,preceding,funcs", [
    ("ROWS", None, FUNCS), ("RANGE", None, FUNCS), ("ROWS", 5, FUNCS),
    ("ROWS", 1, FUNCS), ("ROWS", 0, FUNCS), ("ROWS", 40, FUNCS),
    ("RANGE", 300, ["SUM", "COUNT", "AVG"]), ("RANGE", 1, ["SUM", "AVG"]),
])
def test_device_engine_matches_host_and_reference(mode, preceding, funcs):
    """The port's device engine against the reference's host engine and
    the reference's device engine at the reference's tolerance, and
    against the port's host engine to 1e-9 (both float64)."""
    streams = _streams(42)
    specs = _specs(funcs)
    ref_host, ref_dev = (
        _run(cls("k", specs, mode=mode, preceding=preceding),
             *streams["reference"]) for cls in ops(PKGS["reference"]))
    host_cls, dev_cls = ops(PKGS["port"])
    host = _run(host_cls("k", specs, mode=mode, preceding=preceding),
                *streams["port"])
    dev_op = dev_cls("k", specs, mode=mode, preceding=preceding,
                     device="cpu")
    dev = _run(dev_op, *streams["port"])
    _assert_device_close(ref_host, dev, specs)
    # the reference's device program returns float32 without x64, so only
    # its counts are exact
    _assert_device_close(ref_dev, dev, specs, exact=("COUNT",))
    _assert_device_close(host, dev, specs, atol=TIGHT_ATOL, rtol=0)
    assert dev_op.counters() == {"over_device_fires": 7,
                                 "over_host_fires": 0, "over_degrades": 0,
                                 "over_late_records_dropped": 0}


@pytest.mark.parametrize("n_keys,seed", [(1, 1), (100, 2)])
def test_device_engine_single_key_and_many_keys(n_keys, seed):
    streams = _streams(seed, n_batches=4, rows_per_batch=60, n_keys=n_keys)
    specs = _specs()
    ref = _run(ops(PKGS["reference"])[0]("k", specs, "ROWS", 3),
               *streams["reference"])
    dev = _run(ops(PKGS["port"])[1]("k", specs, "ROWS", 3, device="cpu"),
               *streams["port"])
    _assert_device_close(ref, dev, specs)


def test_device_engine_duplicate_timestamps():
    streams = _streams(3, ts_step=2)
    specs = _specs(["SUM", "COUNT", "MIN"])
    ref = _run(ops(PKGS["reference"])[0]("k", specs, "RANGE", None),
               *streams["reference"])
    dev = _run(ops(PKGS["port"])[1]("k", specs, "RANGE", None,
                                    device="cpu"), *streams["port"])
    _assert_device_close(ref, dev, specs)


def test_range_unbounded_stays_on_device_across_fires():
    batches, wms = _stream(PKGS["port"], np.random.default_rng(7),
                           n_batches=5)
    specs = _specs(["SUM", "AVG", "COUNT"])
    op = ops(PKGS["port"])[1]("k", specs, mode="RANGE", preceding=None,
                              device="cpu")
    out = _run(op, batches, wms)
    assert not op._fallback and op.degrades == 0
    assert op.device_fires >= 2 and len(out) == sum(map(len, batches))


def test_device_supported_matrix_and_refusal_as_the_reference():
    for p in PKGS.values():
        ds = p.mod("runtime.over_device").device_supported
        assert ds(_specs(["SUM"]), "RANGE", 10)
        assert not ds(_specs(["MIN"]), "RANGE", 10)
        assert ds(_specs(["MIN"]), "RANGE", None)
        assert ds(_specs(["MIN"]), "ROWS", 10)
        with pytest.raises(ValueError, match="RANGE MIN/MAX"):
            ops(p)[1]("k", _specs(["MIN"]), "RANGE", 10)


def test_device_checkpoint_restore_midstream_and_across_packages():
    """A device engine restored mid-stream — from its own snapshot, and
    from the reference device engine's through ``from_jax_over_state`` —
    continues with the rows of an uninterrupted run."""
    from flink_tpu_torch.convert import from_jax_over_state

    streams = _streams(9)
    specs = _specs()
    dev_cls = ops(PKGS["port"])[1]
    batches, wms = streams["port"]
    whole = _run(dev_cls("k", specs, "ROWS", 4, device="cpu"),
                 batches, wms)

    ref_op = ops(PKGS["reference"])[1]("k", specs, "ROWS", 4)
    ref_op.open(_Ctx())
    rb, rw = streams["reference"]
    for b, wm in zip(rb[:3], rw[:3]):
        ref_op.process_batch(b)
        ref_op.process_watermark(wm)
    own = dev_cls("k", specs, "ROWS", 4, device="cpu")
    own.open(_Ctx())
    head = []
    for b, wm in zip(batches[:3], wms[:3]):
        own.process_batch(b)
        head.extend(own.process_watermark(wm))
    for snap in (own.snapshot_state(),
                 from_jax_over_state(ref_op.snapshot_state())):
        op = dev_cls("k", specs, "ROWS", 4, device="cpu")
        op.open(_Ctx())
        op.restore_state(snap)
        outs = list(head)
        for b, wm in zip(batches[3:], wms[3:]):
            op.process_batch(b)
            outs.extend(op.process_watermark(wm))
        outs.extend(op.close())
        _assert_device_close(whole, PKGS["port"].RecordBatch.concat(outs),
                             specs)


@pytest.mark.parametrize("mode,preceding,at", [
    ("RANGE", 300, 3), ("RANGE", None, 2)])
def test_degrade_to_host_keeps_context(mode, preceding, at):
    """A degrade converts the flat context to the host engine's form and
    the rows go on equal to the host engine's (the reference's
    ``_degrade_to_host`` cases)."""
    streams = _streams(5 if preceding else 6)
    specs = _specs(["SUM", "AVG"] if preceding else FUNCS)
    host = _run(ops(PKGS["reference"])[0]("k", specs, mode, preceding),
                *streams["reference"])
    op = ops(PKGS["port"])[1]("k", specs, mode, preceding, device="cpu")
    op.open(_Ctx())
    outs = []
    batches, wms = streams["port"]
    for i, (b, wm) in enumerate(zip(batches, wms)):
        if i == at:
            op._degrade_to_host()
        op.process_batch(b)
        outs.extend(op.process_watermark(wm))
    outs.extend(op.close())
    _assert_device_close(host, PKGS["port"].RecordBatch.concat(outs), specs)
    assert op.degrades == 1


def test_span_guard_degrade_is_counted_and_rows_stay_right():
    """A RANGE fire whose timestamps span 2^41 ms moves to the host engine
    for good, as the reference's does; the port counts it (never silent)
    in the operator's counters and in the job's metrics."""
    p = PKGS["port"]
    rec = p.records
    far = 1 << 42
    ts = np.asarray([10, 20, 30, far, far + 5, far + 9], np.int64)
    ks = np.asarray([1, 2, 1, 1, 2, 2], np.int64)
    vs = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    specs = [("SUM", "x", "s"), ("COUNT", None, "c")]

    def batch(pkg, sl):
        r = pkg.records
        return pkg.RecordBatch({"k": ks[sl], "x": vs[sl],
                                r.KEY_ID_FIELD: ks[sl],
                                r.TIMESTAMP_FIELD: ts[sl]})

    rows = {}
    for name, pkg in PKGS.items():
        cls = ops(pkg)[0]
        op = (cls("k", specs, "RANGE", 1000) if name == "reference"
              else ops(pkg)[1]("k", specs, "RANGE", 1000, device="cpu"))
        op.open(_Ctx())
        outs = []
        op.process_batch(batch(pkg, slice(0, 3)))
        outs.extend(op.process_watermark(100))
        op.process_batch(batch(pkg, slice(3, 6)))
        outs.extend(op.process_watermark(far + 100))
        rows[name] = (pkg.RecordBatch.concat(outs), op)
    got, op = rows["port"]
    assert op.counters() == {"over_device_fires": 1, "over_host_fires": 1,
                             "over_degrades": 1,
                             "over_late_records_dropped": 0}
    want = rows["reference"][0]
    assert_batches_equal(got, want)
    assert got["s"].tolist() == [1.0, 4.0, 2.0, 4.0, 5.0, 11.0]
    assert rec.TIMESTAMP_FIELD in got.columns

    # through SQL the count reaches the job's metrics
    tenv = p.tenv({"table.exec.over.engine": "device"})
    tenv.create_temporary_view("t", tenv.from_collection(
        [{"k": int(k), "v": float(v), "ts": int(t)}
         for k, v, t in zip(ks, vs, ts)], timestamp_field="ts"))
    tenv.execute_sql("SELECT k, COUNT(*) OVER (PARTITION BY k ORDER BY ts "
                     "RANGE BETWEEN INTERVAL '1' SECOND PRECEDING AND "
                     "CURRENT ROW) AS n FROM t").to_batch()
    per_op = tenv.env.last_execution_result.metrics["per_operator"]
    over = [v for k, v in per_op.items() if k.startswith("sql_over_agg")]
    assert len(over) == 1 and over[0]["over_degrades"] == 1


def test_sql_over_engine_config_and_the_auto_deviation():
    """``table.exec.over.engine`` picks the engine through SQL in the
    port. Deviation, stated: the port's device program computes float64
    on every device, so its ``auto`` is the device engine wherever
    ``device_supported`` holds — the reference's ``auto`` picks the device
    engine only under JAX x64 (``flink_tpu/table/planner.py:905-921``), and
    stays on the host here where x64 is off."""
    rng = np.random.default_rng(13)
    n = 400
    data = (rng.integers(0, 9, n).astype(np.int64),
            np.round(rng.random(n), 4), np.arange(n, dtype=np.int64) * 7)
    sql = ("SELECT key, ts, value, SUM(value) OVER (PARTITION BY key ORDER "
           "BY ts ROWS BETWEEN 10 PRECEDING AND CURRENT ROW) AS r FROM t")
    res, planned = {}, {}
    for engine in ("host", "device", "auto"):
        out = _sql_both(sql, data, engine=engine,
                        **{"execution.micro-batch.size": 101})
        res[engine] = out
        for name, p in PKGS.items():
            tenv = p.tenv({"table.exec.over.engine": engine})
            _mk_table(p, tenv, "t2", *data)
            t = tenv.sql_query(sql.replace("FROM t", "FROM t2"))
            op = _over_node(t.stream.transformation).operator_factory()
            planned[(name, engine)] = type(op).__name__
    assert planned == {
        ("reference", "host"): "OverAggOperator",
        ("port", "host"): "OverAggOperator",
        ("reference", "device"): "DeviceOverAggOperator",
        ("port", "device"): "DeviceOverAggOperator",
        ("reference", "auto"): "OverAggOperator",        # x64 off
        ("port", "auto"): "DeviceOverAggOperator"}
    assert_batches_equal(res["host"]["port"], res["host"]["reference"])
    spec = [("SUM", "value", "r")]
    _assert_device_close(_as_k(res["host"]["reference"]),
                         _as_k(res["auto"]["port"]), spec)
    _assert_device_close(_as_k(res["host"]["reference"]),
                         _as_k(res["device"]["port"]), spec)


def _over_node(t):
    while t.name != "sql_over_agg":
        t = t.inputs[0]
    return t


# --------------------------------------------------- the program's pieces


def test_torch_minimum_maximum_agree_with_numpy_on_nan_and_signed_zero():
    """The segmented MIN/MAX relies on torch.minimum/maximum propagating
    NaN as jnp.minimum/np.minimum do; on signed zeros the value compares
    equal either way (-0.0 == 0.0), which is how the rows compare."""
    a = np.asarray([np.nan, 1.0, -0.0, 0.0, np.inf, -np.inf, 2.0])
    b = np.asarray([1.0, np.nan, 0.0, -0.0, np.nan, 3.0, -np.inf])
    for t_op, n_op in ((torch.minimum, np.minimum),
                       (torch.maximum, np.maximum)):
        got = t_op(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = n_op(a, b)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_scan_equals_numpy_segmented_accumulate(seed):
    from flink_tpu_torch.runtime.over_device import seg_scan

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    x = rng.normal(size=n)
    x[rng.random(n) < 0.05] = np.nan
    boundary = rng.random(n) < 0.1
    boundary[0] = True
    for t_op, n_op in ((torch.minimum, np.minimum),
                       (torch.maximum, np.maximum)):
        got = seg_scan(t_op, torch.from_numpy(boundary),
                       torch.from_numpy(x)).numpy()
        starts = np.r_[np.flatnonzero(boundary), n]
        want = np.concatenate([n_op.accumulate(x[a:b])
                               for a, b in zip(starts[:-1], starts[1:])])
        np.testing.assert_array_equal(got, want)


def test_device_engine_without_a_card_raises_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    op = ops(PKGS["port"])[1]("k", _specs(["SUM"]), "ROWS", 2)
    with pytest.raises(RuntimeError, match="execution.device"):
        op.open(type("Ctx", (), {"max_parallelism": 128, "device": None}))
