"""The columnar serializers, the binary file sink and source, and the
filesystem SPI of the port against the reference's on the CPU (the cases
of ``tests/test_types.py``'s serializer half). Every serialized form is
equal byte for byte to the reference's, snapshots resolve compatibility
alike, migrations give the same columns, and files written by
``BinaryFileSink`` for the same batches are byte-identical from both
packages and read in the other (tolerance: none).
"""

import json

import numpy as np
import pytest

from flink_tpu.connectors import sinks as jsinks
from flink_tpu.connectors import sources as jsources
from flink_tpu.core import fs as jfs
from flink_tpu.core import serializers as jser
from flink_tpu.core import types as jtypes
from flink_tpu.core.records import RecordBatch as JBatch
from flink_tpu_torch.connectors import sinks as tsinks
from flink_tpu_torch.connectors import sources as tsources
from flink_tpu_torch.core import fs as tfs
from flink_tpu_torch.core import serializers as tser
from flink_tpu_torch.core import types as ttypes
from flink_tpu_torch.core.records import RecordBatch as TBatch

PKGS = {"ref": (jser, jtypes, JBatch, jsinks, jsources, jfs),
        "port": (tser, ttypes, TBatch, tsinks, tsources, tfs)}


def _both(scenario):
    got = {name: scenario(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64, np.bool_, np.uint16])
def test_numeric_roundtrip(dtype):
    def s(ser, *_):
        arr = np.arange(17).astype(dtype)
        data = ser.NumericArraySerializer(dtype).serialize(arr)
        out = ser.NumericArraySerializer(dtype).deserialize(data)
        assert out.dtype == np.dtype(dtype)
        return data, out.tolist()

    _both(s)


def test_string_and_pickle_roundtrip():
    def s(ser, *_):
        arr = np.array(["", "héllo", "a" * 1000, "☃"], dtype=object)
        sdata = ser.StringArraySerializer().serialize(arr)
        obj = np.empty(2, dtype=object)
        obj[0] = {"nested": [1, 2]}
        obj[1] = ("t", 1)
        pdata = ser.PickleArraySerializer().serialize(obj)
        return (sdata, ser.StringArraySerializer().deserialize(sdata).tolist(),
                ser.PickleArraySerializer().deserialize(pdata).tolist())

    out = _both(s)
    assert out[1] == ["", "héllo", "a" * 1000, "☃"]


def test_numeric_compatibility_widening_and_narrowing():
    def s(ser, *_):
        old = ser.NumericArraySerializer(np.int32)
        snap = old.snapshot()
        wide = ser.NumericArraySerializer(np.int64)
        narrow = ser.NumericArraySerializer(np.int64).snapshot()
        migrated = wide.migrate(
            old.serialize(np.array([1, 2, 3], dtype=np.int32)), snap)
        return ([snap.resolve_compatibility(
                    ser.NumericArraySerializer(np.int32)).value,
                 snap.resolve_compatibility(wide).value,
                 narrow.resolve_compatibility(
                     ser.NumericArraySerializer(np.int32)).value,
                 snap.resolve_compatibility(
                     ser.StringArraySerializer()).value],
                str(migrated.dtype), migrated.tolist())

    assert _both(s) == (["as_is", "after_migration", "incompatible",
                         "incompatible"], "int64", [1, 2, 3])


def test_snapshot_json_is_the_reference_and_restores_either_way():
    """A snapshot is JSON keyed by class name: each package restores the
    other's."""
    for a, b in (("ref", "port"), ("port", "ref")):
        ser_a, ser_b = PKGS[a][0], PKGS[b][0]
        snap = ser_a.NumericArraySerializer(np.float32).snapshot().to_json()
        assert json.dumps(snap) == json.dumps(
            ser_b.NumericArraySerializer(np.float32).snapshot().to_json())
        ser = ser_b.SerializerSnapshot.from_json(snap).restore_serializer()
        arr = np.array([1.5, 2.5], dtype=np.float32)
        assert ser.deserialize(ser.serialize(arr)).tolist() == [1.5, 2.5]


def _batch(Batch):
    return Batch.from_pydict(
        {"k": np.array([1, 2, 3], dtype=np.int64),
         "v": np.array([1.0, np.nan, -0.0], dtype=np.float32),
         "s": np.array(["x", "y", "z"], dtype=object)})


def test_row_batch_roundtrip_bytes_equal():
    def s(ser, types, Batch, *_):
        rt = types.RowTypeInfo.of(k=np.int64, v=np.float32,
                                  s=types.STRING_TYPE_INFO)
        data = ser.RowBatchSerializer(rt).serialize(_batch(Batch))
        out = ser.RowBatchSerializer(rt).deserialize(data)
        return data, out["k"].tolist(), str(out["v"].dtype), \
            out["v"].view(np.uint32).tolist(), out["s"].tolist()

    _both(s)


def test_row_schema_evolution_add_remove_widen():
    def s(ser, types, Batch, *_):
        old_rt = types.RowTypeInfo.of(k=np.int32, v=np.float32,
                                      gone=np.int64)
        old_ser = ser.RowBatchSerializer(old_rt)
        data = old_ser.serialize(Batch.from_pydict(
            {"k": np.array([1, 2], dtype=np.int32),
             "v": np.array([0.5, 1.5], dtype=np.float32),
             "gone": np.array([9, 9], dtype=np.int64)}))
        snap = ser.SerializerSnapshot.from_json(old_ser.snapshot().to_json())
        new_rt = types.RowTypeInfo.of(k=np.int64, v=np.float32,
                                      fresh=np.float64, t=types.STRING_TYPE_INFO)
        new_ser = ser.RowBatchSerializer(new_rt)
        out = new_ser.migrate(data, snap)
        bad = types.RowTypeInfo.of(k=types.STRING_TYPE_INFO, v=np.float32)
        return (snap.resolve_compatibility(new_ser).value,
                {n: (str(c.dtype), c.tolist()) for n, c in
                 out.columns.items()},
                snap.resolve_compatibility(
                    ser.RowBatchSerializer(old_rt)).value,
                snap.resolve_compatibility(ser.RowBatchSerializer(bad)).value)

    compat, cols, same, bad = _both(s)
    assert (compat, same, bad) == ("after_migration", "as_is",
                                   "incompatible")
    assert cols["k"] == ("int64", [1, 2]) and "gone" not in cols
    assert cols["fresh"] == ("float64", [0.0, 0.0])
    assert cols["t"] == ("object", ["", ""])


def test_row_batch_rejects_garbage():
    for ser, types, *_ in PKGS.values():
        with pytest.raises(ValueError):
            ser.RowBatchSerializer(types.RowTypeInfo.of(k=np.int64)) \
                .deserialize(b"not a batch at all")


def test_register_serializer_extends_the_snapshot_registry():
    @tser.register_serializer
    class UpperStrings(tser.StringArraySerializer):
        pass

    snap = UpperStrings().snapshot()
    assert snap.serializer == "UpperStrings"
    assert isinstance(tser.SerializerSnapshot.from_json(
        snap.to_json()).restore_serializer(), UpperStrings)


# ------------------------------------------------------ binary file format


BATCHES = [
    {"k": np.array([1, 2], dtype=np.int32),
     "v": np.array([0.5, np.nan], dtype=np.float32),
     "s": np.array(["a", "bé"], dtype=object)},
    {"k": np.array([3], dtype=np.int32),
     "v": np.array([2.5], dtype=np.float32),
     "s": np.array([""], dtype=object)},
]


def _write(pkg, path):
    _, _, Batch, sinks, *_ = PKGS[pkg]
    sink = sinks.BinaryFileSink(path)
    sink.open()
    for cols in BATCHES:
        sink.write(Batch(dict(cols)))
    sink.close()


def test_binary_files_are_byte_identical(tmp_path):
    for pkg in PKGS:
        _write(pkg, str(tmp_path / f"{pkg}.ftb"))
    ref = (tmp_path / "ref.ftb").read_bytes()
    assert ref[:4] == b"FTFS" and (tmp_path / "port.ftb").read_bytes() == ref


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")])
def test_binary_file_sink_source_roundtrip_and_evolution(tmp_path, writer,
                                                         reader):
    path = str(tmp_path / "data.ftb")
    _write(writer, path)
    _, types, _, _, sources, _ = PKGS[reader]
    src = sources.BinaryFileSource(path)
    src.open()
    b1, b2, end = src.poll_batch(100), src.poll_batch(100), \
        src.poll_batch(100)
    src.close()
    assert b1["k"].tolist() == [1, 2] and b2["v"].tolist() == [2.5]
    assert b1["v"].view(np.uint32).tolist() == \
        BATCHES[0]["v"].view(np.uint32).tolist()
    assert b1["s"].tolist() == ["a", "bé"] and end is None
    # an evolved read: k widened, a new column filled with defaults
    rt = types.RowTypeInfo.of(k=np.int64, v=np.float32, extra=np.float64)
    src = sources.BinaryFileSource(path, row_type=rt)
    src.open()
    b = src.poll_batch(100)
    src.close()
    assert b["k"].dtype == np.int64 and b["extra"].tolist() == [0.0, 0.0]
    assert "s" not in b.columns
    # an incompatible read raises
    with pytest.raises(ValueError, match="incompatible"):
        sources.BinaryFileSource(path, row_type=types.RowTypeInfo.of(
            k=types.STRING_TYPE_INFO)).open()
    # a restored position skips the batches already read, before or after
    # open
    src = sources.BinaryFileSource(path)
    src.open()
    src.poll_batch(100)
    pos = src.snapshot_position()
    src.close()
    for before_open in (True, False):
        src2 = sources.BinaryFileSource(path)
        if before_open:
            src2.restore_position(pos)
            src2.open()
        else:
            src2.open()
            src2.restore_position(pos)
        assert src2.poll_batch(100)["k"].tolist() == [3]
        assert src2.poll_batch(100) is None
        src2.close()


def test_not_a_binary_file_raises(tmp_path):
    p = tmp_path / "x.ftb"
    p.write_bytes(b"JUNKJUNK")
    for *_, sources, _ in PKGS.values():
        with pytest.raises(ValueError, match="not a binary batch file"):
            sources.BinaryFileSource(str(p)).open()


def test_binary_file_job_through_both_packages(tmp_path):
    """A job's sink writes the same file in both packages; the port reads
    the reference's back as a source of another job."""
    import flink_tpu
    import flink_tpu_torch

    mods = {"ref": (flink_tpu, {"execution.pipeline.in-flight-batches": 0}),
            "port": (flink_tpu_torch, {"execution.device": "cpu",
                                       "execution.pipeline.in-flight-batches":
                                       0})}
    rows = [{"k": i % 3, "v": float(i) / 3, "ts": 10 * i} for i in range(50)]
    for pkg, (mod, conf) in mods.items():
        env = mod.StreamExecutionEnvironment(mod.Configuration(
            {"execution.micro-batch.size": 16, **conf}))
        env.from_collection(rows, timestamp_field="ts").sink_to(
            PKGS[pkg][3].BinaryFileSink(str(tmp_path / f"{pkg}.ftb")))
        env.execute()
    data = (tmp_path / "ref.ftb").read_bytes()
    assert (tmp_path / "port.ftb").read_bytes() == data
    env = flink_tpu_torch.StreamExecutionEnvironment(
        flink_tpu_torch.Configuration({"execution.device": "cpu"}))
    out = env.from_source(
        tsources.BinaryFileSource(str(tmp_path / "ref.ftb"))) \
        .execute_and_collect()
    assert out["k"].tolist() == [r["k"] for r in rows]
    assert out.timestamps.tolist() == [r["ts"] for r in rows]


# ------------------------------------------------------------- filesystems


def test_memory_filesystem_matches_reference():
    def s(*mods):
        fs = mods[5].InMemoryFileSystem()
        with fs.open("/b/x/a.bin", "wb") as f:
            f.write(b"abc")
        with fs.open("b/x/a.bin", "ab") as f:
            f.write(b"d")
        fs.mkdirs("b/empty")
        out = [fs.open("b/x/a.bin").read(), fs.exists("b/x"),
               fs.listdir("b"), fs.listdir("")]
        fs.rename("b/x", "b/y")
        out += [fs.exists("b/x/a.bin"), fs.open("b/y/a.bin").read()]
        fs.delete("b", recursive=True)
        out.append(fs.exists("b/y/a.bin"))
        with pytest.raises(FileNotFoundError):
            fs.open("nope")
        return out

    assert _both(s) == [b"abcd", True, ["empty", "x"], ["b"], False, b"abcd",
                        False]


def test_registered_schemes_resolve_and_unregistered_raise():
    class Loud(tfs.InMemoryFileSystem):
        pass

    tfs.register_filesystem("loud", Loud())
    fs, local = tfs.get_filesystem("loud://bucket/k")
    assert isinstance(fs, Loud) and local == "bucket/k"
    assert isinstance(tfs.get_filesystem("/tmp/x")[0], tfs.LocalFileSystem)
    for mod in (jfs, tfs):
        with pytest.raises(ValueError, match="no filesystem registered"):
            mod.get_filesystem("s3://bucket/x")
