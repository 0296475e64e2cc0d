"""The native columnar codec (``native/codec.py`` over
``native/codec.cpp``, built through the port's own loader) against the
reference's: the wire format is the reference's byte for byte, so a
batch encoded by one package decodes in the other. Tolerance: none
(arrays and bytes compare exactly)."""

import numpy as np
import pytest

from flink_tpu.core.records import RecordBatch as JBatch
from flink_tpu.native import codec as jcodec
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.native import codec


def _numeric(cls, seed=0, n=1000):
    rng = np.random.default_rng(seed)
    return cls({
        "i64": rng.integers(-5, 5, n),
        "i32": rng.integers(0, 100, n).astype(np.int32),
        "f32": rng.random(n).astype(np.float32),
        "f64": rng.random(n),
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "b": rng.random(n) > 0.5,
        "m": rng.random((n, 3)),
        "s": np.array([f"k{i % 17}" for i in range(n)], dtype=object),
    })


def _same(a, b):
    assert list(a.columns) == list(b.columns)
    for name in a.columns:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tolist() == y.tolist(), name


def test_the_codec_builds():
    assert codec.codec_available()


@pytest.mark.parametrize("compress", [True, False])
def test_encodings_are_the_references_bytes(compress):
    port = codec.encode_batch(_numeric(RecordBatch), compress=compress)
    ref = jcodec.encode_batch(_numeric(JBatch), compress=compress)
    assert port == ref


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_batches_cross_the_packages(direction):
    objs = np.array([(1, 2), None, {"z": 3}, "mixed"], dtype=object)
    if direction == "port-to-ref":
        b = _numeric(RecordBatch, 1, 4).with_column("o", objs)
        out = jcodec.decode_batch(codec.encode_batch(b))
    else:
        b = _numeric(JBatch, 1, 4).with_column("o", objs)
        out = codec.decode_batch(jcodec.encode_batch(b))
    _same(b, out)


def test_empty_and_compressible_batches():
    empty = RecordBatch({"x": np.zeros(0, np.int64)})
    _same(empty, codec.decode_batch(codec.encode_batch(empty)))
    ones = RecordBatch({"x": np.ones(100_000, np.int64)})
    data = codec.encode_batch(ones)
    assert len(data) < 100_000 * 8 // 10
    _same(ones, codec.decode_batch(data))


def test_corruption_fails_loudly():
    data = bytearray(codec.encode_batch(_numeric(RecordBatch)))
    for pos in (len(data) // 2, len(data) - 1, 20):
        bad = bytearray(data)
        bad[pos] ^= 0xFF
        with pytest.raises(ValueError):
            codec.decode_batch(bytes(bad))
    with pytest.raises(ValueError):
        codec.decode_batch(bytes(data[: len(data) // 2]))


def test_sort_merge_runs_use_the_codec():
    from flink_tpu_torch.runtime.sort_merge_shuffle import _decode, _encode

    b = _numeric(RecordBatch, 2, 50)
    data = _encode(b)
    assert data[:1] == b"C"
    _same(b, _decode(data))
