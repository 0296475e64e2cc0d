"""Native columnar wire codec (port of ``flink_tpu/native/codec.py``
over ``native/codec.cpp``, built through the port's own loader) and the
batch frame format.

A RecordBatch crosses the wire as ONE C++ codec block whose raw payload is

    u32 meta_len | meta (struct-packed column table incl. shapes) | columns

— the column metadata rides INSIDE the CRC-protected (and compressed)
payload, so a bit flip in a dtype string or shape fails the CRC exactly
like one in the column bytes. ``columns`` is every column's raw buffer
concatenated, LZ-compressed when that wins, CRC-protected. Numeric
columns are zero-copy on decode (np.frombuffer views into one contiguous
decode buffer). Object columns ride as UTF-8 or pickle sub-blobs inside
the payload — pickle only for non-string objects; a frame that was
corrupted or truncated fails the CRC before any column is materialized.

The wire format is the reference's byte for byte: a batch encoded by one
package decodes in the other. The reference pickles object columns with
``cloudpickle``; the port uses ``pickle`` (the reference's decoder reads
plain pickle, and the port's reads the reference's cloudpickle blobs of
plain objects).

Receivers of a native frame without the library fail with a precise
error naming the fix.
"""

from __future__ import annotations

import ctypes
import pickle
import struct
import threading

import numpy as np

from flink_tpu_torch.core.records import RecordBatch

_lock = threading.Lock()
_lib = None
_tried = False


def load_codec():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        from flink_tpu_torch.native import load_native

        lib = load_native("codec.cpp", "_codec.so")
        if lib is None:
            return None
        c = ctypes
        u8p = c.POINTER(c.c_uint8)
        lib.codec_encode.restype = c.c_int
        lib.codec_encode.argtypes = [u8p, c.c_uint64, c.c_int,
                                     c.POINTER(u8p),
                                     c.POINTER(c.c_uint64)]
        lib.codec_raw_len.restype = c.c_int64
        lib.codec_raw_len.argtypes = [u8p, c.c_uint64]
        lib.codec_decode.restype = c.c_int
        lib.codec_decode.argtypes = [u8p, c.c_uint64, u8p, c.c_uint64]
        lib.codec_free.restype = None
        lib.codec_free.argtypes = [u8p]
        _lib = lib
        return _lib


def codec_available() -> bool:
    return load_codec() is not None


def _require_codec():
    lib = load_codec()
    if lib is None:
        raise RuntimeError(
            "received a native-codec frame but the codec library is "
            "unavailable on this node (g++ missing, build failed, or "
            "FLINK_TPU_NO_NATIVE=1) — every shuffle participant needs "
            "the same transport capabilities")
    return lib


def _u8_ptr(buf) -> "ctypes.POINTER":
    """Zero-copy uint8 pointer into any buffer-protocol object."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr)


def _encode_block(payload: bytes, compress: bool) -> bytes:
    lib = _require_codec()
    c = ctypes
    ptr, n = _u8_ptr(payload)
    out = c.POINTER(c.c_uint8)()
    out_len = c.c_uint64()
    rc = lib.codec_encode(ptr, n, 1 if compress else 0,
                          c.byref(out), c.byref(out_len))
    if rc != 0:
        raise MemoryError("codec_encode failed")
    try:
        return bytes(c.cast(
            out, c.POINTER(c.c_uint8 * out_len.value)).contents)
    finally:
        lib.codec_free(out)


def _decode_block(block) -> np.ndarray:
    """Frame -> raw payload as a uint8 array (the decode buffer that
    numeric column views alias — one allocation, no extra copies)."""
    lib = _require_codec()
    ptr, n = _u8_ptr(block)
    raw_len = lib.codec_raw_len(ptr, n)
    if raw_len < 0:
        raise ValueError("malformed codec frame")
    out = np.empty(raw_len, dtype=np.uint8)
    rc = lib.codec_decode(ptr, n,
                          out.ctypes.data_as(
                              ctypes.POINTER(ctypes.c_uint8)),
                          raw_len)
    if rc == -3:
        raise ValueError("codec frame CRC mismatch (corrupted in transit)")
    if rc != 0:
        raise ValueError(f"malformed codec frame (rc={rc})")
    return out


# column kinds in the meta table
_K_NUMERIC = 0   # raw buffer, np.frombuffer on decode
_K_STRINGS = 1   # all-str object column as utf-8 + u32 offsets
_K_PICKLED = 2   # arbitrary objects (trusted links only)

_COL_FMT = "<HBBBQ"  # name_len, kind, dtype_len, ndim, nbytes


def encode_batch(batch: RecordBatch, compress: bool = True) -> bytes:
    """RecordBatch -> wire bytes (native framed block)."""
    metas = []
    chunks = []
    for name, col in batch.columns.items():
        col = np.asarray(col)
        if col.dtype.kind == "O":
            if all(isinstance(v, str) for v in col):
                enc = [v.encode("utf-8") for v in col]
                offs = np.zeros(len(enc) + 1, dtype=np.uint32)
                np.cumsum([len(b) for b in enc], out=offs[1:])
                blob = offs.tobytes() + b"".join(enc)
                metas.append((name, _K_STRINGS, "", (len(col),),
                              len(blob)))
            else:
                blob = pickle.dumps(col)
                metas.append((name, _K_PICKLED, "", (len(col),),
                              len(blob)))
            chunks.append(blob)
        else:
            buf = np.ascontiguousarray(col)
            blob = buf.tobytes()
            metas.append((name, _K_NUMERIC, buf.dtype.str, buf.shape,
                          len(blob)))
            chunks.append(blob)
    meta_parts = [struct.pack("<I", len(metas))]
    for name, kind, dt, shape, nbytes in metas:
        nb = name.encode("utf-8")
        db = dt.encode("ascii")
        meta_parts.append(struct.pack(_COL_FMT, len(nb), kind, len(db),
                                      len(shape), nbytes))
        meta_parts.append(nb)
        meta_parts.append(db)
        meta_parts.append(struct.pack(f"<{len(shape)}Q", *shape))
    meta = b"".join(meta_parts)
    return _encode_block(
        struct.pack("<I", len(meta)) + meta + b"".join(chunks), compress)


def decode_batch(data) -> RecordBatch:
    """Wire bytes -> RecordBatch (numeric columns zero-copy views into
    the single decode buffer)."""
    decoded = _decode_block(data)
    (meta_len,) = struct.unpack_from("<I", decoded, 0)
    meta = decoded[4:4 + meta_len]
    payload = decoded[4 + meta_len:]
    (ncols,) = struct.unpack_from("<I", meta, 0)
    pos = 4
    cols = {}
    off = 0
    for _ in range(ncols):
        name_len, kind, dt_len, ndim, nbytes = struct.unpack_from(
            _COL_FMT, meta, pos)
        pos += struct.calcsize(_COL_FMT)
        name = bytes(meta[pos:pos + name_len]).decode("utf-8")
        pos += name_len
        dt = bytes(meta[pos:pos + dt_len]).decode("ascii")
        pos += dt_len
        shape = struct.unpack_from(f"<{ndim}Q", meta, pos)
        pos += 8 * ndim
        blob = payload[off:off + nbytes]
        off += nbytes
        if kind == _K_NUMERIC:
            cols[name] = np.frombuffer(
                blob, dtype=np.dtype(dt)).reshape(shape)
        elif kind == _K_STRINGS:
            n = shape[0]
            offs = np.frombuffer(blob[:4 * (n + 1)], dtype=np.uint32)
            body = blob[4 * (n + 1):].tobytes()
            cols[name] = np.array(
                [body[offs[i]:offs[i + 1]].decode("utf-8")
                 for i in range(n)], dtype=object)
        else:
            cols[name] = pickle.loads(blob.tobytes())
    return RecordBatch(cols)
