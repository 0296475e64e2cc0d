"""Serializers with versioned snapshots and compatibility resolution
(port of ``flink_tpu/core/serializers.py``).

A serializer snapshots its configuration (``SerializerSnapshot``, JSON,
keyed by the serializer's class name); on a read the OLD snapshot is
asked whether the NEW serializer is compatible as is, after migration,
or not at all. Serializers act on whole columns (NumPy arrays). The byte
format is the reference's, so files written by either package read in
the other.

Wire format of one serialized batch (RowBatchSerializer):

    magic  'FTB1'
    u32    ncols
    per column:
        u16 name_len | name utf-8
        u8  kind     (0=numeric, 1=string, 2=pickle)
        u64 payload_len | payload

numeric payload:  u8 dtype_len | dtype str | raw little-endian array bytes
string payload:   u32 n | u32[n+1] byte offsets | utf-8 bytes
pickle payload:   pickle bytes (host-only columns)
"""

from __future__ import annotations

import dataclasses
import enum
import pickle
import struct
from typing import Any, Dict, Mapping

import numpy as np

from flink_tpu_torch.core.records import RecordBatch

MAGIC = b"FTB1"


class Compatibility(enum.Enum):
    """reference: TypeSerializerSchemaCompatibility."""

    COMPATIBLE_AS_IS = "as_is"
    COMPATIBLE_AFTER_MIGRATION = "after_migration"
    INCOMPATIBLE = "incompatible"


@dataclasses.dataclass(frozen=True)
class SerializerSnapshot:
    """Persisted serializer configuration (reference:
    TypeSerializerSnapshot — written into checkpoint metadata so restores
    can reason about format changes without the old code)."""

    serializer: str  # registry key
    version: int
    config: Mapping[str, Any]

    def restore_serializer(self) -> "TypeSerializer":
        cls = _REGISTRY[self.serializer]
        return cls.from_config(self.config)

    def resolve_compatibility(self, new: "TypeSerializer") -> Compatibility:
        if self.serializer != new.registry_key():
            return Compatibility.INCOMPATIBLE
        return new.compatibility_from(self)

    def to_json(self) -> Dict[str, Any]:
        return {"serializer": self.serializer, "version": self.version,
                "config": dict(self.config)}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "SerializerSnapshot":
        return SerializerSnapshot(d["serializer"], d["version"], d["config"])


class TypeSerializer:
    """Column serializer. Subclasses set VERSION and implement the codec."""

    VERSION = 1

    # -- codec ---------------------------------------------------------------

    def serialize(self, values: np.ndarray) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes) -> np.ndarray:
        raise NotImplementedError

    # -- snapshot / compatibility -------------------------------------------

    @classmethod
    def registry_key(cls) -> str:
        return cls.__name__

    def config(self) -> Dict[str, Any]:
        return {}

    @classmethod
    def from_config(cls, config: Mapping[str, Any]) -> "TypeSerializer":
        return cls(**config)

    def snapshot(self) -> SerializerSnapshot:
        return SerializerSnapshot(self.registry_key(), self.VERSION,
                                  self.config())

    def compatibility_from(self, old: SerializerSnapshot) -> Compatibility:
        """Can THIS serializer read state written under ``old``?"""
        if old.config == self.config() and old.version == self.VERSION:
            return Compatibility.COMPATIBLE_AS_IS
        return Compatibility.INCOMPATIBLE

    def migrate(self, data: bytes, old: SerializerSnapshot) -> np.ndarray:
        """Read bytes written by the OLD serializer into the NEW format's
        values (reference: restore-with-migration path in
        StateSerializerProvider)."""
        return old.restore_serializer().deserialize(data)


class NumericArraySerializer(TypeSerializer):
    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def serialize(self, values: np.ndarray) -> bytes:
        arr = np.ascontiguousarray(values, dtype=self.dtype)
        ds = self.dtype.str.encode()
        return struct.pack("<B", len(ds)) + ds + arr.tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        (n,) = struct.unpack_from("<B", data, 0)
        dt = np.dtype(data[1:1 + n].decode())
        return np.frombuffer(data, dtype=dt, offset=1 + n).copy()

    def config(self):
        return {"dtype": self.dtype.str}

    def compatibility_from(self, old: SerializerSnapshot) -> Compatibility:
        old_dt = np.dtype(old.config["dtype"])
        if old_dt == self.dtype:
            return Compatibility.COMPATIBLE_AS_IS
        # widening (int32->int64, float32->float64, int->float) is a safe
        # cast: readable after migration; narrowing is data loss -> refuse
        if np.can_cast(old_dt, self.dtype, casting="safe"):
            return Compatibility.COMPATIBLE_AFTER_MIGRATION
        return Compatibility.INCOMPATIBLE

    def migrate(self, data: bytes, old: SerializerSnapshot) -> np.ndarray:
        return old.restore_serializer().deserialize(data).astype(self.dtype)


class StringArraySerializer(TypeSerializer):
    def serialize(self, values: np.ndarray) -> bytes:
        encoded = [str(v).encode() for v in values.tolist()]
        offsets = np.zeros(len(encoded) + 1, dtype=np.uint32)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        return (struct.pack("<I", len(encoded)) + offsets.tobytes()
                + b"".join(encoded))

    def deserialize(self, data: bytes) -> np.ndarray:
        (n,) = struct.unpack_from("<I", data, 0)
        offsets = np.frombuffer(data, dtype=np.uint32, count=n + 1, offset=4)
        base = 4 + offsets.nbytes
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = data[base + offsets[i]:base + offsets[i + 1]].decode()
        return out

    def compatibility_from(self, old):
        return Compatibility.COMPATIBLE_AS_IS


class PickleArraySerializer(TypeSerializer):
    """Fallback for arbitrary host objects (the reference's KryoSerializer
    role). Never used on the device path."""

    def serialize(self, values: np.ndarray) -> bytes:
        return pickle.dumps(list(values.tolist()
                                 if isinstance(values, np.ndarray)
                                 else values))

    def deserialize(self, data: bytes) -> np.ndarray:
        out = np.empty(len(obj := pickle.loads(data)), dtype=object)
        out[:] = obj
        return out

    def compatibility_from(self, old):
        return Compatibility.COMPATIBLE_AS_IS


_KIND_CODE = {"numeric": 0, "string": 1, "object": 2}
_CODE_SER = {0: NumericArraySerializer, 1: StringArraySerializer,
             2: PickleArraySerializer}


class RowBatchSerializer(TypeSerializer):
    """Whole-RecordBatch codec over the columnar wire format above.

    Compatibility rules (reference: row/POJO serializer evolution —
    PojoSerializerSnapshot: new fields get defaults, removed fields are
    dropped, both = COMPATIBLE_AFTER_MIGRATION; per-field type changes
    resolve recursively):
    """

    def __init__(self, row_type):
        from flink_tpu_torch.core.types import RowTypeInfo

        self.row_type: RowTypeInfo = row_type
        self._sers = {n: t.create_serializer()
                      for n, t in zip(row_type.names, row_type.types)}

    # -- codec ---------------------------------------------------------------

    def serialize(self, batch: RecordBatch) -> bytes:
        parts = [MAGIC, struct.pack("<I", len(self._sers))]
        for name, ser in self._sers.items():
            payload = ser.serialize(batch[name])
            nb = name.encode()
            kind = _KIND_CODE[self.row_type.field_type(name).kind]
            parts.append(struct.pack("<H", len(nb)) + nb
                         + struct.pack("<B", kind)
                         + struct.pack("<Q", len(payload)))
            parts.append(payload)
        return b"".join(parts)

    def deserialize(self, data: bytes) -> RecordBatch:
        if data[:4] != MAGIC:
            raise ValueError("bad magic — not a serialized batch")
        (ncols,) = struct.unpack_from("<I", data, 4)
        pos = 8
        cols: Dict[str, np.ndarray] = {}
        for _ in range(ncols):
            (nlen,) = struct.unpack_from("<H", data, pos)
            pos += 2
            name = data[pos:pos + nlen].decode()
            pos += nlen
            kind = data[pos]
            pos += 1
            (plen,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            payload = data[pos:pos + plen]
            pos += plen
            ser = self._sers.get(name)
            if ser is None or _KIND_CODE[
                    self.row_type.field_type(name).kind] != kind:
                ser = _CODE_SER[kind]() if kind != 0 else None
                if ser is None:
                    ser = NumericArraySerializer(np.int64)  # dtype in payload
            cols[name] = ser.deserialize(payload)
        return RecordBatch(cols)

    # -- snapshot / compatibility -------------------------------------------

    def config(self):
        return self.row_type.to_config()

    @classmethod
    def from_config(cls, config):
        from flink_tpu_torch.core.types import RowTypeInfo

        return cls(RowTypeInfo.from_config(config))

    def compatibility_from(self, old: SerializerSnapshot) -> Compatibility:
        from flink_tpu_torch.core.types import RowTypeInfo

        old_rt = RowTypeInfo.from_config(old.config)
        if (old_rt.names == self.row_type.names
                and old_rt.types == self.row_type.types):
            return Compatibility.COMPATIBLE_AS_IS
        result = Compatibility.COMPATIBLE_AFTER_MIGRATION
        for name, t in zip(self.row_type.names, self.row_type.types):
            if name not in old_rt.names:
                continue  # new field: filled with defaults on migrate
            old_t = old_rt.field_type(name)
            c = t.create_serializer().compatibility_from(
                SerializerSnapshot(
                    t.create_serializer().registry_key(), 1,
                    old_t.create_serializer().config())
            ) if old_t.kind == t.kind else (
                Compatibility.INCOMPATIBLE)
            if c is Compatibility.INCOMPATIBLE:
                return Compatibility.INCOMPATIBLE
        return result

    def migrate(self, data: bytes, old: SerializerSnapshot) -> RecordBatch:
        """Read an old-format batch into the new row type: removed fields
        dropped, new fields default-filled (zeros / empty strings / None),
        changed dtypes safe-cast."""
        old_batch = old.restore_serializer().deserialize(data)
        n = len(old_batch)
        cols: Dict[str, np.ndarray] = {}
        for name, t in zip(self.row_type.names, self.row_type.types):
            if name in old_batch.columns:
                col = old_batch[name]
                if t.kind == "numeric":
                    col = col.astype(np.dtype(t.dtype))
                cols[name] = col
            elif t.kind == "numeric":
                cols[name] = np.zeros(n, dtype=np.dtype(t.dtype))
            else:
                fill = np.empty(n, dtype=object)
                fill[:] = "" if t.kind == "string" else None
                cols[name] = fill
        return RecordBatch(cols)


_REGISTRY: Dict[str, type] = {
    c.__name__: c for c in (
        NumericArraySerializer, StringArraySerializer, PickleArraySerializer,
        RowBatchSerializer)
}


def register_serializer(cls: type) -> type:
    """Extension point for user serializers (reference: custom
    TypeSerializer registration)."""
    _REGISTRY[cls.__name__] = cls
    return cls
