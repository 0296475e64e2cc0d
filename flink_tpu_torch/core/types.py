"""Type information — column types (port of ``flink_tpu/core/types.py``).

A type is (logical kind, numpy dtype); a row type is an ordered mapping of
field name -> column type; each creates its column serializer
(``core/serializers.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.records import RecordBatch, Schema


@dataclasses.dataclass(frozen=True)
class TypeInformation:
    """A column type: logical kind + physical dtype."""

    kind: str  # 'numeric' | 'string' | 'object'
    dtype: Optional[str] = None  # numpy dtype str for 'numeric'

    def create_serializer(self):
        from flink_tpu_torch.core import serializers as ser

        if self.kind == "numeric":
            return ser.NumericArraySerializer(np.dtype(self.dtype))
        if self.kind == "string":
            return ser.StringArraySerializer()
        return ser.PickleArraySerializer()

    @staticmethod
    def of(value: Any) -> "TypeInformation":
        """Extract from a dtype, numpy array, python scalar, or python type."""
        if isinstance(value, TypeInformation):
            return value
        if isinstance(value, np.ndarray):
            return TypeInformation._of_dtype(value.dtype)
        if isinstance(value, (np.dtype, type)) or isinstance(value, str):
            try:
                return TypeInformation._of_dtype(np.dtype(value))
            except TypeError:
                pass
        if isinstance(value, (bool, int, float, np.generic)):
            return TypeInformation._of_dtype(np.asarray(value).dtype)
        if isinstance(value, (str, bytes)):
            return STRING_TYPE_INFO
        return OBJECT_TYPE_INFO

    @staticmethod
    def _of_dtype(dt: np.dtype) -> "TypeInformation":
        if dt == object:
            return OBJECT_TYPE_INFO
        if dt.kind in "US":
            return STRING_TYPE_INFO
        return TypeInformation("numeric", dt.str)


STRING_TYPE_INFO = TypeInformation("string")
OBJECT_TYPE_INFO = TypeInformation("object")
LONG_TYPE_INFO = TypeInformation("numeric", np.dtype(np.int64).str)
INT_TYPE_INFO = TypeInformation("numeric", np.dtype(np.int32).str)
DOUBLE_TYPE_INFO = TypeInformation("numeric", np.dtype(np.float64).str)
FLOAT_TYPE_INFO = TypeInformation("numeric", np.dtype(np.float32).str)
BOOL_TYPE_INFO = TypeInformation("numeric", np.dtype(np.bool_).str)


@dataclasses.dataclass(frozen=True)
class RowTypeInfo:
    """Ordered field name -> column type."""

    names: Sequence[str]
    types: Sequence[TypeInformation]

    def __post_init__(self):
        object.__setattr__(self, "names", tuple(self.names))
        object.__setattr__(self, "types", tuple(self.types))
        if len(self.names) != len(self.types):
            raise ValueError("names/types length mismatch")

    @staticmethod
    def of(**name_to_type) -> "RowTypeInfo":
        return RowTypeInfo(list(name_to_type),
                           [TypeInformation.of(t)
                            for t in name_to_type.values()])

    @staticmethod
    def from_batch(batch: RecordBatch) -> "RowTypeInfo":
        return RowTypeInfo(list(batch.columns),
                           [TypeInformation.of(c)
                            for c in batch.columns.values()])

    @staticmethod
    def from_schema(schema: Schema) -> "RowTypeInfo":
        return RowTypeInfo([f.name for f in schema.fields],
                           [TypeInformation._of_dtype(f.dtype)
                            for f in schema.fields])

    def field_type(self, name: str) -> TypeInformation:
        return self.types[self.names.index(name)]

    def create_serializer(self):
        from flink_tpu_torch.core.serializers import RowBatchSerializer

        return RowBatchSerializer(self)

    def to_config(self) -> Dict[str, Any]:
        return {"names": list(self.names),
                "types": [dataclasses.asdict(t) for t in self.types]}

    @staticmethod
    def from_config(cfg: Mapping[str, Any]) -> "RowTypeInfo":
        return RowTypeInfo(cfg["names"],
                           [TypeInformation(**t) for t in cfg["types"]])
