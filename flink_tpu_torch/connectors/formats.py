"""(De)serialization formats — the seam that makes a connector real (port of
``flink_tpu/connectors/formats.py``).

reference: DeserializationSchema / SerializationSchema
(flink-core/src/main/java/org/apache/flink/api/common/serialization/
DeserializationSchema.java) and the JSON format
(flink-formats/flink-json/src/main/java/org/apache/flink/formats/json/
JsonRowDataDeserializationSchema.java:1), discovered from DDL via
``'format' = 'json'`` (DeserializationFormatFactory SPI).

Re-design: schemas are BATCH-granular — ``deserialize_batch`` turns a
sequence of raw byte records into one columnar RecordBatch (typed by the
DDL column list), ``serialize_batch`` the reverse — so the per-record
work happens once per micro-batch at the connector boundary and
everything inside the framework stays columnar.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.core.records import ROWKIND_FIELD, RecordBatch

_FORMATS: Dict[str, Callable] = {}


def register_format(name: str, factory: Callable) -> None:
    """``factory(columns, types, options) -> (DeserializationSchema,
    SerializationSchema)`` — the DeserializationFormatFactory /
    SerializationFormatFactory SPI pair."""
    _FORMATS[name.lower()] = factory


def resolve_format(name: str, columns: Sequence[str],
                   types: Sequence[Optional[str]],
                   options: Optional[dict] = None
                   ) -> Tuple["DeserializationSchema",
                              "SerializationSchema"]:
    if name.lower() == "avro" and "avro" not in _FORMATS:
        # self-registers on import; 'format' = 'avro' in DDL must not
        # require a user-level import (same pattern as shuffle.service)
        import flink_tpu_torch.connectors.avro  # noqa: F401
    factory = _FORMATS.get(name.lower())
    if factory is None:
        raise ValueError(
            f"unknown format {name!r} (registered: {sorted(_FORMATS)}); "
            "add one with "
            "flink_tpu_torch.connectors.formats.register_format")
    return factory(list(columns), list(types), options or {})


class DeserializationSchema:
    """raw byte records -> one typed columnar batch.

    After ``deserialize_batch``, ``last_surviving`` holds the RAW
    indices of the records that made it into the batch (None = all of
    them) — what lets per-record metadata attached to the raw stream
    (broker timestamps) stay aligned when ignore-parse-errors skips
    records."""

    last_surviving: Optional[List[int]] = None

    #: True when records are arbitrary binary (may contain newlines) —
    #: file sources must undo u32-length-prefix framing instead of
    #: newline-splitting (the read-side mirror of
    #: SerializationSchema.binary; the two MUST agree per format)
    binary = False

    def open(self) -> None:
        pass

    def deserialize_batch(self, raw: Sequence[bytes]) -> RecordBatch:
        raise NotImplementedError


class SerializationSchema:
    """one columnar batch -> raw byte records."""

    #: True when records are arbitrary binary (may contain newlines) —
    #: file sinks must length-prefix instead of newline-framing them
    binary = False

    def open(self) -> None:
        pass

    def serialize_batch(self, batch: RecordBatch) -> List[bytes]:
        raise NotImplementedError


def _coerce(v, dt):
    """One field to its declared dtype; raises ValueError/TypeError on a
    lossy/unparseable value (callers decide skip-vs-fail per record)."""
    if dt is np.int64:
        return 0 if v is None else int(v)
    if dt is np.float64:
        return np.nan if v is None else float(v)
    if dt is np.bool_:
        return (v.lower() in ("true", "1")
                if isinstance(v, str) else bool(v))
    if dt is object:
        return "" if v is None else str(v)
    return v


def _columns_from_rows(rows: List[tuple], columns: Sequence[str],
                       dts) -> Dict[str, np.ndarray]:
    cols: Dict[str, np.ndarray] = {}
    for j, (name, dt) in enumerate(zip(columns, dts)):
        vals = [r[j] for r in rows]
        if dt is object:
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
            cols[name] = arr
        elif dt is None:
            # untyped: numeric values infer their dtype; text stays an
            # OBJECT array (a '<U' array would change equality and
            # fill semantics batch-to-batch)
            arr = np.asarray(vals)
            if arr.dtype.kind in ("U", "S"):
                obj = np.empty(len(vals), dtype=object)
                obj[:] = vals
                arr = obj
            cols[name] = arr
        else:
            cols[name] = np.asarray(vals, dtype=dt)
    return cols


def _np_dtype(sql_type: Optional[str]):
    t = (sql_type or "").upper().split("(")[0].strip()
    if t in ("BIGINT", "INT", "INTEGER", "SMALLINT", "TINYINT"):
        return np.int64
    if t in ("DOUBLE", "FLOAT", "DECIMAL", "NUMERIC", "REAL"):
        return np.float64
    if t in ("BOOLEAN",):
        return np.bool_
    if t in ("STRING", "VARCHAR", "CHAR"):
        return object
    return None  # untyped: infer from the values


class JsonRowDeserializationSchema(DeserializationSchema):
    """One JSON object per record, projected onto the DDL columns with
    dtype coercion (reference: JsonRowDataDeserializationSchema;
    ``json.ignore-parse-errors`` maps the reference option)."""

    def __init__(self, columns: Sequence[str],
                 types: Optional[Sequence[Optional[str]]] = None,
                 ignore_parse_errors: bool = False):
        self.columns = list(columns)
        self.types = list(types) if types is not None \
            else [None] * len(self.columns)
        self.ignore_parse_errors = ignore_parse_errors

    def deserialize_batch(self, raw: Sequence[bytes]) -> RecordBatch:
        dts = [_np_dtype(t) for t in self.types]
        rows: List[tuple] = []
        surviving: List[int] = []
        for i, rec in enumerate(raw):
            if isinstance(rec, (bytes, bytearray)):
                rec = rec.decode("utf-8", errors="replace")
            # parse AND type-coerce inside the guarded path: the
            # reference's ignore-parse-errors covers conversion failures
            # too, so one bad-typed field skips ONE record, never the
            # batch
            try:
                obj = json.loads(rec)
                if not isinstance(obj, dict):
                    raise ValueError("JSON record is not an object")
                rows.append(tuple(
                    _coerce(obj.get(name), dt)
                    for name, dt in zip(self.columns, dts)))
                surviving.append(i)
            except (ValueError, TypeError) as e:
                if self.ignore_parse_errors:
                    continue
                raise RuntimeError(
                    f"failed to deserialize JSON record {rec!r}: {e} "
                    "(set 'json.ignore-parse-errors'='true' to skip "
                    "corrupt records)") from e
        self.last_surviving = (None if len(surviving) == len(raw)
                               else surviving)
        return RecordBatch.from_pydict(
            _columns_from_rows(rows, self.columns, dts))


class JsonRowSerializationSchema(SerializationSchema):
    """One JSON object per row over the declared columns (reference:
    JsonRowDataSerializationSchema). A changelog row keeps its kind
    under ``"op"`` (+I/+U/-U/-D — the reference's debezium-ish op
    field), so upsert topics stay interpretable."""

    _OPS = {0: "+I", 1: "-U", 2: "+U", 3: "-D"}

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)

    def serialize_batch(self, batch: RecordBatch) -> List[bytes]:
        out: List[bytes] = []
        names = [c for c in self.columns if c in batch.columns]
        cols = {c: batch[c] for c in names}
        kinds = (np.asarray(batch[ROWKIND_FIELD])
                 if ROWKIND_FIELD in batch.columns else None)
        for i in range(len(batch)):
            obj = {}
            for c in names:
                v = cols[c][i]
                if isinstance(v, (np.integer,)):
                    v = int(v)
                elif isinstance(v, (np.floating,)):
                    v = float(v)
                elif isinstance(v, (np.bool_,)):
                    v = bool(v)
                else:
                    v = v if isinstance(v, (int, float, bool, str,
                                            type(None))) else str(v)
                obj[c] = v
            if kinds is not None:
                obj["op"] = self._OPS.get(int(kinds[i]), "+I")
            out.append(json.dumps(obj).encode("utf-8"))
        return out


def _json_factory(columns, types, options):
    return (JsonRowDeserializationSchema(
                columns, types,
                ignore_parse_errors=str(options.get(
                    "json.ignore-parse-errors", "false")).lower()
                in ("true", "1", "yes")),
            JsonRowSerializationSchema(columns))


register_format("json", _json_factory)


class CsvRowDeserializationSchema(DeserializationSchema):
    """Positional CSV (reference: flink-formats/flink-csv)."""

    def __init__(self, columns, types=None, delimiter: str = ",",
                 ignore_parse_errors: bool = False):
        self.columns = list(columns)
        self.types = list(types) if types is not None \
            else [None] * len(self.columns)
        self.delimiter = delimiter
        self.ignore_parse_errors = ignore_parse_errors

    def deserialize_batch(self, raw: Sequence[bytes]) -> RecordBatch:
        import csv as _csv

        dts = [_np_dtype(t) for t in self.types]
        rows: List[tuple] = []
        surviving: List[int] = []
        for i, rec in enumerate(raw):
            if isinstance(rec, (bytes, bytearray)):
                rec = rec.decode("utf-8", errors="replace")
            # RFC-4180 parsing (quoted fields may hold the delimiter,
            # quotes, newlines) — symmetric with the serializer; type
            # coercion happens here too so a bad field skips ONE record.
            # Untyped columns keep their raw field text verbatim.
            try:
                parts = next(_csv.reader([rec.rstrip("\r\n")],
                                         delimiter=self.delimiter), [])
                if len(parts) != len(self.columns):
                    raise ValueError(
                        f"CSV record has {len(parts)} fields, expected "
                        f"{len(self.columns)}")
                rows.append(tuple(
                    p if dt is None
                    else _coerce(int(float(p)) if dt is np.int64 and p
                                 else (p or None), dt)
                    for p, dt in zip(parts, dts)))
                surviving.append(i)
            except (ValueError, TypeError) as e:
                if self.ignore_parse_errors:
                    continue
                raise RuntimeError(
                    f"failed to deserialize CSV record {rec!r}: {e} "
                    "(set 'csv.ignore-parse-errors'='true' to skip "
                    "corrupt records)") from e
        self.last_surviving = (None if len(surviving) == len(raw)
                               else surviving)
        return RecordBatch.from_pydict(
            _columns_from_rows(rows, self.columns, dts))


class CsvRowSerializationSchema(SerializationSchema):
    def __init__(self, columns, delimiter: str = ","):
        self.columns = list(columns)
        self.delimiter = delimiter

    def serialize_batch(self, batch: RecordBatch) -> List[bytes]:
        import csv as _csv
        import io as _io

        names = [c for c in self.columns if c in batch.columns]
        cols = {c: batch[c] for c in names}
        out: List[bytes] = []
        buf = _io.StringIO()
        writer = _csv.writer(buf, delimiter=self.delimiter,
                             lineterminator="")
        for i in range(len(batch)):
            buf.seek(0)
            buf.truncate()
            writer.writerow([str(cols[c][i]) for c in names])
            out.append(buf.getvalue().encode("utf-8"))
        return out


def _csv_factory(columns, types, options):
    delim = options.get("csv.field-delimiter", ",")
    ignore = str(options.get("csv.ignore-parse-errors",
                             "false")).lower() in ("true", "1", "yes")
    return (CsvRowDeserializationSchema(columns, types, delimiter=delim,
                                        ignore_parse_errors=ignore),
            CsvRowSerializationSchema(columns, delimiter=delim))


register_format("csv", _csv_factory)
