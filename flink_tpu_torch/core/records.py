"""Columnar record batches — the unit of data flow (port of
``flink_tpu/core/records.py``).

A batch is a dict of NumPy columns plus the reserved timestamp and key-id
columns. Batches stay on the host; only the keyed engine's state and its
per-batch staging columns live on the device. Immutable by convention
(every transform returns a new batch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Sequence

import numpy as np

TIMESTAMP_FIELD = "__ts__"  # event-time, int64 epoch millis
KEY_ID_FIELD = "__key_id__"  # int64 key identity (set by key_by)


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: np.dtype

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: Sequence[Field]

    @staticmethod
    def of(**name_to_dtype) -> "Schema":
        return Schema(tuple(Field(n, d) for n, d in name_to_dtype.items()))

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


class RecordBatch:
    """An immutable columnar batch of records.

    columns: name -> np.ndarray, all of equal length. ``__ts__`` holds
    event-time timestamps (int64 ms); ``__key_id__`` holds the int64 key
    identity once the stream is keyed.
    """

    __slots__ = ("columns", "_n")

    def __init__(self, columns: Mapping[str, np.ndarray]):
        cols = {k: np.asarray(v) for k, v in columns.items()}
        n = None
        for k, v in cols.items():
            if v.ndim < 1:
                raise ValueError(f"column {k!r} must be at least 1-D")
            if n is None:
                n = v.shape[0]
            elif v.shape[0] != n:
                raise ValueError(
                    f"column {k!r} length {v.shape[0]} != batch length {n}")
        self.columns: Dict[str, np.ndarray] = cols
        self._n = 0 if n is None else int(n)

    @staticmethod
    def from_pydict(data: Mapping[str, Any], timestamps=None) -> "RecordBatch":
        cols = {k: np.asarray(v) for k, v in data.items()}
        if timestamps is not None:
            cols[TIMESTAMP_FIELD] = np.asarray(timestamps, dtype=np.int64)
        return RecordBatch(cols)

    @staticmethod
    def from_rows(rows: Iterable[Mapping[str, Any]]) -> "RecordBatch":
        rows = list(rows)
        if not rows:
            return RecordBatch({})
        names = rows[0].keys()
        return RecordBatch({n: np.asarray([r[n] for r in rows])
                            for n in names})

    def __len__(self) -> int:
        return self._n

    @property
    def num_records(self) -> int:
        return self._n

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def names(self) -> List[str]:
        return list(self.columns.keys())

    @property
    def timestamps(self) -> np.ndarray:
        return self.columns[TIMESTAMP_FIELD]

    @property
    def has_timestamps(self) -> bool:
        return TIMESTAMP_FIELD in self.columns

    @property
    def key_ids(self) -> np.ndarray:
        return self.columns[KEY_ID_FIELD]

    @property
    def is_keyed(self) -> bool:
        return KEY_ID_FIELD in self.columns

    def with_column(self, name: str, values) -> "RecordBatch":
        cols = dict(self.columns)
        cols[name] = np.asarray(values)
        return RecordBatch(cols)

    def with_timestamps(self, ts) -> "RecordBatch":
        return self.with_column(TIMESTAMP_FIELD,
                                np.asarray(ts, dtype=np.int64))

    def drop(self, *names: str) -> "RecordBatch":
        return RecordBatch({k: v for k, v in self.columns.items()
                            if k not in names})

    def select(self, *names: str) -> "RecordBatch":
        return RecordBatch({k: self.columns[k] for k in names})

    def filter(self, mask: np.ndarray) -> "RecordBatch":
        mask = np.asarray(mask, dtype=bool)
        return RecordBatch({k: v[mask] for k, v in self.columns.items()})

    def take(self, indices: np.ndarray) -> "RecordBatch":
        return RecordBatch({k: v[indices] for k, v in self.columns.items()})

    def slice(self, start: int, stop: int) -> "RecordBatch":
        return RecordBatch({k: v[start:stop]
                            for k, v in self.columns.items()})

    @staticmethod
    def concat(batches: Sequence["RecordBatch"]) -> "RecordBatch":
        batches = [b for b in batches if len(b) > 0]
        if not batches:
            return RecordBatch({})
        if len(batches) == 1:
            return batches[0]
        names = batches[0].names()
        return RecordBatch(
            {n: np.concatenate([b.columns[n] for b in batches])
             for n in names})

    def to_pydict(self) -> Dict[str, list]:
        return {k: v.tolist() for k, v in self.columns.items()}

    def to_rows(self) -> List[Dict[str, Any]]:
        names = self.names()
        cols = [self.columns[n] for n in names]
        return [
            {n: c[i].item() if hasattr(c[i], "item") else c[i]
             for n, c in zip(names, cols)}
            for i in range(self._n)
        ]

    def schema(self) -> Schema:
        return Schema(tuple(Field(k, v.dtype)
                            for k, v in self.columns.items()
                            if v.dtype != object))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        cols = ", ".join(f"{k}:{v.dtype}" for k, v in self.columns.items())
        return f"RecordBatch(n={self._n}, {cols})"
