"""Lookup tables — point lookups against external systems at join time
(port of ``flink_tpu/connectors/lookup.py``).

reference: LookupTableSource / LookupFunction
(flink-table/flink-table-common/src/main/java/org/apache/flink/table/
connector/source/LookupTableSource.java, .../functions/LookupFunction.java)
and the lookup join
(flink-table-runtime/.../operators/join/lookup/LookupJoinRunner.java) —
the dimension-table enrichment pattern: each stream row fetches the
external row for its key at processing time, with an optional cache
(FLIP-221 'lookup.cache').

Re-design: lookups are BATCHED — one ``lookup(keys)`` call per distinct
key set per micro-batch (the expensive boundary crossed once per batch,
like every other connector seam here), fronted by an LRU cache.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.records import TIMESTAMP_FIELD, RecordBatch
from flink_tpu_torch.runtime.operators import Operator


class LookupFunction:
    """The lookup seam: ``lookup(keys) -> {column: array}`` returning one
    row per FOUND key, keyed by the first output column matching the
    lookup key. Misses are simply absent. Implementations wrap real
    clients (JDBC, HBase, REST); tests use ``TableLookupFunction``."""

    #: the key column name in the returned rows
    key_column: str = "key"

    def open(self) -> None:
        pass

    def lookup(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class TableLookupFunction(LookupFunction):
    """In-memory dimension table (tests / static enrichment data)."""

    def __init__(self, rows: Sequence[dict], key_column: str):
        self.key_column = key_column
        self._by_key = {r[key_column]: r for r in rows}
        self._columns = list(rows[0].keys()) if rows else [key_column]

    def lookup(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        hits = [self._by_key[k] for k in keys.tolist()
                if k in self._by_key]
        if not hits:
            return {c: np.empty(0) for c in self._columns}
        return {c: np.asarray([r[c] for r in hits])
                for c in self._columns}


class LookupJoinOperator(Operator):
    """Enrich each row with its key's external row (INNER or LEFT).

    reference: LookupJoinRunner + the FLIP-221 caching layer. Per batch:
    distinct keys split into cache hits and misses, ONE lookup() fetches
    the misses, results join back positionally. A cached miss is cached
    too (negative caching, like the reference's missing-key cache).

    Caching is OPT-IN (``cache_size=0`` by default), matching FLIP-221
    where ``lookup.cache`` defaults to NONE — a dimension row updated
    after first access would otherwise never be observed while its key
    sits in the LRU. When enabled, ``cache_ttl_ms`` bounds staleness
    (the reference's partial-cache ``expireAfterWrite``); ``None``
    means entries never expire (static dimension data only)."""

    name = "lookup_join"

    def __init__(self, fn: LookupFunction, key_field: str,
                 right_columns: Optional[Sequence[str]] = None,
                 suffixes=("_l", "_r"), cache_size: int = 0,
                 cache_ttl_ms: Optional[int] = None,
                 left_outer: bool = False):
        self.fn = fn
        self.key_field = key_field
        #: the DECLARED dimension-table columns — always emitted, so
        #: every output batch shares one schema even when a batch's
        #: lookups all miss
        self.right_columns = list(right_columns) if right_columns \
            else None
        self.suffixes = suffixes
        self.cache_size = int(cache_size)
        self.cache_ttl_ms = cache_ttl_ms
        self.left_outer = left_outer
        #: key value -> (row dict or None, write-time ms) — None row is
        #: the negative cache
        self._cache: OrderedDict = OrderedDict()
        self.lookups = 0
        self.cache_hits = 0
        #: distinct keys fetched through ``lookup`` (the port's counter)
        self.cache_misses = 0

    def open(self, ctx) -> None:
        self.fn.open()

    def counters(self) -> Dict[str, int]:
        return {"lookups": self.lookups, "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses}

    def _fetch(self, key_vals: np.ndarray) -> Dict[object, Optional[dict]]:
        now_ms = time.monotonic() * 1e3
        out: Dict[object, Optional[dict]] = {}
        misses: List[object] = []
        for k in dict.fromkeys(key_vals.tolist()):
            entry = self._cache.get(k) if self.cache_size else None
            if entry is not None and (
                    self.cache_ttl_ms is None
                    or now_ms - entry[1] < self.cache_ttl_ms):
                self._cache.move_to_end(k)
                out[k] = entry[0]
                self.cache_hits += 1
            else:
                if entry is not None:  # expired — refetch
                    del self._cache[k]
                misses.append(k)
        if misses:
            self.lookups += 1
            self.cache_misses += len(misses)
            cols = self.fn.lookup(np.asarray(misses))
            kc = self.fn.key_column
            found = {}
            if cols and len(next(iter(cols.values()))):
                n = len(next(iter(cols.values())))
                for i in range(n):
                    row = {c: cols[c][i] for c in cols}
                    found[row[kc]] = row
            for k in misses:
                row = found.get(k)
                out[k] = row
                if self.cache_size:
                    self._cache[k] = (row, now_ms)
                    while len(self._cache) > self.cache_size:
                        self._cache.popitem(last=False)
        return out

    def process_batch(self, batch: RecordBatch,
                      input_index: int = 0) -> List[RecordBatch]:
        n = len(batch)
        if n == 0:
            return []
        if self.key_field not in batch.columns:
            raise RuntimeError(
                f"lookup join key {self.key_field!r} missing from batch "
                f"columns {batch.names()}")
        key_vals = np.asarray(batch[self.key_field])
        rows = self._fetch(key_vals)
        hit = np.asarray([rows[k] is not None
                          for k in key_vals.tolist()], dtype=bool)
        if not self.left_outer:
            batch = batch.filter(hit)
            key_vals = key_vals[hit]
            if len(batch) == 0:
                return []
        kc = self.fn.key_column
        names = self.right_columns
        if names is None:
            # undeclared schema: derive from observed rows (programmatic
            # use); declared columns are preferred for a stable schema
            seen = {c for k in key_vals.tolist()
                    for c in (rows[k] or {})}
            names = sorted(seen) or [kc]
        # columnar assembly: per-UNIQUE-key right values, gathered back
        # to row positions with one inverse-index fancy index per column
        # (K distinct keys per batch, not N rows, touch Python)
        uniq, inv = np.unique(key_vals, return_inverse=True)
        vals: Dict[str, np.ndarray] = {}
        for c in names:
            per_key = [(rows[k] or {}).get(c, np.nan)
                       for k in uniq.tolist()]
            vals[c] = np.asarray(per_key)[inv]
        out = {}
        lcols = batch.columns
        for c, v in lcols.items():
            if c in names and c not in (TIMESTAMP_FIELD,):
                out[c + self.suffixes[0]] = v
            else:
                out[c] = v
        for c in names:
            name = c + self.suffixes[1] if c in lcols else c
            out[name] = vals[c]
        return [RecordBatch(out)]

    def close(self) -> List[RecordBatch]:
        self.fn.close()
        return []
