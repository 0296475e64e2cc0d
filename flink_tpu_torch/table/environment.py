"""StreamTableEnvironment — SQL entry point + result materialization (port of
``flink_tpu/table/environment.py``).

reference: flink-table/flink-table-api-java/.../internal/TableEnvironmentImpl.java
(:936 executeSql), StreamTableEnvironmentImpl (fromDataStream/toDataStream).
Catalog here is a flat in-memory name -> Table map (the reference's
GenericInMemoryCatalog equivalent).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    ROWKIND_DELETE,
    ROWKIND_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.datastream.environment import StreamExecutionEnvironment
from flink_tpu_torch.datastream.stream import DataStream
from flink_tpu_torch.table import sql_parser
from flink_tpu_torch.table.optimizer import optimize
from flink_tpu_torch.table.planner import PlannedTable, PlanError, Planner

_INTERNAL_COLS = (TIMESTAMP_FIELD, KEY_ID_FIELD, ROWKIND_FIELD)


from flink_tpu_torch.core.annotations import public_evolving

@public_evolving
class Table:
    """A (possibly unbounded) relational view over a DataStream."""

    def __init__(self, t_env: "StreamTableEnvironment", stream: DataStream,
                 columns: Sequence[str], time_field: Optional[str] = None,
                 upsert_keys: Optional[List[str]] = None,
                 sort_spec=None, limit: Optional[int] = None):
        self.t_env = t_env
        self.stream = stream
        self.columns = list(columns)
        self.time_field = time_field
        self.upsert_keys = upsert_keys
        self.sort_spec = sort_spec
        self.limit = limit

    @staticmethod
    def _from_planned(t_env: "StreamTableEnvironment",
                      planned: PlannedTable) -> "Table":
        return Table(t_env, planned.stream, planned.columns,
                     planned.time_field, planned.upsert_keys,
                     planned.sort_spec, planned.limit)

    def execute(self) -> "TableResult":
        return TableResult(self)

    def to_data_stream(self) -> DataStream:
        return self.stream

    # -- fluent relational API (reference: Table API DSL; every method
    # -- builds the SQL AST and plans through the one Planner+optimizer —
    # -- see flink_tpu_torch/table/fluent.py) --------------------------------------

    _alias: Optional[str] = None

    def alias(self, name: str) -> "Table":
        """Name this table for qualified references in joins
        (reference: Table.as)."""
        out = Table(self.t_env, self.stream, self.columns, self.time_field,
                    self.upsert_keys, self.sort_spec, self.limit)
        out._alias = name
        return out

    def _ref(self):
        from flink_tpu_torch.table.fluent import _InlineTable

        return _InlineTable(self, self._alias)

    def _plan(self, stmt) -> "Table":
        from flink_tpu_torch.table.fluent import _plan

        return Table._from_planned(self.t_env, _plan(self.t_env, stmt))

    def select(self, *exprs) -> "Table":
        from flink_tpu_torch.table import sql_parser as ast
        from flink_tpu_torch.table.fluent import _items

        return self._plan(ast.SelectStmt(items=_items(exprs),
                                         table=self._ref()))

    def where(self, predicate) -> "Table":
        from flink_tpu_torch.table import sql_parser as ast
        from flink_tpu_torch.table.expressions import SelectItem, Star
        from flink_tpu_torch.table.fluent import _expr

        return self._plan(ast.SelectStmt(
            items=[SelectItem(Star(), None)], table=self._ref(),
            where=_expr(predicate)))

    #: reference spelling
    filter = where

    def group_by(self, *keys):
        from flink_tpu_torch.table.fluent import GroupedTable, GroupWindow

        window = None
        plain = []
        for k in keys:
            if isinstance(k, GroupWindow):
                window = k
            else:
                plain.append(k)
        return GroupedTable(self, plain, window)

    def window(self, group_window):
        """Attach a group window; follow with .group_by(..).select(..)
        (reference: Table.window(Tumble...).groupBy(...).select(...))."""
        from flink_tpu_torch.table.fluent import _WindowedTable

        return _WindowedTable(self, group_window)

    def join(self, other: "Table", on) -> "Table":
        return self._join(other, on, "INNER")

    def left_outer_join(self, other: "Table", on) -> "Table":
        return self._join(other, on, "LEFT")

    def _join(self, other: "Table", on, kind: str) -> "Table":
        from flink_tpu_torch.table import sql_parser as ast
        from flink_tpu_torch.table.expressions import SelectItem, Star
        from flink_tpu_torch.table.fluent import _expr

        join = ast.Join(self._ref(), other._ref(), kind, _expr(on))
        return self._plan(ast.SelectStmt(
            items=[SelectItem(Star(), None)], table=join))

    def order_by(self, *exprs) -> "Table":
        """ORDER BY — a materialization-time sort spec on this table
        (exactly what the planner records for SQL ORDER BY), so chaining
        .order_by(...).fetch(n) composes instead of re-planning."""
        from flink_tpu_torch.table.fluent import _order_items

        out = Table(self.t_env, self.stream, self.columns, self.time_field,
                    self.upsert_keys,
                    sort_spec=[(o.expr, o.descending)
                               for o in _order_items(exprs)],
                    limit=self.limit)
        out._alias = self._alias
        return out

    def fetch(self, n: int) -> "Table":
        """LIMIT n (reference: Table.fetch)."""
        out = Table(self.t_env, self.stream, self.columns, self.time_field,
                    self.upsert_keys, sort_spec=self.sort_spec, limit=n)
        out._alias = self._alias
        return out

    def distinct(self) -> "Table":
        from flink_tpu_torch.table import sql_parser as ast
        from flink_tpu_torch.table.expressions import SelectItem, Star

        return self._plan(ast.SelectStmt(
            items=[SelectItem(Star(), None)], table=self._ref(),
            distinct=True))

    def union_all(self, *others: "Table") -> "Table":
        from flink_tpu_torch.table import sql_parser as ast
        from flink_tpu_torch.table.expressions import SelectItem, Star

        selects = [ast.SelectStmt(items=[SelectItem(Star(), None)],
                                  table=t._ref())
                   for t in (self, *others)]
        return self._plan(ast.UnionAll(selects))


@public_evolving
class TableResult:
    """Bounded materialization of a Table (collect-style; the reference's
    TableResult.collect)."""

    def __init__(self, table: Table):
        self.table = table
        self._batch: Optional[RecordBatch] = None

    def to_batch(self) -> RecordBatch:
        if self._batch is None:
            batch = self.table.stream.execute_and_collect()
            self._batch = self._materialize(batch)
        return self._batch

    def collect(self) -> List[dict]:
        batch = self.to_batch()
        rows = batch.to_rows()
        for r in rows:
            for c in _INTERNAL_COLS:
                r.pop(c, None)
        return rows

    def _materialize(self, batch: RecordBatch) -> RecordBatch:
        t = self.table
        if len(batch) and t.upsert_keys is not None:
            # changelog upsert stream: last value per key wins, and a key
            # whose final row is a DELETE has left the table (reference:
            # RowKind.DELETE applied by upsert sinks). An empty key list is
            # a global aggregate — one constant key.
            if not t.upsert_keys:
                batch = batch.slice(len(batch) - 1, len(batch))
            else:
                keys = list(zip(*[batch[k].tolist()
                                  for k in t.upsert_keys])) \
                    if len(t.upsert_keys) > 1 \
                    else batch[t.upsert_keys[0]].tolist()
                last: Dict[object, int] = {}
                for i, k in enumerate(keys):
                    last[k] = i
                idx = np.asarray(sorted(last.values()), dtype=np.int64)
                batch = batch.take(idx)
            if ROWKIND_FIELD in batch.columns and len(batch):
                batch = batch.filter(
                    batch[ROWKIND_FIELD] != ROWKIND_DELETE)
        if len(batch) and t.sort_spec is not None:
            sort_cols = []
            for expr, desc in reversed(t.sort_spec):
                v = np.asarray(expr.eval(batch))
                if v.dtype == object:
                    v = np.array([str(x) for x in v])
                sort_cols.append(-v if desc and v.dtype.kind in "iuf" else v)
            if sort_cols:
                batch = batch.take(np.lexsort(sort_cols))
        if t.limit is not None:
            batch = batch.slice(0, t.limit)
        return batch


@public_evolving
class StreamTableEnvironment:
    def __init__(self, env: Optional[StreamExecutionEnvironment] = None):
        from flink_tpu_torch.ml.models import ModelRegistry

        self.env = env or StreamExecutionEnvironment.get_execution_environment()
        self._catalog: Dict[str, Table] = {}
        #: INSERT INTO targets: name -> (sink, declared columns or None)
        self._sink_tables: Dict[str, tuple] = {}
        #: lookup (dimension) tables: name -> (LookupFunction, columns)
        #: joined via FOR SYSTEM_TIME AS OF (reference: LookupTableSource)
        self._lookup_tables: Dict[str, tuple] = {}
        #: CREATE MODEL / ML_PREDICT catalog (reference: CatalogModel)
        self.models = ModelRegistry()

    def create_lookup_table(self, name: str, lookup_fn,
                            columns: Sequence[str],
                            cache_size: int = 0,
                            cache_ttl_ms=None) -> None:
        """Register a LookupFunction as a dimension table for lookup
        joins: ``JOIN name FOR SYSTEM_TIME AS OF o.rowtime ON ...``
        (reference: a LookupTableSource-backed catalog table; the cache
        maps FLIP-221 'lookup.cache' — opt-in like the reference, with
        ``cache_ttl_ms`` as expireAfterWrite so live dimension updates
        are eventually observed)."""
        self._lookup_tables[name] = (lookup_fn, list(columns),
                                     int(cache_size), cache_ttl_ms)

    def create_temporary_model(self, name: str, model) -> None:
        """Register a Model object for ML_PREDICT (the programmatic form
        of CREATE MODEL; reference: createTemporaryModel)."""
        self.models.register(name, model)

    @staticmethod
    def create(env: Optional[StreamExecutionEnvironment] = None
               ) -> "StreamTableEnvironment":
        return StreamTableEnvironment(env)

    # ------------------------------------------------------------- catalog

    def lookup(self, name: str) -> Table:
        if name not in self._catalog:
            raise PlanError(f"table or view {name!r} is not registered "
                            f"(known: {sorted(self._catalog)})")
        return self._catalog[name]

    def create_temporary_view(self, name: str, source,
                              columns: Optional[Sequence[str]] = None,
                              time_field: Optional[str] = None) -> None:
        """Register a DataStream or Table under a name for SQL queries.

        For a DataStream, ``columns`` lists the visible column names (the
        reference derives them from TypeInformation; batches here are typed
        only at runtime).
        """
        if isinstance(source, Table):
            self._catalog[name] = source
            return
        if columns is None:
            raise PlanError(
                "registering a DataStream as a view requires `columns`")
        self._catalog[name] = Table(self, source, columns, time_field)

    def create_sink_table(self, name: str, sink,
                          columns: Optional[Sequence[str]] = None) -> None:
        """Register a sink as an INSERT INTO target (the reference's
        connector sink table registered via CREATE TABLE ... WITH (...);
        here the sink object is provided programmatically). ``columns``,
        when given, validates and orders the inserted projection."""
        self._sink_tables[name] = (
            sink, list(columns) if columns is not None else None)

    def _create_connector_table(self, stmt) -> None:
        """CREATE TABLE ... WITH ('connector'='...') resolved through the
        connector registry (reference: DynamicTableFactory SPI discovered
        by the 'connector' option)."""
        from flink_tpu_torch.table.connectors import resolve_connector

        connector = stmt.options.get("connector")
        if not connector:
            raise PlanError(
                f"CREATE TABLE {stmt.name}: missing 'connector' option")
        factory = resolve_connector(connector)
        factory(self, stmt)

    def from_data_stream(self, stream: DataStream,
                         columns: Sequence[str],
                         time_field: Optional[str] = None) -> Table:
        return Table(self, stream, columns, time_field)

    def from_collection(self, rows, timestamp_field=None,
                        columns: Optional[Sequence[str]] = None) -> Table:
        rows = list(rows)
        ds = self.env.from_collection(rows, timestamp_field=timestamp_field)
        cols = list(columns) if columns is not None else \
            [c for c in rows[0].keys()]
        return Table(self, ds, cols, timestamp_field)

    # ----------------------------------------------------------------- SQL

    def explain_sql(self, sql: str) -> str:
        """The optimized logical + chained physical plan of a query
        (reference: TableEnvironment.explainSql)."""
        stmt = sql_parser.parse(sql)
        if isinstance(stmt, sql_parser.Explain):
            stmt = stmt.query
        if not isinstance(stmt, (sql_parser.SelectStmt,
                                 sql_parser.UnionAll)):
            raise PlanError(
                "EXPLAIN supports queries (SELECT / UNION ALL), not "
                f"{type(stmt).__name__}")
        return self.explain_sql_statement(sql_parser.Explain(stmt))

    def explain_sql_statement(self, stmt: "sql_parser.Explain") -> str:
        from flink_tpu_torch.table.explain import explain

        optimized = optimize(stmt.query)
        planned = Planner(self).plan_select(optimized)
        return explain(self, optimized, planned)

    def sql_query(self, sql: str) -> Table:
        stmt = sql_parser.parse(sql)
        if not isinstance(stmt, (sql_parser.SelectStmt,
                                 sql_parser.UnionAll)):
            raise PlanError("sql_query expects a SELECT statement")
        planned = Planner(self).plan_select(optimize(stmt))
        return Table._from_planned(self, planned)

    def execute_sql(self, sql: str):
        """Execute a statement (reference: TableEnvironmentImpl.java:936).
        Return value by statement kind: SELECT / UNION ALL -> TableResult;
        INSERT INTO -> the job's JobExecutionResult (runs eagerly);
        EXPLAIN -> the plan text (str); SHOW TABLES -> sorted name list;
        DESCRIBE -> schema dict; CREATE VIEW / CREATE MODEL -> None."""
        stmt = sql_parser.parse(sql)
        if isinstance(stmt, sql_parser.Explain):
            return self.explain_sql_statement(stmt)
        if isinstance(stmt, sql_parser.ShowTables):
            return sorted(self._catalog)
        if isinstance(stmt, sql_parser.Describe):
            t = self.lookup(stmt.name)
            return {
                "name": stmt.name,
                "columns": list(t.columns),
                "time_field": t.time_field,
                "changelog": t.upsert_keys is not None,
                **({"upsert_keys": t.upsert_keys}
                   if t.upsert_keys else {}),
            }
        if isinstance(stmt, sql_parser.CreateModel):
            self.models.create_from_options(stmt.name, stmt.options)
            return None
        if isinstance(stmt, sql_parser.CreateTable):
            self._create_connector_table(stmt)
            return None
        if isinstance(stmt, sql_parser.CreateView):
            planned = Planner(self).plan_select(optimize(stmt.query))
            self._catalog[stmt.name] = Table._from_planned(self, planned)
            return None
        if isinstance(stmt, sql_parser.InsertInto):
            if stmt.table not in self._sink_tables:
                raise PlanError(
                    f"INSERT INTO target {stmt.table!r} is not a "
                    "registered sink table; register one with "
                    "create_sink_table(name, sink, columns=...) "
                    f"(known sinks: {sorted(self._sink_tables)})")
            sink, sink_cols = self._sink_tables[stmt.table]
            planned = Planner(self).plan_select(optimize(stmt.query))
            stream = planned.stream
            sink_pk = getattr(sink, "upsert_keys", None)
            if planned.upsert_keys is not None and sink_pk:
                # upsert sink (PRIMARY KEY ... NOT ENFORCED): materialize
                # the changelog per sink key FIRST — the
                # SinkUpsertMaterializer operator (reference:
                # flink-table-runtime/.../sink/SinkUpsertMaterializer.java).
                # Its list-based algorithm is what makes a changelog
                # whose own key differs from the sink PRIMARY KEY (the
                # reference's main materializer trigger) come out right.
                from flink_tpu_torch.datastream.stream import DataStream
                from flink_tpu_torch.graph.transformations import Transformation
                from flink_tpu_torch.table.upsert_materializer import (
                    UpsertMaterializeOperator,
                )

                from flink_tpu_torch.core.config import StateOptions

                keys = list(sink_pk)
                ttl = self.env.config.get(
                    StateOptions.TABLE_EXEC_STATE_TTL) or None
                t = Transformation(
                    name=f"upsert_materialize({stmt.table})",
                    kind="one_input",
                    operator_factory=lambda keys=keys, ttl=ttl:
                        UpsertMaterializeOperator(keys, ttl_ms=ttl),
                    inputs=[stream.transformation],
                    keyed=True, key_field=keys[0])
                stream = DataStream(self.env, t)
            elif planned.upsert_keys is not None and not getattr(
                    sink, "supports_changelog", False):
                # an updating result written to an append-only sink would
                # record every intermediate per-key update as a fresh row
                # (reference: "Table sink doesn't support consuming update
                # changes" — the planner rejects exactly this)
                raise PlanError(
                    f"INSERT INTO {stmt.table}: the query produces an "
                    "updating (changelog) result but the sink is "
                    "append-only; use a sink with supports_changelog = "
                    "True or a PRIMARY KEY (upsert) table, or make the "
                    "query append-only (e.g. window aggregation instead "
                    "of plain GROUP BY)")
            if sink_cols is not None:
                missing = [c for c in sink_cols
                           if c not in planned.columns]
                if missing:
                    raise PlanError(
                        f"INSERT INTO {stmt.table}: query does not "
                        f"produce sink columns {missing} (query columns: "
                        f"{planned.columns})")
                # changelog consumers keep the row-kind column so they can
                # apply retractions
                cols = tuple(sink_cols) + (
                    (ROWKIND_FIELD,)
                    if planned.upsert_keys is not None else ())
                stream = stream.map(
                    lambda b, cols=cols: b.select(
                        *[c for c in cols if c in b.columns]),
                    name=f"insert_project({stmt.table})")
            stream.sink_to(sink)
            result = self.env.execute(f"insert-into-{stmt.table}")
            return result
        planned = Planner(self).plan_select(optimize(stmt))
        return TableResult(Table._from_planned(self, planned))
