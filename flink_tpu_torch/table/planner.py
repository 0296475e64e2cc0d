"""SQL AST -> DataStream transformation planner (port of
``flink_tpu/table/planner.py``).

reference: the Calcite optimize + translate pipeline
(flink-table-planner/.../delegation/PlannerBase.scala:175 translate,
:412 translateToExecNodeGraph; window agg at
StreamExecWindowAggregate.java:164). The AST first passes through
flink_tpu_torch.table.optimizer (constant folding, filter/join pushdown), then
the supported SQL shapes map 1:1 onto the vectorized operators —
* window TVF + GROUP BY  -> WindowAggOperator (slice-shared device agg)
* plain GROUP BY         -> GroupAggOperator (upsert stream)
* ROW_NUMBER() OVER      -> RankOperator (Top-N)
* JOIN with time bounds  -> IntervalJoinOperator
* JOIN on equality       -> buffered equi-join (unbounded interval join)
* WHERE / projections    -> Filter/Map with vectorized expressions

The aggregations run as the port's torch programs on ``execution.device``;
scalar expressions run as NumPy array ops on the host columns
(flink_tpu_torch.table.expressions). OVER aggregates run on the host or
the device engine (``table.exec.over.engine``), ML_PREDICT through a
registered model (a ``TorchModel`` runs on its own device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.core.records import (
    ROWKIND_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.datastream.stream import DataStream
from flink_tpu_torch.graph.transformations import Transformation
from flink_tpu_torch.runtime.group_agg import GroupAggOperator
from flink_tpu_torch.runtime.rank_operator import RankOperator
from flink_tpu_torch.table import sql_parser as ast
from flink_tpu_torch.table.expressions import (
    AggCall,
    Between,
    BinaryOp,
    Column,
    Expr,
    Literal,
    OverAgg,
    OverCall,
    SelectItem,
    Star,
)
from flink_tpu_torch.windowing.aggregates import (
    AggregateFunction,
    AvgAggregate,
    CountAggregate,
    MaxAggregate,
    MinAggregate,
    MultiAggregate,
    SumAggregate,
)
from flink_tpu_torch.windowing.assigners import (
    CumulativeEventTimeWindows,
    EventTimeSessionWindows,
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.windowing.windower import WINDOW_END_FIELD, WINDOW_START_FIELD

GROUP_KEY_FIELD = "__group_key__"
_WINDOW_COLS = (WINDOW_START_FIELD, WINDOW_END_FIELD, "window_time")

_UNBOUNDED = 1 << 60


class PlanError(ValueError):
    pass


@dataclasses.dataclass
class PlannedTable:
    """A planned relational node: a stream plus its visible column names."""

    stream: DataStream
    columns: List[str]
    alias: Optional[str] = None
    #: which visible column is the event-time attribute (maps to __ts__)
    time_field: Optional[str] = None
    #: non-None marks an upsert (changelog) stream keyed by these columns
    upsert_keys: Optional[List[str]] = None
    #: ORDER BY / LIMIT applied at materialization time (bounded results)
    sort_spec: Optional[List[Tuple[Expr, bool]]] = None
    limit: Optional[int] = None


class Planner:
    def __init__(self, t_env):
        self.t_env = t_env
        self.env = t_env.env

    # ------------------------------------------------------------ entry

    def plan_select(self, stmt) -> PlannedTable:
        if isinstance(stmt, ast.UnionAll):
            return self._plan_union(stmt)
        window = None
        if isinstance(stmt.table, ast.WindowTVF):
            window = stmt.table
            source = self._plan_table_ref(window.table)
            source.alias = window.alias or source.alias
        else:
            source = self._plan_table_ref(stmt.table)

        aliases = self._collect_aliases(stmt.table)
        resolve = lambda e: self._resolve(e, source.columns, aliases)  # noqa: E731

        where = resolve(stmt.where) if stmt.where is not None else None
        items = self._expand_star(
            [SelectItem(resolve(i.expr), i.alias) for i in stmt.items],
            source, window)
        group_by = [resolve(g) for g in stmt.group_by]
        having = resolve(stmt.having) if stmt.having is not None else None

        stream = source.stream
        if where is not None:
            stream = stream.filter(lambda b, e=where: e.eval(b).astype(bool),
                                   name="sql_where")

        has_aggs = bool(group_by) or any(i.expr.aggregates() for i in items) \
            or stmt.distinct
        over_calls = [i for i in items if isinstance(i.expr, OverCall)]
        over_aggs = [i for i in items if isinstance(i.expr, OverAgg)]
        for i in items:
            if isinstance(i.expr, (OverCall, OverAgg)):
                continue
            nested = [n for n in i.expr.walk()
                      if isinstance(n, (OverCall, OverAgg))]
            if nested:
                raise PlanError(
                    "an OVER window must be a top-level SELECT item "
                    f"(found one nested inside {i.name!r}); compute it "
                    "in a subquery first")

        if over_aggs:
            if has_aggs or over_calls:
                raise PlanError(
                    "OVER aggregates cannot mix with GROUP BY or "
                    "ROW_NUMBER in one SELECT; use a subquery")
            return self._plan_over_agg(stream, source, items, over_aggs,
                                       stmt)
        if over_calls:
            if has_aggs:
                raise PlanError("OVER and GROUP BY in one SELECT "
                                "are not supported; use a subquery")
            return self._plan_over(stream, source, items, over_calls, stmt)
        if has_aggs:
            return self._plan_aggregate(stream, source, items, group_by,
                                        having, window, stmt)
        if window is not None:
            raise PlanError("a window TVF requires GROUP BY window_start, "
                            "window_end")
        return self._plan_projection(stream, source, items, stmt)

    def _plan_union(self, stmt: "ast.UnionAll") -> PlannedTable:
        """UNION ALL: plan every branch, require identical output columns,
        merge the streams (reference: StreamExecUnion — a plain stream
        merge, no exchange)."""
        planned = [self.plan_select(s) for s in stmt.selects]
        cols = planned[0].columns
        for p in planned:
            if p.columns != cols:
                raise PlanError(
                    "UNION ALL branches must produce identical columns; "
                    f"got {cols} vs {p.columns}")
            if p.upsert_keys is not None:
                # merging changelog streams would alias per-branch keys:
                # downstream upsert materialization keeps one row per key
                # ACROSS branches, silently dropping the other branch's
                raise PlanError(
                    "UNION ALL over an updating (changelog) branch is "
                    "not supported — materialize the aggregates first "
                    "(e.g. windowed aggregation) or union the raw inputs")
        # event-time agreement cannot be decided here (projections
        # legitimately drop the time-field marker while the timestamp
        # column rides along) — the union operator's runtime guard
        # (strict for SQL unions) names the cause instead
        stream = planned[0].stream.union(
            *[p.stream for p in planned[1:]],
            _require_consistent_time=True) if len(planned) > 1 \
            else planned[0].stream
        out = PlannedTable(stream, list(cols), None, planned[0].time_field)
        return self._apply_order_limit(out, stmt)

    # ------------------------------------------------------- FROM clause

    def _plan_table_ref(self, ref: ast.TableRef) -> PlannedTable:
        from flink_tpu_torch.table.fluent import _InlineTable

        if isinstance(ref, _InlineTable):
            # the fluent API's FROM clause: a live Table object instead of
            # a catalog name (reference: Table API queries never register)
            t = ref.table
            if t.sort_spec is not None or t.limit is not None:
                # ORDER BY / LIMIT are materialization-time decorations in
                # this engine; further relational ops over them would
                # silently ignore the sort/limit — fail instead
                raise PlanError(
                    "order_by()/fetch() are terminal operations — apply "
                    "them AFTER the other relational operations (their "
                    "sort/limit applies when the table materializes)")
            return PlannedTable(t.stream, list(t.columns), ref.alias,
                                t.time_field, t.upsert_keys)
        if isinstance(ref, ast.NamedTable):
            t = self.t_env.lookup(ref.name)
            if t.sort_spec is not None or t.limit is not None:
                # a view/table carrying ORDER BY/LIMIT: those are
                # materialization-time decorations an enclosing query
                # would silently discard — same contract as subqueries
                raise PlanError(
                    f"table/view {ref.name!r} carries ORDER BY / LIMIT, "
                    "which only applies when it materializes directly — "
                    "query the underlying data and apply the sort/limit "
                    "in the outermost query")
            return PlannedTable(t.stream, list(t.columns), ref.alias,
                                t.time_field, t.upsert_keys)
        if isinstance(ref, ast.SubQuery):
            inner = self.plan_select(ref.query)
            if inner.sort_spec is not None or inner.limit is not None:
                # ORDER BY/LIMIT are materialization-time; an enclosing
                # query would silently ignore them (same contract as the
                # fluent API's terminal order_by/fetch)
                raise PlanError(
                    "ORDER BY / LIMIT inside a subquery is not supported "
                    "— apply them in the outermost query")
            inner.alias = ref.alias
            return inner
        if isinstance(ref, ast.WindowTVF):
            raise PlanError("window TVF only supported directly in FROM of "
                            "an aggregating SELECT")
        if isinstance(ref, ast.MLPredictTVF):
            return self._plan_ml_predict(ref)
        if isinstance(ref, ast.Join):
            return self._plan_join(ref)
        if isinstance(ref, ast.MatchRecognize):
            return self._plan_match_recognize(ref)
        raise PlanError(f"unsupported table ref {ref!r}")

    # --------------------------------------------------- MATCH_RECOGNIZE

    def _plan_match_recognize(self, mr: "ast.MatchRecognize"
                              ) -> PlannedTable:
        """MATCH_RECOGNIZE -> the CEP engine (reference: StreamExecMatch
        compiles the row pattern onto flink-cep's NFA). Row-pattern
        semantics: variables bind CONSECUTIVE rows of the partition in
        rowtime order (strict contiguity; loops are consecutive), and
        SQL quantifiers are greedy unless marked reluctant with '?'."""
        from flink_tpu_torch.cep.operator import CepOperator
        from flink_tpu_torch.cep.pattern import (
            AfterMatchSkipStrategy,
            Pattern,
        )

        source = self._plan_table_ref(mr.table)
        if source.upsert_keys is not None:
            raise PlanError(
                "MATCH_RECOGNIZE over an updating (changelog) input is "
                "not supported — inputs must be insert-only")
        if source.time_field is None:
            raise PlanError(
                "MATCH_RECOGNIZE requires the table to declare an "
                "event-time column (WATERMARK FOR ...)")
        if mr.order_by is None or mr.order_by != source.time_field:
            raise PlanError(
                "MATCH_RECOGNIZE must ORDER BY the table's event-time "
                f"column ({source.time_field!r}); got {mr.order_by!r}")
        if len(mr.partition_by) != 1:
            raise PlanError(
                "MATCH_RECOGNIZE supports PARTITION BY exactly one "
                "column")
        key_col = mr.partition_by[0]
        if key_col not in source.columns:
            raise PlanError(
                f"PARTITION BY column {key_col!r} is not a column of "
                f"the input ({source.columns})")
        if not mr.pattern:
            raise PlanError("PATTERN () is empty")
        var_names = [v for v, _, _, _ in mr.pattern]
        if len(set(var_names)) != len(var_names):
            raise PlanError(
                f"duplicate pattern variables: {var_names}")
        unknown = [v for v in mr.define if v not in var_names]
        if unknown:
            raise PlanError(
                f"DEFINE names unknown pattern variables: {unknown}")
        for func, var, col, alias in mr.measures:
            if var not in var_names:
                raise PlanError(
                    f"measure references unknown pattern variable "
                    f"{var!r}")
            if col not in source.columns:
                raise PlanError(
                    f"measure column {col!r} is not an input column")

        pat = None
        for var, mn, mx, greedy in mr.pattern:
            if pat is None:
                pat = Pattern.begin(var)
            else:
                pat = pat.next(var)
            if (mn, mx) != (1, 1):
                if mx is None:
                    pat = pat.times_or_more(mn)
                else:
                    pat = pat.times(mn, mx)
                # row-pattern loops bind consecutive rows
                pat = pat.consecutive()
                if greedy and (mx is None or mx > 1):
                    pat = pat.greedy()
            cond = mr.define.get(var)
            if cond is not None:
                pat = self._compile_define(pat, cond, var, var_names)
        if mr.within_ms is not None:
            pat = pat.within(mr.within_ms)
        if mr.after_match == "PAST_LAST_ROW":
            pat = pat.with_skip_strategy(
                AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT)

        measures = list(mr.measures)

        def select(key_value, match, events_by_stage,
                   _measures=tuple(measures), _key_col=key_col):
            row = {_key_col: key_value}
            for func, var, col, alias in _measures:
                evs = events_by_stage.get(var, [])
                vals = [e[col] for e in evs]
                if not vals:
                    row[alias] = (0 if func == "COUNT" else np.nan)
                elif func == "FIRST":
                    row[alias] = vals[0]
                elif func == "LAST":
                    row[alias] = vals[-1]
                elif func == "COUNT":
                    row[alias] = len(vals)
                elif func == "SUM":
                    row[alias] = float(np.sum(vals))
                elif func == "AVG":
                    row[alias] = float(np.mean(vals))
                elif func == "MIN":
                    row[alias] = min(vals)
                else:
                    row[alias] = max(vals)
            return row

        keyed = source.stream.key_by(key_col)
        pat = pat.validate()
        # cep.mode=device routes the row pattern onto the mesh NFA
        # engine (one compiled advance per fire, matches queryable via
        # the replica plane). Eligibility is checked HERE so the plan
        # explains itself: an ineligible pattern plans the host
        # operator with the loud fallback counter, not a job failure.
        from flink_tpu_torch.core.config import DeploymentOptions

        cep_mode = self.env.config.get(DeploymentOptions.CEP_MODE)
        if cep_mode == "device":
            from flink_tpu_torch.cep.kernels import UnsupportedCepPattern
            from flink_tpu_torch.cep.kernels import compile_device_pattern
            from flink_tpu_torch.cep.mesh_engine import record_host_fallback

            try:
                compile_device_pattern(pat)
            except UnsupportedCepPattern as e:
                record_host_fallback(
                    f"MATCH_RECOGNIZE {mr.alias or ''}: {e}")
                cep_mode = "host"
        if cep_mode == "device":
            from flink_tpu_torch.cep.operators import MeshCepOperator

            factory = (lambda pat=pat, key_col=key_col, sel=select:
                       MeshCepOperator(pat, key_col, select=sel))
        else:
            factory = (lambda pat=pat, key_col=key_col, sel=select:
                       CepOperator(pat, key_col, select=sel))
        t = Transformation(
            name="sql_match_recognize", kind="one_input",
            operator_factory=factory,
            inputs=[keyed.transformation], keyed=True, key_field=key_col)
        out_cols = [key_col] + [alias for _, _, _, alias in measures]
        return PlannedTable(DataStream(self.env, t), out_cols, mr.alias,
                            None)

    def _compile_define(self, pat, expr: Expr, var: str,
                        var_names: List[str]):
        """A DEFINE condition: references to the variable's OWN columns
        vectorize (one mask per batch); references to OTHER variables'
        events (B.price < A.price) become an iterative condition reading
        the partial match (reference: MATCH_RECOGNIZE DEFINE lowering to
        IterativeCondition)."""
        cross = [n for n in expr.walk()
                 if isinstance(n, Column) and n.table
                 and n.table.upper() in var_names
                 and n.table.upper() != var]
        own_refs = {n: Column(n.name) for n in expr.walk()
                    if isinstance(n, Column) and n.table
                    and n.table.upper() == var}
        if not cross:
            cond_expr = expr.rewrite(own_refs) if own_refs else expr

            def vcond(b, e=cond_expr):
                return np.asarray(e.eval(b), dtype=bool)

            return pat.where(vcond)

        def icond(event_row, ctx, e=expr, cross=tuple(cross),
                  own=dict(own_refs)):
            mapping = dict(own)
            for r in cross:
                evs = ctx.events_for(r.table.upper())
                if not evs:
                    # LAST(X.col) over no events is NULL; a NULL
                    # comparison is not satisfied (SQL three-valued
                    # logic collapses to false here)
                    return False
                mapping[r] = Literal(evs[-1][r.name])
            e2 = e.rewrite(mapping)
            batch = RecordBatch.from_pydict(
                {k: np.asarray([v]) for k, v in event_row.items()
                 if not k.startswith("__")})
            return bool(np.asarray(e2.eval(batch))[0])

        return pat.where_iterative(icond)

    def _plan_ml_predict(self, ref: "ast.MLPredictTVF") -> PlannedTable:
        """ML_PREDICT(TABLE t, MODEL m, DESCRIPTOR(...)) — one batched
        inference per micro-batch appending the model's output columns
        (reference: MLPredictRunner invoked from SQL; flink-models)."""
        from flink_tpu_torch.ml.operators import MLPredictOperator

        inner = self._plan_table_ref(ref.table)
        if inner.upsert_keys is not None:
            raise PlanError("ML_PREDICT over an updating (changelog) "
                            "input is not supported")
        model = self.t_env.models.get(ref.model)
        missing = [f for f in ref.fields if f not in inner.columns]
        if missing:
            raise PlanError(
                f"ML_PREDICT descriptor columns {missing} not in input "
                f"columns {inner.columns}")
        if len(ref.fields) != len(model.input_names):
            raise PlanError(
                f"model {ref.model!r} expects "
                f"{len(model.input_names)} inputs "
                f"{tuple(model.input_names)}, the DESCRIPTOR names "
                f"{len(ref.fields)}: {tuple(ref.fields)}")
        t = Transformation(
            name=f"ml_predict({ref.model})", kind="one_input",
            operator_factory=lambda: MLPredictOperator(
                model, input_fields=ref.fields),
            inputs=[inner.stream.transformation])
        out_cols = list(inner.columns) + [
            n for n in model.output_names if n not in inner.columns]
        return PlannedTable(DataStream(self.env, t), out_cols,
                            ref.alias or inner.alias, inner.time_field)

    def _collect_aliases(self, ref: ast.TableRef,
                         side: str = "") -> Dict[str, str]:
        """alias -> join-suffix ('' when unambiguous, '_l'/'_r' in a join)."""
        out: Dict[str, str] = {}
        if isinstance(ref, ast.Join):
            out.update(self._collect_aliases(ref.left, "_l"))
            out.update(self._collect_aliases(ref.right, "_r"))
            return out
        if isinstance(ref, ast.MLPredictTVF):
            # qualified columns keep resolving by the inner table's name
            # (same treatment as the WindowTVF branch below)
            out = self._collect_aliases(ref.table, side)
            if ref.alias is not None:
                out[ref.alias] = side
            return out
        alias = getattr(ref, "alias", None)
        if alias is None and isinstance(ref, ast.NamedTable):
            alias = ref.name
        if isinstance(ref, ast.WindowTVF):
            inner = ref.table
            if isinstance(inner, ast.NamedTable):
                out[alias or inner.name] = side
                if alias is None and inner.alias:
                    out[inner.alias] = side
                out[inner.name] = side
                return out
        if alias is not None:
            out[alias] = side
        return out

    # --------------------------------------------------------- resolution

    def _resolve(self, expr: Expr, columns: Sequence[str],
                 aliases: Dict[str, str]) -> Expr:
        """Strip table qualifiers, mapping to suffixed columns after joins."""
        if isinstance(expr, Column):
            if expr.table is None:
                return expr
            suffix = aliases.get(expr.table, "")
            if suffix and (expr.name + suffix) in columns:
                return Column(expr.name + suffix)
            return Column(expr.name)
        if isinstance(expr, OverCall):
            return OverCall(
                expr.func,
                tuple(self._resolve(e, columns, aliases)
                      for e in expr.partition_by),
                tuple((self._resolve(e, columns, aliases), d)
                      for e, d in expr.order_by))
        if isinstance(expr, OverAgg):
            return OverAgg(
                expr.func,
                self._resolve(expr.arg, columns, aliases)
                if expr.arg is not None else None,
                tuple(self._resolve(e, columns, aliases)
                      for e in expr.partition_by),
                tuple((self._resolve(e, columns, aliases), d)
                      for e, d in expr.order_by),
                mode=expr.mode, preceding=expr.preceding)
        mapping = {
            node: self._resolve(node, columns, aliases)
            for node in expr.walk()
            if isinstance(node, Column) and node.table is not None
        }
        return expr.rewrite(mapping) if mapping else expr

    def _expand_star(self, items: List[SelectItem], source: PlannedTable,
                     window) -> List[SelectItem]:
        out: List[SelectItem] = []
        for i in items:
            if isinstance(i.expr, Star):
                for c in source.columns:
                    out.append(SelectItem(Column(c)))
                if window is not None:
                    out.append(SelectItem(Column(WINDOW_START_FIELD)))
                    out.append(SelectItem(Column(WINDOW_END_FIELD)))
            else:
                out.append(i)
        return out

    # ------------------------------------------------------- projections

    def _plan_projection(self, stream: DataStream, source: PlannedTable,
                         items: List[SelectItem],
                         stmt: ast.SelectStmt) -> PlannedTable:
        names = [i.name for i in items]
        exprs = [i.expr for i in items]

        def project(batch: RecordBatch, exprs=exprs, names=names):
            cols = {n: np.asarray(e.eval(batch))
                    for n, e in zip(names, exprs)}
            if batch.has_timestamps:
                cols[TIMESTAMP_FIELD] = batch.timestamps
            if ROWKIND_FIELD in batch.columns:
                # changelog kinds ride through projections untouched
                cols[ROWKIND_FIELD] = batch[ROWKIND_FIELD]
            return RecordBatch(cols)

        out = stream.map(project, name="sql_project")
        return self._finish(out, names, source, stmt)

    # -------------------------------------------------------- aggregation

    def _plan_aggregate(self, stream: DataStream, source: PlannedTable,
                        items: List[SelectItem], group_by: List[Expr],
                        having: Optional[Expr], window: Optional[ast.WindowTVF],
                        stmt: ast.SelectStmt) -> PlannedTable:
        updating_input = source.upsert_keys is not None
        if updating_input and window is not None:
            raise PlanError(
                "event-time window aggregate over an updating (changelog) "
                "input is not supported — window state cannot retract "
                "(reference: StreamPhysicalWindowAggregate requires "
                "insert-only input)")
        if stmt.distinct and not any(i.expr.aggregates() for i in items) \
                and not group_by:
            group_by = [i.expr for i in items]

        # split group keys into window bookkeeping columns vs data keys
        key_exprs: List[Expr] = []
        for g in group_by:
            if isinstance(g, Column) and g.name in _WINDOW_COLS:
                if window is None and g.name not in source.columns:
                    raise PlanError(f"GROUP BY {g.name} without a window TVF")
                if window is not None:
                    continue  # implicit in the window agg output
            key_exprs.append(g)

        # aggregate calls, deduped structurally
        agg_calls: List[AggCall] = []
        for i in items:
            for a in i.expr.aggregates():
                if a not in agg_calls:
                    agg_calls.append(a)
        if having is not None:
            for a in having.aggregates():
                if a not in agg_calls:
                    agg_calls.append(a)
        if not agg_calls:
            agg_calls.append(AggCall("COUNT", None))  # pure DISTINCT

        # materialize computed key / agg-input columns
        pre_cols: Dict[str, Expr] = {}
        key_fields: List[str] = []
        for ki, g in enumerate(key_exprs):
            if isinstance(g, Column):
                key_fields.append(g.name)
            else:
                name = f"__key_{ki}__"
                pre_cols[name] = g
                key_fields.append(name)
        agg_fns: List[AggregateFunction] = []
        agg_out_names: List[str] = []
        for ai, a in enumerate(agg_calls):
            if a.distinct:
                raise PlanError("DISTINCT aggregates are not supported yet")
            out_name = f"__agg_{ai}__"
            agg_out_names.append(out_name)
            if a.func == "COUNT":
                agg_fns.append(CountAggregate(output=out_name))
                continue
            if isinstance(a.arg, Column):
                field = a.arg.name
            else:
                field = f"__agg_in_{ai}__"
                pre_cols[field] = a.arg
            cls = {"SUM": SumAggregate, "MIN": MinAggregate,
                   "MAX": MaxAggregate, "AVG": AvgAggregate}[a.func]
            if cls is AvgAggregate:
                agg_fns.append(AvgAggregate(field, output=out_name))
            else:
                agg_fns.append(cls(field, output=out_name))

        if pre_cols:
            def add_cols(batch, pre_cols=pre_cols):
                for n, e in pre_cols.items():
                    batch = batch.with_column(n, np.asarray(e.eval(batch)))
                return batch

            stream = stream.map(add_cols, name="sql_pre_project")

        # composite / missing key handling
        if len(key_fields) == 0:
            const_key = "__global__"

            def add_const(batch, name=const_key):
                return batch.with_column(
                    name, np.zeros(len(batch), dtype=np.int64))

            stream = stream.map(add_const, name="sql_global_key")
            key_field = const_key
        elif len(key_fields) == 1:
            key_field = key_fields[0]
        else:
            key_field = GROUP_KEY_FIELD

            def add_tuple_key(batch, fields=tuple(key_fields)):
                vals = list(zip(*[batch[f].tolist() for f in fields]))
                arr = np.empty(len(batch), dtype=object)
                arr[:] = vals
                return batch.with_column(GROUP_KEY_FIELD, arr)

            stream = stream.map(add_tuple_key, name="sql_composite_key")

        keyed = stream.key_by(key_field)
        multi = MultiAggregate(agg_fns)
        if updating_input and not multi.retractable:
            raise PlanError(
                "MAX/MIN over an updating (changelog) input requires "
                "retractable accumulators, which MAX/MIN are not "
                "(reference: MaxWithRetractAggFunction keeps a sorted "
                "multiset; use an append-only input or COUNT/SUM/AVG)")
        upsert_keys: Optional[List[str]] = None
        if window is not None:
            assigner = _window_assigner(window)
            agged = keyed.window(assigner).aggregate(
                multi, name=f"sql_{window.kind.lower()}_agg")
        else:
            capacity = self.env.state_slot_capacity
            from flink_tpu_torch.core.config import ExecutionModeOptions

            # batch mode: one changelog row per group at end-of-input
            # instead of per-micro-batch upsert churn (reference: batch
            # mode runs GROUP BY as a bounded aggregate, emitting finals)
            batch_final = self.env.config.get(
                ExecutionModeOptions.RUNTIME_MODE) == "batch"
            from flink_tpu_torch.core.config import StateOptions

            # TTL applies to STREAMING only — in batch mode emission is
            # deferred to end-of-input, and a mid-ingest sweep would
            # silently delete groups from the final result (the
            # reference's table.exec.state.ttl is likewise stream-only)
            ttl = None if batch_final else (self.env.config.get(
                StateOptions.TABLE_EXEC_STATE_TTL) or None)
            t = Transformation(
                name="sql_group_agg", kind="one_input",
                operator_factory=lambda: GroupAggOperator(
                    multi, key_field, capacity=capacity,
                    emit_on_watermark_only=batch_final,
                    ttl_ms=ttl),
                inputs=[keyed.transformation], keyed=True,
                key_field=key_field)
            agged = DataStream(self.env, t)
            upsert_keys = list(key_fields) or [const_key]

        # split composite tuple key back into its columns
        post = agged
        if key_field == GROUP_KEY_FIELD:
            def split_key(batch, fields=tuple(key_fields)):
                tuples = batch[GROUP_KEY_FIELD]
                for j, f in enumerate(fields):
                    batch = batch.with_column(
                        f, np.array([t[j] for t in tuples], dtype=object))
                return batch.drop(GROUP_KEY_FIELD)

            post = post.map(split_key, name="sql_split_key")
            if upsert_keys is not None:
                upsert_keys = list(key_fields)

        if having is not None:
            hav = self._sub_aggs(having, agg_calls, agg_out_names)
            post = post.filter(
                lambda b, e=hav: np.asarray(e.eval(b)).astype(bool),
                name="sql_having")

        # final projection over (keys + window cols + agg results)
        names, exprs = [], []
        for i in items:
            names.append(self._agg_item_name(i))
            exprs.append(self._sub_aggs(i.expr, agg_calls, agg_out_names))

        def project(batch, exprs=tuple(exprs), names=tuple(names)):
            cols = {n: np.asarray(e.eval(batch))
                    for n, e in zip(names, exprs)}
            if batch.has_timestamps:
                cols[TIMESTAMP_FIELD] = batch.timestamps
            if ROWKIND_FIELD in batch.columns:
                # the group agg's changelog kinds survive the projection so
                # downstream consumers (outer aggregates, upsert
                # materialization) see retractions
                cols[ROWKIND_FIELD] = batch[ROWKIND_FIELD]
            return RecordBatch(cols)

        out = post.map(project, name="sql_agg_project")
        planned = PlannedTable(out, list(names), source.alias,
                               time_field=WINDOW_END_FIELD
                               if window is not None
                               and WINDOW_END_FIELD in names else None,
                               upsert_keys=None)
        if upsert_keys is not None:
            # project the upsert keys through the select list; a global
            # aggregate (no keys in the output) dedupes to the last row
            planned.upsert_keys = [n for n, e in zip(names, exprs)
                                   if isinstance(e, Column)
                                   and e.name in upsert_keys]
        return self._apply_order_limit(planned, stmt)

    @staticmethod
    def _agg_item_name(item: SelectItem) -> str:
        if item.alias:
            return item.alias
        return item.expr.output_name()

    @staticmethod
    def _sub_aggs(expr: Expr, agg_calls: List[AggCall],
                  out_names: List[str]) -> Expr:
        mapping = {a: Column(n) for a, n in zip(agg_calls, out_names)}
        return expr.rewrite(mapping)

    # ------------------------------------------------------------- Top-N

    def _plan_over(self, stream: DataStream, source: PlannedTable,
                   items: List[SelectItem], over_items: List[SelectItem],
                   stmt: ast.SelectStmt) -> PlannedTable:
        if len(over_items) != 1:
            raise PlanError("exactly one OVER call per SELECT is supported")
        if source.upsert_keys is not None:
            raise PlanError(
                "OVER/Top-N over an updating (changelog) input is not "
                "supported yet — rank inputs must be insert-only "
                "(reference: AppendOnlyTopNFunction vs RetractableTopN)")
        item = over_items[0]
        over: OverCall = item.expr
        rank_name = item.alias or over.output_name()
        t = Transformation(
            name="sql_rank", kind="one_input",
            operator_factory=lambda: RankOperator(
                over.partition_by, over.order_by, rank_field=rank_name,
                rank_kind=over.func),
            inputs=[stream.transformation])
        ranked = DataStream(self.env, t)

        names, exprs = [], []
        for i in items:
            if i is item:
                names.append(rank_name)
                exprs.append(Column(rank_name))
            else:
                names.append(i.name)
                exprs.append(i.expr)

        def project(batch, exprs=tuple(exprs), names=tuple(names)):
            cols = {n: np.asarray(e.eval(batch))
                    for n, e in zip(names, exprs)}
            if batch.has_timestamps:
                cols[TIMESTAMP_FIELD] = batch.timestamps
            return RecordBatch(cols)

        out = ranked.map(project, name="sql_rank_project")
        return self._finish(out, names, source, stmt)

    # ----------------------------------------------------- OVER aggregates

    def _plan_over_agg(self, stream: DataStream, source: PlannedTable,
                       items: List[SelectItem],
                       over_items: List[SelectItem],
                       stmt: ast.SelectStmt) -> PlannedTable:
        """agg(x) OVER (PARTITION BY k ORDER BY rowtime frame) —
        reference: StreamExecOverAggregate. Every OVER call in one
        SELECT must share one window spec (the reference's
        single-over-window-per-operator restriction)."""
        from flink_tpu_torch.runtime.over_agg import OverAggOperator

        if source.upsert_keys is not None:
            raise PlanError(
                "OVER aggregation over an updating (changelog) input is "
                "not supported — inputs must be insert-only")
        first: OverAgg = over_items[0].expr
        for i in over_items[1:]:
            o: OverAgg = i.expr
            if (o.partition_by, o.order_by, o.mode, o.preceding) != (
                    first.partition_by, first.order_by, first.mode,
                    first.preceding):
                raise PlanError(
                    "all OVER aggregates in one SELECT must share the "
                    "same window (PARTITION BY / ORDER BY / frame)")
        if len(first.partition_by) != 1 or not isinstance(
                first.partition_by[0], Column):
            raise PlanError(
                "OVER requires PARTITION BY exactly one column")
        key_col = first.partition_by[0].name
        if len(first.order_by) != 1 or first.order_by[0][1]:
            raise PlanError(
                "OVER requires ORDER BY the event-time column ASC")
        order_col = first.order_by[0][0]
        if source.time_field is None:
            # the operator orders frames by the rows' event time — with
            # no declared time attribute an arbitrary ORDER BY column
            # would be silently ignored (reference: streaming OVER
            # requires a time attribute order)
            raise PlanError(
                "OVER requires the table to declare an event-time "
                "column (WATERMARK FOR ...) and ORDER BY it")
        if not isinstance(order_col, Column) or \
                order_col.name != source.time_field:
            raise PlanError(
                "OVER must ORDER BY the table's event-time column "
                f"({source.time_field!r}); got "
                f"{order_col.output_name()!r} (reference: streaming OVER "
                "windows are rowtime-ordered)")

        # materialize non-column arguments as temp columns first; the
        # operator writes INTERNAL output names so a user alias can
        # never clobber a source column another select item still reads
        specs = []
        out_names: Dict[int, str] = {}
        pre_cols: List[Tuple[str, Expr]] = []
        for j, item in enumerate(over_items):
            o: OverAgg = item.expr
            internal = f"__over_out_{j}__"
            out_names[id(item)] = internal
            if o.arg is None:
                specs.append((o.func, None, internal))
            elif isinstance(o.arg, Column):
                specs.append((o.func, o.arg.name, internal))
            else:
                tmp = f"__over_arg_{j}__"
                pre_cols.append((tmp, o.arg))
                specs.append((o.func, tmp, internal))
        if pre_cols:
            def add_args(batch, pre=tuple(pre_cols)):
                for name, e in pre:
                    batch = batch.with_column(
                        name, np.asarray(e.eval(batch)))
                return batch

            stream = stream.map(add_args, name="sql_over_args")
        mode, preceding = first.mode, first.preceding
        from flink_tpu_torch.core.config import StateOptions

        engine = self.env.config.get(StateOptions.TABLE_EXEC_OVER_ENGINE)
        from flink_tpu_torch.runtime.over_device import (
            DeviceOverAggOperator, device_supported)

        if engine not in ("auto", "device", "host"):
            raise PlanError(
                f"table.exec.over.engine must be auto/device/host, got "
                f"{engine!r}")
        # the device program computes float64 on every device, so auto
        # picks it wherever the frame family has a device form (the
        # reference's auto does so only under JAX x64: without it its
        # program would fold SQL DOUBLE in float32)
        use_device = (engine == "device"
                      or (engine == "auto" and device_supported(
                          specs, mode, preceding)))
        if engine == "device" and not device_supported(
                specs, mode, preceding):
            raise PlanError(
                "table.exec.over.engine=device: bounded RANGE MIN/MAX "
                "frames have no device form — use engine=host or auto")
        op_cls = DeviceOverAggOperator if use_device else OverAggOperator
        t = Transformation(
            name="sql_over_agg", kind="one_input",
            operator_factory=lambda key_col=key_col, specs=tuple(specs),
            mode=mode, preceding=preceding, op_cls=op_cls: op_cls(
                key_col, list(specs), mode=mode, preceding=preceding),
            inputs=[stream.key_by(key_col).transformation])
        over_stream = DataStream(self.env, t)

        names, exprs = [], []
        for i in items:
            if i in over_items:
                names.append(i.alias or i.expr.output_name())
                exprs.append(Column(out_names[id(i)]))
            else:
                names.append(i.name)
                exprs.append(i.expr)

        def project(batch, exprs=tuple(exprs), names=tuple(names)):
            cols = {n: np.asarray(e.eval(batch))
                    for n, e in zip(names, exprs)}
            if batch.has_timestamps:
                cols[TIMESTAMP_FIELD] = batch.timestamps
            return RecordBatch(cols)

        out = over_stream.map(project, name="sql_over_project")
        return self._finish(out, names, source, stmt)

    # --------------------------------------------------------------- joins

    def _plan_join(self, join: ast.Join) -> PlannedTable:
        if join.temporal is not None:
            return self._plan_temporal_join(join)
        if join.kind not in ("INNER", "LEFT"):
            raise PlanError(f"{join.kind} JOIN is not supported yet")
        left = self._plan_table_ref(join.left)
        right = self._plan_table_ref(join.right)
        if left.upsert_keys is not None or right.upsert_keys is not None:
            raise PlanError(
                "JOIN over an updating (changelog) input is not supported "
                "yet — join inputs must be insert-only")
        l_aliases = self._collect_aliases(join.left)
        r_aliases = self._collect_aliases(join.right)

        conjuncts = _split_conjuncts(join.condition)
        equi: List[Tuple[Expr, Expr]] = []
        time_bounds: Optional[Tuple[int, int]] = None
        residual: List[Expr] = []
        for c in conjuncts:
            pair = self._match_equi(c, left, right, l_aliases, r_aliases)
            if pair is not None:
                equi.append(pair)
                continue
            tb = self._match_time_bound(c, left, right, l_aliases, r_aliases)
            if tb is not None:
                if time_bounds is not None:
                    lo = max(time_bounds[0], tb[0])
                    hi = min(time_bounds[1], tb[1])
                    time_bounds = (lo, hi)
                else:
                    time_bounds = tb
                continue
            residual.append(c)
        if not equi:
            raise PlanError("JOIN requires at least one equality predicate")
        left_outer = join.kind == "LEFT"
        if left_outer and residual:
            # a residual applied as a post-filter would DROP null-padded
            # rows instead of null-extending when the predicate fails on
            # a matched pair — reject rather than silently change LEFT
            # semantics (reference: non-equi conditions are part of the
            # join for outer joins)
            raise PlanError(
                "LEFT JOIN supports only equality and event-time-bound "
                "conditions; move other predicates to WHERE (changing "
                "the null-extension semantics) or use INNER JOIN")
        if left_outer and time_bounds is None:
            raise PlanError(
                "streaming LEFT JOIN requires event-time bounds (an "
                "interval join) so expiry is decidable — add a BETWEEN "
                "over the two rowtimes")

        lower, upper = time_bounds if time_bounds is not None \
            else (-_UNBOUNDED, _UNBOUNDED)
        from flink_tpu_torch.runtime.join_operators import IntervalJoinOperator

        # the padded-row schema must match _merge_columns' matched-row
        # schema exactly, including the synthetic join-key column both
        # sides carry after _key_for_join
        pad_cols = tuple(right.columns) + (GROUP_KEY_FIELD,)
        return self._lower_keyed_join(
            left, right, l_aliases, r_aliases, equi, residual,
            lambda pad_cols=pad_cols: IntervalJoinOperator(
                lower, upper, suffixes=("_l", "_r"),
                left_outer=left_outer,
                right_columns=list(pad_cols)),
            "sql_join")

    def _plan_lookup_join(self, join: ast.Join) -> PlannedTable:
        """JOIN dim FOR SYSTEM_TIME AS OF o.rowtime ON o.k = dim.k where
        ``dim`` is a registered lookup table — the enrichment pattern
        (reference: StreamExecLookupJoin -> LookupJoinRunner; the
        reference's AS OF proctime instant maps to lookup-at-arrival
        here, with the left rowtime column naming the stream side)."""
        from flink_tpu_torch.connectors.lookup import LookupJoinOperator

        fn, r_columns, cache_size, cache_ttl_ms = \
            self.t_env._lookup_tables[join.right.name]
        left = self._plan_table_ref(join.left)
        if left.upsert_keys is not None:
            raise PlanError(
                "lookup join over an updating (changelog) input is not "
                "supported — the stream side must be insert-only")
        l_aliases = self._collect_aliases(join.left)
        r_alias = join.right.alias or join.right.name
        left_outer = join.kind == "LEFT"
        # the AS OF instant must be the stream side's time attribute
        # (the reference requires a proctime attribute; here the left
        # rowtime column names the lookup-at-arrival instant)
        as_of = self._strip(join.temporal, left, l_aliases)
        if left.time_field is None or not isinstance(as_of, Column) \
                or as_of.name != left.time_field:
            raise PlanError(
                "lookup join FOR SYSTEM_TIME AS OF must reference the "
                "stream side's event-time column "
                f"({left.time_field!r})")
        # the ON clause: exactly one equality between a left column and
        # the lookup table's key column
        conjuncts = _split_conjuncts(join.condition)
        if len(conjuncts) != 1 or not (
                isinstance(conjuncts[0], BinaryOp)
                and conjuncts[0].op == "="):
            raise PlanError(
                "lookup join requires exactly one equality predicate "
                "(left_col = dim_key)")
        eq = conjuncts[0]

        def _unqualify(e: Expr) -> Optional[Column]:
            if not isinstance(e, Column):
                return None
            return Column(e.name)

        sides = {}
        for e in (eq.left, eq.right):
            c = _unqualify(e)
            if c is None:
                raise PlanError(
                    "lookup join ON sides must be plain columns")
            q = e.table
            if q == r_alias or (q is None and c.name in r_columns
                                and c.name not in left.columns):
                sides["r"] = c
            else:
                sides["l"] = c
        if set(sides) != {"l", "r"}:
            raise PlanError(
                "lookup join ON must equate a stream column with the "
                "lookup table's key column")
        if sides["r"].name != fn.key_column:
            raise PlanError(
                f"lookup table {join.right.name!r} is keyed by "
                f"{fn.key_column!r}; ON references {sides['r'].name!r}")
        key_field = sides["l"].name
        if key_field not in left.columns:
            raise PlanError(
                f"lookup join key {key_field!r} is not a column of the "
                "stream side")
        t = Transformation(
            name="sql_lookup_join", kind="one_input",
            operator_factory=lambda: LookupJoinOperator(
                fn, key_field, right_columns=r_columns,
                suffixes=("_l", "_r"),
                cache_size=cache_size, cache_ttl_ms=cache_ttl_ms,
                left_outer=left_outer),
            inputs=[left.stream.transformation])
        joined = DataStream(self.env, t)
        out_cols: List[str] = []
        for c in left.columns:
            out_cols.append(c + "_l" if c in r_columns else c)
        for c in r_columns:
            out_cols.append(c + "_r" if c in left.columns else c)
        return PlannedTable(joined, out_cols, None,
                            left.time_field
                            if left.time_field in out_cols else None)

    def _lower_keyed_join(self, left: PlannedTable, right: PlannedTable,
                          l_aliases, r_aliases,
                          equi: List[Tuple[Expr, Expr]],
                          residual: List[Expr], op_factory,
                          name: str) -> PlannedTable:
        """Shared two-input keyed-join lowering: key both sides on the
        equi columns, wire the operator, suffix colliding output
        columns, and apply non-equi conjuncts as a post-filter."""
        l_stream = self._key_for_join(left, [l for l, _ in equi])
        r_stream = self._key_for_join(right, [r for _, r in equi])
        t = Transformation(
            name=name, kind="two_input", operator_factory=op_factory,
            inputs=[l_stream.transformation, r_stream.transformation],
            keyed=True)
        joined = DataStream(self.env, t)

        out_cols: List[str] = []
        for c in left.columns:
            out_cols.append(c + "_l" if c in right.columns else c)
        for c in right.columns:
            out_cols.append(c + "_r" if c in left.columns else c)

        if residual:
            # on an alias collision (self-join without aliases) the left
            # mapping wins, matching the historical behavior
            aliases = {k: "_r" for k in r_aliases}
            aliases.update({k: "_l" for k in l_aliases})
            res = [self._resolve(c, out_cols, aliases) for c in residual]

            def res_filter(batch, res=tuple(res)):
                mask = np.ones(len(batch), dtype=bool)
                for e in res:
                    mask &= np.asarray(e.eval(batch)).astype(bool)
                return mask

            joined = joined.filter(res_filter, name=f"{name}_residual")
        return PlannedTable(joined, out_cols, None, None)

    def _plan_temporal_join(self, join: ast.Join) -> PlannedTable:
        """JOIN versioned FOR SYSTEM_TIME AS OF left.rowtime ON k = k —
        each left row joins the right VERSION valid at its event time
        (reference: StreamExecTemporalJoin ->
        TemporalRowTimeJoinOperator; the right side is a versioned
        stream: its rows are versions keyed by the join key, versioned
        by their rowtime)."""
        from flink_tpu_torch.runtime.join_operators import TemporalJoinOperator

        if isinstance(join.right, ast.NamedTable) and \
                join.right.name in self.t_env._lookup_tables:
            return self._plan_lookup_join(join)
        if join.kind != "INNER":
            raise PlanError(
                "temporal join supports INNER only (the reference "
                "default); LEFT temporal join is not supported yet")
        left = self._plan_table_ref(join.left)
        right = self._plan_table_ref(join.right)
        if left.upsert_keys is not None or right.upsert_keys is not None:
            raise PlanError(
                "temporal join inputs must be insert-only streams")
        if left.time_field is None or right.time_field is None:
            raise PlanError(
                "temporal join requires event-time (WATERMARK) on both "
                "sides: the left drives the as-of instant, the right's "
                "rowtime versions its rows")
        l_aliases = self._collect_aliases(join.left)
        r_aliases = self._collect_aliases(join.right)
        # the AS OF expression must be the LEFT side's rowtime
        as_of = join.temporal
        as_of_side = self._side_of(as_of, left, right,
                                   l_aliases, r_aliases)
        as_of_col = self._strip(as_of, left, l_aliases)
        if as_of_side != "l" or not isinstance(as_of_col, Column) \
                or as_of_col.name != left.time_field:
            raise PlanError(
                "FOR SYSTEM_TIME AS OF must reference the left input's "
                f"event-time column ({left.time_field!r})")
        conjuncts = _split_conjuncts(join.condition)
        equi: List[Tuple[Expr, Expr]] = []
        residual: List[Expr] = []
        for c in conjuncts:
            pair = self._match_equi(c, left, right, l_aliases, r_aliases)
            if pair is not None:
                equi.append(pair)
            else:
                residual.append(c)
        if not equi:
            raise PlanError(
                "temporal join requires an equality predicate on the "
                "version key")
        return self._lower_keyed_join(
            left, right, l_aliases, r_aliases, equi, residual,
            lambda: TemporalJoinOperator(suffixes=("_l", "_r")),
            "sql_temporal_join")

    def _side_of(self, expr: Expr, left: PlannedTable, right: PlannedTable,
                 l_aliases, r_aliases) -> Optional[str]:
        """'l' | 'r' | None (ambiguous/mixed)."""
        sides = set()
        for node in expr.walk():
            if isinstance(node, Column):
                if node.table is not None:
                    if node.table in l_aliases:
                        sides.add("l")
                    elif node.table in r_aliases:
                        sides.add("r")
                    else:
                        return None
                else:
                    in_l = node.name in left.columns
                    in_r = node.name in right.columns
                    if in_l and not in_r:
                        sides.add("l")
                    elif in_r and not in_l:
                        sides.add("r")
                    else:
                        return None
        return sides.pop() if len(sides) == 1 else None

    def _match_equi(self, c: Expr, left, right, l_aliases, r_aliases
                    ) -> Optional[Tuple[Expr, Expr]]:
        if not (isinstance(c, BinaryOp) and c.op == "="):
            return None
        ls = self._side_of(c.left, left, right, l_aliases, r_aliases)
        rs = self._side_of(c.right, left, right, l_aliases, r_aliases)
        if ls == "l" and rs == "r":
            return (self._strip(c.left, left, l_aliases),
                    self._strip(c.right, right, r_aliases))
        if ls == "r" and rs == "l":
            return (self._strip(c.right, left, l_aliases),
                    self._strip(c.left, right, r_aliases))
        return None

    def _strip(self, expr: Expr, table: PlannedTable, aliases) -> Expr:
        return self._resolve(expr, table.columns, {k: "" for k in aliases})

    def _match_time_bound(self, c: Expr, left, right, l_aliases, r_aliases
                          ) -> Optional[Tuple[int, int]]:
        """BETWEEN over opposite-side time attributes -> (lower, upper)
        offsets for right.ts relative to left.ts."""
        if not isinstance(c, Between):
            return None
        vs = self._side_of(c.value, left, right, l_aliases, r_aliases)
        los = self._side_of(c.low, left, right, l_aliases, r_aliases)
        his = self._side_of(c.high, left, right, l_aliases, r_aliases)
        if vs is None or los != his or los is None or vs == los:
            return None
        if vs == "l":
            val_delta = self._time_delta(c.value, left, l_aliases)
            lo = self._bound_delta(c.low, right, r_aliases)
            hi = self._bound_delta(c.high, right, r_aliases)
            if None in (val_delta, lo, hi):
                return None
            # l_ts + vd in [r_ts + lo, r_ts + hi]
            # -> r_ts in [l_ts + vd - hi, l_ts + vd - lo]
            return (val_delta - hi, val_delta - lo)
        val_delta = self._time_delta(c.value, right, r_aliases)
        lo = self._bound_delta(c.low, left, l_aliases)
        hi = self._bound_delta(c.high, left, l_aliases)
        if None in (val_delta, lo, hi):
            return None
        # r_ts + vd in [l_ts + lo, l_ts + hi]
        return (lo - val_delta, hi - val_delta)

    def _bound_delta(self, expr: Expr, table, aliases) -> Optional[int]:
        """Resolve `time_attr +- literal` to an offset vs the side's __ts__."""
        if isinstance(expr, BinaryOp) and expr.op in ("+", "-"):
            if isinstance(expr.right, Literal):
                base = self._time_delta(expr.left, table, aliases)
                if base is None:
                    return None
                off = int(expr.right.value)
                return base + off if expr.op == "+" else base - off
        return self._time_delta(expr, table, aliases)

    def _time_delta(self, expr: Expr, table: PlannedTable, aliases
                    ) -> Optional[int]:
        e = self._strip(expr, table, aliases)
        if isinstance(e, Column):
            if table.time_field is not None and e.name == table.time_field:
                return 1 if e.name == WINDOW_END_FIELD else 0
            if e.name == WINDOW_END_FIELD:
                # window results carry __ts__ = window_end - 1
                return 1
            if table.time_field is None:
                # trust the declared event-time column == __ts__
                return 0
        return None

    def _key_for_join(self, table: PlannedTable, key_exprs: List[Expr]
                      ) -> DataStream:
        """Key a side by the join-key expressions. Values are canonicalized
        (numerics -> float64) so that e.g. an int64 `price` joins a float32
        `maxprice` — the two sides' key hashes must agree even though column
        dtypes differ (the reference normalizes via its type system)."""
        stream = table.stream
        name = GROUP_KEY_FIELD

        def add_key(batch, exprs=tuple(key_exprs)):
            vals = []
            for e in exprs:
                v = np.asarray(e.eval(batch))
                vals.append(v.astype(np.float64)
                            if v.dtype.kind in "iufb" else v)
            if len(vals) == 1:
                return batch.with_column(name, vals[0])
            tuples = list(zip(*[v.tolist() for v in vals]))
            arr = np.empty(len(batch), dtype=object)
            arr[:] = tuples
            return batch.with_column(name, arr)

        return stream.map(add_key, name="sql_join_key").key_by(name)

    # ------------------------------------------------------------ finishing

    def _finish(self, stream: DataStream, names: List[str],
                source: PlannedTable, stmt: ast.SelectStmt) -> PlannedTable:
        planned = PlannedTable(stream, names, source.alias,
                               source.time_field
                               if source.time_field in names else None,
                               source.upsert_keys)
        return self._apply_order_limit(planned, stmt)

    def _apply_order_limit(self, planned: PlannedTable,
                           stmt: ast.SelectStmt) -> PlannedTable:
        if stmt.order_by or stmt.limit is not None:
            planned.sort_spec = [(o.expr, o.descending)
                                 for o in stmt.order_by]
            planned.limit = stmt.limit
        return planned


def _window_assigner(tvf: ast.WindowTVF):
    if tvf.kind == "TUMBLE":
        return TumblingEventTimeWindows.of(tvf.size_ms)
    if tvf.kind == "HOP":
        return SlidingEventTimeWindows.of(tvf.size_ms, tvf.slide_ms)
    if tvf.kind == "CUMULATE":
        return CumulativeEventTimeWindows(tvf.size_ms, tvf.slide_ms)
    if tvf.kind == "SESSION":
        return EventTimeSessionWindows.with_gap(tvf.size_ms)
    raise PlanError(f"unknown window kind {tvf.kind}")


# one conjunct-flattening implementation for the whole table layer
from flink_tpu_torch.table.optimizer import split_conjuncts as _split_conjuncts  # noqa: E402
