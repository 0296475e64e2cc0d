"""EXPLAIN renderer: optimized logical plan + chained physical plan
(port of ``flink_tpu/table/explain.py``).

reference: TableEnvironment.explainSql — Calcite's AST / optimized rel
plan / physical execution plan sections. Here the logical section is the
optimizer's output rendered back to SQL-ish text, and the physical
section is the chained JobGraph (graph/job_graph.py) the query's stream
would execute as.
"""

from __future__ import annotations

from typing import List

from flink_tpu_torch.table import sql_parser as ast
from flink_tpu_torch.table.expressions import (
    AggCall,
    Between,
    BinaryOp,
    Case,
    Cast,
    Column,
    Expr,
    InList,
    Literal,
    OverCall,
    ScalarFunc,
    Star,
    UnaryOp,
)


def render_expr(e: Expr) -> str:
    if isinstance(e, Column):
        return f"{e.table}.{e.name}" if e.table else e.name
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, Star):
        return "*"
    if isinstance(e, BinaryOp):
        return f"({render_expr(e.left)} {e.op} {render_expr(e.right)})"
    if isinstance(e, UnaryOp):
        return f"({e.op} {render_expr(e.operand)})"
    if isinstance(e, Between):
        return (f"({render_expr(e.value)} BETWEEN "
                f"{render_expr(e.low)} AND {render_expr(e.high)})")
    if isinstance(e, InList):
        inner = ", ".join(repr(o) for o in e.options)
        neg = "NOT " if e.negated else ""
        return f"({render_expr(e.value)} {neg}IN ({inner}))"
    if isinstance(e, AggCall):
        arg = render_expr(e.arg) if e.arg is not None else "*"
        d = "DISTINCT " if e.distinct else ""
        return f"{e.func}({d}{arg})"
    if isinstance(e, OverCall):
        parts = []
        if e.partition_by:
            parts.append("PARTITION BY " + ", ".join(
                render_expr(x) for x in e.partition_by))
        if e.order_by:
            parts.append("ORDER BY " + ", ".join(
                render_expr(x) + (" DESC" if desc else "")
                for x, desc in e.order_by))
        return f"{e.func}() OVER ({' '.join(parts)})"
    if isinstance(e, ScalarFunc):
        return f"{e.name}({', '.join(render_expr(a) for a in e.args)})"
    if isinstance(e, Cast):
        return f"CAST({render_expr(e.operand)} AS {e.type_name})"
    if isinstance(e, Case):
        parts = ["CASE"]
        for c, v in e.whens:
            parts.append(f"WHEN {render_expr(c)} THEN {render_expr(v)}")
        if e.default is not None:
            parts.append(f"ELSE {render_expr(e.default)}")
        parts.append("END")
        return " ".join(parts)
    return repr(e)


def _render_ref(ref, indent: str) -> List[str]:
    if isinstance(ref, ast.NamedTable):
        alias = f" AS {ref.alias}" if ref.alias else ""
        return [f"{indent}{ref.name}{alias}"]
    if isinstance(ref, ast.SubQuery):
        out = [f"{indent}({ref.alias or 'subquery'}):"]
        out.extend(render_stmt(ref.query, indent + "  "))
        return out
    if isinstance(ref, ast.WindowTVF):
        head = (f"{indent}{ref.kind}(time_col={ref.time_col}, "
                f"size={ref.size_ms}ms"
                + (f", slide={ref.slide_ms}ms" if ref.slide_ms else "")
                + ") over:")
        return [head] + _render_ref(ref.table, indent + "  ")
    if isinstance(ref, ast.Join):
        out = [f"{indent}{ref.kind} JOIN ON "
               f"{render_expr(ref.condition)}:"]
        out.extend(_render_ref(ref.left, indent + "  "))
        out.extend(_render_ref(ref.right, indent + "  "))
        return out
    if isinstance(ref, ast.MLPredictTVF):
        return ([f"{indent}ML_PREDICT(model={ref.model}, "
                 f"on={ref.fields}) over:"]
                + _render_ref(ref.table, indent + "  "))
    table = getattr(ref, "table", None)
    if table is not None and hasattr(table, "columns"):  # fluent inline
        return [f"{indent}<inline table {table.columns}>"]
    return [f"{indent}{ref!r}"]


def render_stmt(stmt, indent: str = "") -> List[str]:
    if isinstance(stmt, ast.UnionAll):
        out = [f"{indent}UNION ALL:"]
        for s in stmt.selects:
            out.extend(render_stmt(s, indent + "  "))
        if stmt.order_by:
            out.append(f"{indent}ORDER BY " + ", ".join(
                render_expr(o.expr) + (" DESC" if o.descending else "")
                for o in stmt.order_by))
        if stmt.limit is not None:
            out.append(f"{indent}LIMIT {stmt.limit}")
        return out
    out = [indent + "SELECT "
           + ("DISTINCT " if stmt.distinct else "")
           + ", ".join(
               render_expr(i.expr) + (f" AS {i.alias}" if i.alias else "")
               for i in stmt.items)]
    out.append(f"{indent}FROM")
    out.extend(_render_ref(stmt.table, indent + "  "))
    if stmt.where is not None:
        out.append(f"{indent}WHERE {render_expr(stmt.where)}")
    if stmt.group_by:
        out.append(f"{indent}GROUP BY " + ", ".join(
            render_expr(g) for g in stmt.group_by))
    if stmt.having is not None:
        out.append(f"{indent}HAVING {render_expr(stmt.having)}")
    if stmt.order_by:
        out.append(f"{indent}ORDER BY " + ", ".join(
            render_expr(o.expr) + (" DESC" if o.descending else "")
            for o in stmt.order_by))
    if stmt.limit is not None:
        out.append(f"{indent}LIMIT {stmt.limit}")
    return out


def explain(t_env, optimized_stmt, planned) -> str:
    """The EXPLAIN text: optimized logical plan + chained physical plan
    of the planned stream."""
    from flink_tpu_torch.graph.job_graph import build_job_graph
    from flink_tpu_torch.graph.transformations import StreamGraph

    lines = ["== Optimized Logical Plan =="]
    lines.extend(render_stmt(optimized_stmt))
    lines.append("")
    lines.append("== Physical Plan (chained job graph) ==")
    graph = StreamGraph([planned.stream.transformation])
    jg = build_job_graph(
        graph, default_parallelism=t_env.env.parallelism
        if hasattr(t_env.env, "parallelism") else 1)
    for v in jg.vertices:
        lines.append(f"vertex {v.vid} (parallelism {v.parallelism}): "
                     f"{v.name}")
    for e in jg.edges:
        key = f" key={e.key_field}" if e.key_field else ""
        lines.append(f"  {e.source_vid} -> {e.target_vid} "
                     f"[{e.ship}{key}]")
    if planned.sort_spec or planned.limit is not None:
        deco = []
        if planned.sort_spec:
            deco.append("sort=" + ", ".join(
                render_expr(x) + (" DESC" if d else "")
                for x, d in planned.sort_spec))
        if planned.limit is not None:
            deco.append(f"limit={planned.limit}")
        lines.append("materialization: " + "; ".join(deco))
    return "\n".join(lines)
