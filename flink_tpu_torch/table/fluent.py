"""Fluent (programmatic) Table API (port of
``flink_tpu/table/fluent.py``).

reference: flink-table-api-java's Table/Expressions DSL —
``table.where($("price").isGreater(10)).groupBy($("auction"))
.select($("auction"), $("price").sum().as("total"))`` and the
Tumble/Slide/Session group-window helpers (Expressions.java, Tumble.java).

Re-design: every fluent call builds the SAME AST the SQL parser produces
(flink_tpu_torch/table/sql_parser.py expressions + SelectStmt), then plans
through the one Planner — so the rule-based optimizer, retraction
semantics, window TVF translation, and rank patterns all apply
identically whether a query arrived as a string or as method calls.
``col("x")`` is the expression entry point (PyFlink's ``col``); Python
operators build BinaryOp/UnaryOp trees; ``.sum/.avg/...`` build AggCalls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from flink_tpu_torch.table import sql_parser as ast
from flink_tpu_torch.table.expressions import (
    AggCall,
    BinaryOp,
    Column,
    Expr,
    Literal,
    SelectItem,
    Star,
    UnaryOp,
)

from flink_tpu_torch.core.annotations import public_evolving


class FluentExpr:
    """Wraps an Expr with Python-operator sugar."""

    def __init__(self, expr: Expr, alias: Optional[str] = None):
        self.expr = expr
        self._alias = alias

    # -- naming --------------------------------------------------------------

    def alias(self, name: str) -> "FluentExpr":
        return FluentExpr(self.expr, name)

    #: PyFlink spelling
    def as_(self, name: str) -> "FluentExpr":
        return self.alias(name)

    def _item(self) -> SelectItem:
        return SelectItem(self.expr, self._alias)

    # -- arithmetic / comparison --------------------------------------------

    def _bin(self, op: str, other) -> "FluentExpr":
        return FluentExpr(BinaryOp(op, self.expr, _expr(other)))

    def _rbin(self, op: str, other) -> "FluentExpr":
        return FluentExpr(BinaryOp(op, _expr(other), self.expr))

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._rbin("+", o)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._rbin("-", o)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._rbin("*", o)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._rbin("/", o)

    def __mod__(self, o):
        return self._bin("%", o)

    def __rmod__(self, o):
        return self._rbin("%", o)

    def __gt__(self, o):
        return self._bin(">", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    def __lt__(self, o):
        return self._bin("<", o)

    def __le__(self, o):
        return self._bin("<=", o)

    def __eq__(self, o):  # noqa: PYI032 - DSL equality builds a predicate
        return self._bin("=", o)

    def __ne__(self, o):
        return self._bin("<>", o)

    def __and__(self, o):
        return self._bin("AND", o)

    def __or__(self, o):
        return self._bin("OR", o)

    def __invert__(self):
        return FluentExpr(UnaryOp("NOT", self.expr))

    def __neg__(self):
        return FluentExpr(UnaryOp("-", self.expr))

    __hash__ = None  # predicates are not hashable keys

    # -- ordering ------------------------------------------------------------

    def desc(self) -> "_Ordered":
        return _Ordered(self.expr, True)

    def asc(self) -> "_Ordered":
        return _Ordered(self.expr, False)

    # -- aggregates ----------------------------------------------------------

    def _agg(self, func: str) -> "FluentExpr":
        return FluentExpr(AggCall(func, self.expr))

    def sum(self) -> "FluentExpr":
        return self._agg("SUM")

    def min(self) -> "FluentExpr":
        return self._agg("MIN")

    def max(self) -> "FluentExpr":
        return self._agg("MAX")

    def avg(self) -> "FluentExpr":
        return self._agg("AVG")

    def count(self) -> "FluentExpr":
        return self._agg("COUNT")


@public_evolving
def col(name: str) -> FluentExpr:
    """Column reference (reference: Expressions.$ / pyflink col).
    ``col("L.k")`` builds a table-qualified reference, as the SQL parser
    would — required to disambiguate same-named join keys."""
    if "." in name:
        table, _, column = name.partition(".")
        return FluentExpr(Column(column, table))
    return FluentExpr(Column(name))


@public_evolving
def lit(value) -> FluentExpr:
    return FluentExpr(Literal(value))


def count_star() -> FluentExpr:
    """COUNT(*) (reference: lit(1).count / $.count)."""
    return FluentExpr(AggCall("COUNT", None))


def _expr(x) -> Expr:
    if isinstance(x, FluentExpr):
        return x.expr
    if isinstance(x, Expr):
        return x
    return Literal(x)


def _items(exprs: Sequence) -> List[SelectItem]:
    out = []
    for e in exprs:
        if isinstance(e, FluentExpr):
            out.append(e._item())
        elif isinstance(e, str):
            out.append(SelectItem(Star(), None) if e == "*"
                       else SelectItem(Column(e), None))
        else:
            out.append(SelectItem(_expr(e), None))
    return out


# ---------------------------------------------------------------------------
# group windows (reference: Tumble/Slide/Session over/on/alias builders)
# ---------------------------------------------------------------------------


class GroupWindow:
    """Immutable builder (reference: Tumble/Slide/Session builders return
    fresh objects — a shared prefix must not mutate across queries)."""

    def __init__(self, kind: str, size_ms: int,
                 slide_ms: Optional[int] = None,
                 time_col: Optional[str] = None,
                 name: Optional[str] = None):
        self.kind = kind
        self.size_ms = size_ms
        self.slide_ms = slide_ms
        self.time_col = time_col
        self._name = name

    def on(self, time_col) -> "GroupWindow":
        tc = time_col.expr.name \
            if isinstance(time_col, FluentExpr) else str(time_col)
        return GroupWindow(self.kind, self.size_ms, self.slide_ms,
                           tc, self._name)

    def alias(self, name: str) -> "GroupWindow":
        return GroupWindow(self.kind, self.size_ms, self.slide_ms,
                           self.time_col, name)


class Tumble:
    @staticmethod
    def over(size_ms: int) -> GroupWindow:
        return GroupWindow("TUMBLE", size_ms)


class Slide:
    @staticmethod
    def over(size_ms: int, every_ms: int) -> GroupWindow:
        return GroupWindow("HOP", size_ms, every_ms)


class Session:
    @staticmethod
    def with_gap(gap_ms: int) -> GroupWindow:
        return GroupWindow("SESSION", gap_ms)


# ---------------------------------------------------------------------------
# fluent table mixin — implementation of Table.select/where/group_by/...
# ---------------------------------------------------------------------------


class _InlineTable:
    """AST table ref wrapping a live Table object (the fluent API's FROM
    clause — no catalog name needed)."""

    def __init__(self, table, alias: Optional[str] = None):
        self.table = table
        self.alias = alias


def _plan(t_env, stmt: ast.SelectStmt):
    from flink_tpu_torch.table.optimizer import optimize
    from flink_tpu_torch.table.planner import Planner

    return Planner(t_env).plan_select(optimize(stmt))


class _Ordered:
    def __init__(self, expr: Expr, descending: bool):
        self.expr = expr
        self.descending = descending


def _order_items(exprs: Sequence) -> List["ast.OrderItem"]:
    out = []
    for e in exprs:
        if isinstance(e, _Ordered):
            out.append(ast.OrderItem(e.expr, e.descending))
        else:
            out.append(ast.OrderItem(_expr(
                e if not isinstance(e, str) else Column(e)), False))
    return out


class _WindowedTable:
    """Table.window(Tumble...) — awaits .group_by(...) (reference:
    WindowedTable)."""

    def __init__(self, table, window: GroupWindow):
        self._table = table
        self._window = window

    def group_by(self, *keys) -> "GroupedTable":
        plain = []
        for k in keys:
            if isinstance(k, GroupWindow):
                continue
            if isinstance(k, str) and k == self._window._name:
                continue  # the window pseudo-column: implied grouping
            if isinstance(k, FluentExpr) and isinstance(k.expr, Column) \
                    and k.expr.name == self._window._name:
                continue
            plain.append(k)
        return GroupedTable(self._table, plain, self._window)


class GroupedTable:
    """Result of Table.group_by — awaits .select(...) (reference:
    GroupedTable / WindowGroupedTable)."""

    def __init__(self, table, keys: Sequence,
                 window: Optional[GroupWindow] = None):
        self._table = table
        self._keys = list(keys)
        self._window = window

    def select(self, *exprs):
        from flink_tpu_torch.table.environment import Table

        t = self._table
        ref: ast.TableRef = t._ref()  # preserves the table's alias
        group_by: List[Expr] = []
        items = _items(exprs)
        if self._window is not None:
            w = self._window
            ref = ast.WindowTVF(w.kind, ref, w.time_col, w.size_ms,
                                w.slide_ms)
            group_by.extend([Column("window_start"), Column("window_end")])
        for k in self._keys:
            e = _expr(k if not isinstance(k, str) else Column(k))
            if isinstance(e, Column) and self._window is not None \
                    and self._window._name is not None \
                    and e.name == self._window._name:
                continue  # the window pseudo-column is the TVF grouping
            group_by.append(e)
        stmt = ast.SelectStmt(items=items, table=ref, group_by=group_by)
        return Table._from_planned(t.t_env, _plan(t.t_env, stmt))
