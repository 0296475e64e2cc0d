"""Rule-based logical optimizer over the SQL AST (port of
``flink_tpu/table/optimizer.py``).

reference: the Calcite rule sets the reference's planner applies before
translation (flink-table-planner/.../plan/rules/FlinkStreamRuleSets.scala —
CoreRules.FILTER_INTO_JOIN, FILTER_PROJECT_TRANSPOSE / FlinkFilterJoinRule,
constant reduction via ReduceExpressionsRule). The re-design keeps the
same shape at a fraction of the machinery: a handful of AST -> AST rewrite
rules applied bottom-up until fixpoint, feeding the direct translator
(flink_tpu_torch/table/planner.py).

Rules:
- **constant folding** — Literal-only subtrees collapse (1 + 2 -> 3,
  TRUE AND p -> p, FALSE AND p -> FALSE), shrinking per-batch expression
  evaluation to what actually depends on data.
- **filter pushdown into joins** — WHERE conjuncts whose columns are all
  qualified to one join side move below the join (both sides for INNER,
  only the preserved side for LEFT: filtering the null-supplying side
  above vs below a LEFT join differ). Join state is the dominant memory
  cost of the streaming equi-join; filtering before buffering shrinks it.
- **filter pushdown into subqueries** — a predicate over a non-aggregating
  subquery moves inside it (columns substituted through the inner select
  list), so it runs before whatever the subquery buffers downstream.

All rules are semantics-preserving for the streaming subset the planner
accepts; anything the rules cannot prove is left where it was.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from flink_tpu_torch.table import sql_parser as ast
from flink_tpu_torch.table.expressions import (
    Between,
    BinaryOp,
    Case,
    Cast,
    Column,
    Expr,
    InList,
    Literal,
    ScalarFunc,
    SelectItem,
    Star,
    UnaryOp,
)

# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

_FOLD_BIN = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _is_lit(e: Expr, value=None) -> bool:
    if not isinstance(e, Literal):
        return False
    if value is None:
        return True
    # Boolean identities must only match genuine booleans: Python's 1 == True
    # would otherwise fold integer-in-boolean-context SQL (WHERE 1 AND p)
    # that the unfolded path evaluates differently (or rejects).
    if isinstance(value, bool) and not isinstance(e.value, bool):
        return False
    return e.value == value


def fold_constants(expr: Expr) -> Expr:
    """Bottom-up constant folding + boolean identity simplification."""
    if isinstance(expr, BinaryOp):
        left = fold_constants(expr.left)
        right = fold_constants(expr.right)
        if expr.op == "AND":
            if _is_lit(left, True):
                return right
            if _is_lit(right, True):
                return left
            if _is_lit(left, False) or _is_lit(right, False):
                return Literal(False)
        elif expr.op == "OR":
            if _is_lit(left, False):
                return right
            if _is_lit(right, False):
                return left
            if _is_lit(left, True) or _is_lit(right, True):
                return Literal(True)
        elif isinstance(left, Literal) and isinstance(right, Literal) \
                and expr.op in _FOLD_BIN:
            try:
                return Literal(_FOLD_BIN[expr.op](left.value, right.value))
            except Exception:  # e.g. divide by zero: leave for runtime
                pass
        return BinaryOp(expr.op, left, right)
    if isinstance(expr, UnaryOp):
        operand = fold_constants(expr.operand)
        if isinstance(operand, Literal):
            try:  # type mismatches stay for runtime, like the BinaryOp path
                if expr.op == "NOT":
                    return Literal(not operand.value)
                if expr.op == "-":
                    return Literal(-operand.value)
            except Exception:
                pass
        return UnaryOp(expr.op, operand)
    if isinstance(expr, Between):
        value = fold_constants(expr.value)
        low = fold_constants(expr.low)
        high = fold_constants(expr.high)
        if all(isinstance(e, Literal) for e in (value, low, high)):
            try:
                return Literal(low.value <= value.value <= high.value)
            except Exception:
                pass
        return Between(value, low, high)
    if isinstance(expr, InList):
        value = fold_constants(expr.value)
        if isinstance(value, Literal):
            try:
                hit = value.value in expr.options
                return Literal(not hit if expr.negated else hit)
            except Exception:
                pass
        return InList(value, expr.options, expr.negated)
    if isinstance(expr, Case):
        whens = tuple((fold_constants(c), fold_constants(v))
                      for c, v in expr.whens)
        default = fold_constants(expr.default) \
            if expr.default is not None else None
        return Case(whens, default)
    if isinstance(expr, Cast):
        return Cast(fold_constants(expr.operand), expr.type_name)
    if isinstance(expr, ScalarFunc):
        return ScalarFunc(expr.name,
                          tuple(fold_constants(a) for a in expr.args))
    return expr


# ---------------------------------------------------------------------------
# conjunct utilities
# ---------------------------------------------------------------------------


def split_conjuncts(expr: Optional[Expr]) -> List[Expr]:
    if expr is None:
        return []
    if isinstance(expr, BinaryOp) and expr.op == "AND":
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]


def and_all(conjuncts: List[Expr]) -> Optional[Expr]:
    out: Optional[Expr] = None
    for c in conjuncts:
        out = c if out is None else BinaryOp("AND", out, c)
    return out


def _ref_aliases(ref: ast.TableRef) -> List[str]:
    """The alias names under which this table ref's columns are qualified."""
    if isinstance(ref, ast.NamedTable):
        # Standard SQL scoping: an alias hides the base table name, so a
        # self-join (FROM t a JOIN t b) must not match `t.x` to either side.
        return [ref.alias] if ref.alias else [ref.name]
    if isinstance(ref, (ast.SubQuery, ast.MLPredictTVF)):
        out = [ref.alias] if ref.alias else []
        if isinstance(ref, ast.MLPredictTVF):
            out.extend(_ref_aliases(ref.table))
        return out
    if isinstance(ref, ast.WindowTVF):
        out = [ref.alias] if ref.alias else []
        out.extend(_ref_aliases(ref.table))
        return out
    return []


def _side_of_conjunct(c: Expr, left_aliases: List[str],
                      right_aliases: List[str]) -> Optional[str]:
    """'l' / 'r' when every column is qualified to exactly that side
    (unqualified columns are ambiguous -> no push)."""
    sides = set()
    for n in c.walk():
        if isinstance(n, Column):
            if n.table is None:
                return None
            if n.table in left_aliases:
                sides.add("l")
            elif n.table in right_aliases:
                sides.add("r")
            else:
                return None
    if len(sides) == 1:
        return sides.pop()
    return None


def _wrap_with_filter(ref: ast.TableRef, conjuncts: List[Expr]
                      ) -> ast.TableRef:
    """side -> SELECT * FROM side WHERE conjuncts (alias preserved so
    outer qualified references keep resolving)."""
    if isinstance(ref, ast.SubQuery) and _pushable_subquery(ref.query):
        inner = _push_into_select(ref.query, conjuncts, ref.alias)
        if inner is not None:
            return ast.SubQuery(inner, ref.alias)
    alias = ref.alias if not isinstance(ref, ast.NamedTable) \
        else (ref.alias or ref.name)
    # inner qualifiers keep working: the wrapped ref retains its own alias
    stmt = ast.SelectStmt(items=[SelectItem(Star(), None)], table=ref,
                          where=and_all(conjuncts))
    return ast.SubQuery(stmt, alias)


# ---------------------------------------------------------------------------
# filter pushdown
# ---------------------------------------------------------------------------


def _pushable_subquery(stmt: ast.SelectStmt) -> bool:
    """A subquery a predicate can safely move into: no aggregation,
    dedup, windowing, row-limiting, or OVER windows between the
    predicate's old and new positions (the rank/Top-N pattern NEEDS its
    ``rownum <= N`` filter to stay above the ROW_NUMBER subquery — that
    filter is how the planner recognizes Top-N). UNION ALL subqueries
    are left alone (pushing would have to fan the predicate out per
    branch)."""
    from flink_tpu_torch.table.expressions import OverCall

    if not isinstance(stmt, ast.SelectStmt):
        return False

    return (not stmt.group_by and not stmt.having and not stmt.distinct
            and stmt.limit is None and not stmt.order_by
            and not isinstance(stmt.table, ast.WindowTVF)
            and not any(
                i.expr.aggregates()
                or any(isinstance(n, OverCall) for n in i.expr.walk())
                for i in stmt.items if not isinstance(i.expr, Star)))


def _push_into_select(stmt: ast.SelectStmt, conjuncts: List[Expr],
                      outer_alias: Optional[str]
                      ) -> Optional[ast.SelectStmt]:
    """Rewrite predicate columns through the select list and AND them into
    the subquery's WHERE. Returns None when any column cannot be mapped."""
    mapping: Dict[str, Expr] = {}
    has_star = False
    for item in stmt.items:
        if isinstance(item.expr, Star):
            has_star = True
            continue
        name = item.alias or item.expr.output_name()
        mapping[name] = item.expr
    rewritten: List[Expr] = []
    for c in conjuncts:
        ok = True

        def sub(e: Expr) -> Expr:
            nonlocal ok
            if isinstance(e, Column):
                if e.table is not None and outer_alias is not None \
                        and e.table != outer_alias:
                    ok = False
                    return e
                if e.name in mapping:
                    return mapping[e.name]
                if has_star:
                    # passes through the star projection untouched; drop
                    # the (outer) qualifier — inner scope resolves it
                    return Column(e.name, None)
                ok = False
                return e
            if isinstance(e, BinaryOp):
                return BinaryOp(e.op, sub(e.left), sub(e.right))
            if isinstance(e, UnaryOp):
                return UnaryOp(e.op, sub(e.operand))
            if isinstance(e, Between):
                return Between(sub(e.value), sub(e.low), sub(e.high))
            if isinstance(e, InList):
                return InList(sub(e.value), e.options, e.negated)
            if isinstance(e, Cast):
                return Cast(sub(e.operand), e.type_name)
            if isinstance(e, ScalarFunc):
                return ScalarFunc(e.name, tuple(sub(a) for a in e.args))
            if isinstance(e, (Literal,)):
                return e
            ok = False  # Case/OverCall/AggCall etc.: leave outside
            return e

        r = sub(c)
        if not ok:
            return None
        rewritten.append(r)
    return dataclasses.replace(
        stmt, where=and_all(split_conjuncts(stmt.where) + rewritten))


def _optimize_select(stmt: ast.SelectStmt) -> ast.SelectStmt:
    # bottom-up: optimize nested select statements first
    table = _optimize_ref(stmt.table)
    where = fold_constants(stmt.where) if stmt.where is not None else None
    having = fold_constants(stmt.having) if stmt.having is not None else None
    items = [SelectItem(i.expr if isinstance(i.expr, Star)
                        else fold_constants(i.expr), i.alias)
             for i in stmt.items]
    if where is not None and _is_lit(where, True):
        where = None

    conjuncts = split_conjuncts(where)
    kept: List[Expr] = []

    if isinstance(table, ast.Join) and conjuncts:
        left_aliases = _ref_aliases(table.left)
        right_aliases = _ref_aliases(table.right)
        push_l: List[Expr] = []
        push_r: List[Expr] = []
        for c in conjuncts:
            side = _side_of_conjunct(c, left_aliases, right_aliases)
            if side == "l":
                push_l.append(c)
            elif side == "r" and table.kind == "INNER":
                # LEFT join: the null-supplying side's predicate must stay
                # above the join (it would drop null-extended rows anyway,
                # but pushing changes WHICH rows null-extend)
                push_r.append(c)
            else:
                kept.append(c)
        left = _wrap_with_filter(table.left, push_l) if push_l \
            else table.left
        right = _wrap_with_filter(table.right, push_r) if push_r \
            else table.right
        table = ast.Join(left, right, table.kind, table.condition,
                         temporal=table.temporal)
        where = and_all(kept)
    elif isinstance(table, ast.SubQuery) and conjuncts \
            and _pushable_subquery(table.query):
        inner = _push_into_select(table.query, conjuncts, table.alias)
        if inner is not None:
            table = ast.SubQuery(_optimize_select(inner), table.alias)
            where = None

    return dataclasses.replace(stmt, table=table, where=where,
                               having=having, items=items)


def _optimize_ref(ref: ast.TableRef) -> ast.TableRef:
    if isinstance(ref, ast.SubQuery):
        return ast.SubQuery(optimize(ref.query), ref.alias)
    if isinstance(ref, ast.Join):
        return ast.Join(_optimize_ref(ref.left), _optimize_ref(ref.right),
                        ref.kind, fold_constants(ref.condition),
                        temporal=ref.temporal)
    if isinstance(ref, ast.WindowTVF):
        return dataclasses.replace(ref, table=_optimize_ref(ref.table))
    if isinstance(ref, ast.MLPredictTVF):
        return dataclasses.replace(ref, table=_optimize_ref(ref.table))
    return ref


def optimize(stmt):
    """The planner's pre-pass: apply the rule set to fixpoint (two passes
    suffice — pushdown exposes at most one new fold opportunity layer,
    and the rules strictly shrink/sink predicates)."""
    if isinstance(stmt, ast.UnionAll):
        return dataclasses.replace(
            stmt, selects=[optimize(s) for s in stmt.selects])
    return _optimize_select(_optimize_select(stmt))
