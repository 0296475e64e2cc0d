"""Vectorized SQL expression evaluation (port of
``flink_tpu/table/expressions.py``).

Where the reference Janino-compiles each expression into a Java class
(reference: flink-table-planner/src/main/scala/.../codegen/ExprCodeGenerator.scala),
here an expression tree evaluates directly as vectorized NumPy over the
columns of a RecordBatch — one array op per node, no per-row interpretation.
Aggregate calls (SUM/COUNT/...) are *markers*: the planner lifts them out of
the tree and maps them onto device-side AggregateFunctions
(flink_tpu_torch.windowing.aggregates); only the non-aggregate residue is evaluated
by this module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.core.records import RecordBatch

# ---------------------------------------------------------------------------
# AST nodes
# ---------------------------------------------------------------------------


class Expr:
    def eval(self, batch: RecordBatch) -> np.ndarray:
        raise NotImplementedError

    def output_name(self) -> str:
        return "expr"

    def children(self) -> Sequence["Expr"]:
        return ()

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()

    def columns_used(self) -> List[str]:
        return [n.name for n in self.walk() if isinstance(n, Column)]

    def aggregates(self) -> List["AggCall"]:
        out = []
        for n in self.walk():
            if isinstance(n, AggCall):
                out.append(n)
        return out

    def rewrite(self, mapping: Dict["Expr", "Expr"]) -> "Expr":
        """Structural replace (by equality) — used to swap AggCalls for
        Columns referencing their materialized result."""
        for k, v in mapping.items():
            if self == k:
                return v
        return self._rewrite_children(mapping)

    def _rewrite_children(self, mapping) -> "Expr":
        return self


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: Any

    def eval(self, batch):
        return np.full(len(batch), self.value)

    def output_name(self):
        return str(self.value)


@dataclasses.dataclass(frozen=True)
class Column(Expr):
    name: str
    table: Optional[str] = None  # qualifier, resolved/dropped at plan time

    def eval(self, batch):
        if self.name not in batch.columns:
            raise KeyError(
                f"column {self.name!r} not in batch columns {batch.names()}")
        return batch[self.name]

    def output_name(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Star(Expr):
    """SELECT * marker."""

    def output_name(self):
        return "*"


_BINOPS = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": np.divide,
    "%": np.mod,
    "=": np.equal,
    "<>": np.not_equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "AND": np.logical_and,
    "OR": np.logical_or,
}


@dataclasses.dataclass(frozen=True)
class BinaryOp(Expr):
    op: str
    left: Expr
    right: Expr

    def eval(self, batch):
        lv = self.left.eval(batch)
        rv = self.right.eval(batch)
        if self.op in ("=", "<>", "!=") and (
                lv.dtype == object or rv.dtype == object):
            eq = np.array([a == b for a, b in zip(lv, rv)], dtype=bool)
            return eq if self.op == "=" else ~eq
        return _BINOPS[self.op](lv, rv)

    def children(self):
        return (self.left, self.right)

    def output_name(self):
        return f"{self.left.output_name()}_{self.op}_{self.right.output_name()}"

    def _rewrite_children(self, mapping):
        return BinaryOp(self.op, self.left.rewrite(mapping),
                        self.right.rewrite(mapping))


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # 'NOT' | '-'
    operand: Expr

    def eval(self, batch):
        v = self.operand.eval(batch)
        return np.logical_not(v) if self.op == "NOT" else np.negative(v)

    def children(self):
        return (self.operand,)

    def _rewrite_children(self, mapping):
        return UnaryOp(self.op, self.operand.rewrite(mapping))


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    value: Expr
    low: Expr
    high: Expr

    def eval(self, batch):
        v = self.value.eval(batch)
        return (v >= self.low.eval(batch)) & (v <= self.high.eval(batch))

    def children(self):
        return (self.value, self.low, self.high)

    def _rewrite_children(self, mapping):
        return Between(self.value.rewrite(mapping), self.low.rewrite(mapping),
                       self.high.rewrite(mapping))


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    value: Expr
    options: Tuple[Any, ...]
    negated: bool = False

    def eval(self, batch):
        v = self.value.eval(batch)
        mask = np.isin(v, np.asarray(list(self.options)))
        return ~mask if self.negated else mask

    def children(self):
        return (self.value,)

    def _rewrite_children(self, mapping):
        return InList(self.value.rewrite(mapping), self.options, self.negated)


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE d END — vectorized np.select."""

    whens: Tuple[Tuple[Expr, Expr], ...]
    default: Optional[Expr] = None

    def eval(self, batch):
        conds = [c.eval(batch).astype(bool) for c, _ in self.whens]
        vals = [v.eval(batch) for _, v in self.whens]
        default = (self.default.eval(batch) if self.default is not None
                   else np.zeros(len(batch)))
        return np.select(conds, vals, default)

    def children(self):
        return tuple(e for pair in self.whens for e in pair) + (
            (self.default,) if self.default is not None else ())

    def _rewrite_children(self, mapping):
        return Case(
            tuple((c.rewrite(mapping), v.rewrite(mapping))
                  for c, v in self.whens),
            self.default.rewrite(mapping) if self.default is not None
            else None)


def _scalar_fn(name: str):
    return {
        "ABS": np.abs,
        "FLOOR": np.floor,
        "CEIL": np.ceil,
        "CEILING": np.ceil,
        "SQRT": np.sqrt,
        "LN": np.log,
        "EXP": np.exp,
        "LOWER": lambda a: np.array([s.lower() for s in a], dtype=object),
        "UPPER": lambda a: np.array([s.upper() for s in a], dtype=object),
        "CHAR_LENGTH": lambda a: np.array([len(s) for s in a], dtype=np.int64),
    }.get(name)


@dataclasses.dataclass(frozen=True)
class ScalarFunc(Expr):
    name: str
    args: Tuple[Expr, ...]

    def eval(self, batch):
        if self.name == "MOD":
            return np.mod(self.args[0].eval(batch), self.args[1].eval(batch))
        if self.name == "POWER":
            return np.power(self.args[0].eval(batch), self.args[1].eval(batch))
        if self.name == "CONCAT":
            parts = [self.args[0].eval(batch).astype(object)]
            for a in self.args[1:]:
                parts.append(a.eval(batch).astype(object))
            out = parts[0]
            for p in parts[1:]:
                out = np.array([str(x) + str(y) for x, y in zip(out, p)],
                               dtype=object)
            return out
        fn = _scalar_fn(self.name)
        if fn is None:
            raise ValueError(f"unknown scalar function {self.name}")
        return fn(self.args[0].eval(batch))

    def children(self):
        return self.args

    def output_name(self):
        return self.name.lower()

    def _rewrite_children(self, mapping):
        return ScalarFunc(self.name,
                          tuple(a.rewrite(mapping) for a in self.args))


_CAST_DTYPES = {
    "INT": np.int32, "INTEGER": np.int32, "BIGINT": np.int64,
    "FLOAT": np.float32, "DOUBLE": np.float64, "REAL": np.float32,
    "SMALLINT": np.int16, "TINYINT": np.int8, "BOOLEAN": np.bool_,
    "VARCHAR": object, "STRING": object, "CHAR": object,
}


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    type_name: str

    def eval(self, batch):
        v = self.operand.eval(batch)
        dt = _CAST_DTYPES[self.type_name]
        if dt is object:
            return np.array([str(x) for x in v], dtype=object)
        return v.astype(dt)

    def children(self):
        return (self.operand,)

    def output_name(self):
        return self.operand.output_name()

    def _rewrite_children(self, mapping):
        return Cast(self.operand.rewrite(mapping), self.type_name)


AGG_NAMES = ("COUNT", "SUM", "MIN", "MAX", "AVG")


@dataclasses.dataclass(frozen=True)
class AggCall(Expr):
    """Aggregate marker — never evaluated directly; the planner maps it to a
    device AggregateFunction and replaces it with a Column over the result."""

    func: str                      # one of AGG_NAMES
    arg: Optional[Expr] = None     # None for COUNT(*)
    distinct: bool = False

    def eval(self, batch):
        raise RuntimeError(
            f"{self.func}(...) must be planned as an aggregation, "
            "not evaluated row-wise")

    def children(self):
        return (self.arg,) if self.arg is not None else ()

    def output_name(self):
        if self.arg is None:
            return self.func.lower()
        return f"{self.func.lower()}_{self.arg.output_name()}"


@dataclasses.dataclass(frozen=True)
class OverCall(Expr):
    """ROW_NUMBER()/RANK() OVER (PARTITION BY ... ORDER BY ...) — planned as
    a RankOperator (reference: flink-table-runtime rank operators)."""

    func: str                          # ROW_NUMBER | RANK
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[Tuple[Expr, bool], ...]  # (expr, descending)

    def eval(self, batch):
        raise RuntimeError("OVER window must be planned, not evaluated")

    def children(self):
        return self.partition_by + tuple(e for e, _ in self.order_by)

    def output_name(self):
        return self.func.lower()


@dataclasses.dataclass(frozen=True)
class OverAgg(Expr):
    """agg(x) OVER (PARTITION BY k ORDER BY rowtime ROWS|RANGE BETWEEN n
    PRECEDING AND CURRENT ROW) — planned as an OverAggOperator
    (reference: StreamExecOverAggregate -> RowTimeRowsBoundedPrecedingFunction
    and friends in flink-table-runtime/.../over/)."""

    func: str                          # one of AGG_NAMES
    arg: Optional[Expr]                # None for COUNT(*)
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[Tuple[Expr, bool], ...]  # (expr, descending)
    mode: str = "ROWS"                 # ROWS | RANGE
    #: frame reach before the current row: row count (ROWS) or
    #: milliseconds (RANGE); None = UNBOUNDED PRECEDING
    preceding: Optional[int] = None

    def eval(self, batch):
        raise RuntimeError("OVER window must be planned, not evaluated")

    def children(self):
        out = tuple(self.partition_by) + tuple(
            e for e, _ in self.order_by)
        return out + ((self.arg,) if self.arg is not None else ())

    def aggregates(self):
        # an OVER aggregate is NOT a grouping aggregate — it adds a
        # column per input row (the planner routes it separately)
        return []

    def output_name(self):
        base = (self.func.lower() if self.arg is None
                else f"{self.func.lower()}_{self.arg.output_name()}")
        return f"{base}_over"


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None

    @property
    def name(self) -> str:
        return self.alias or self.expr.output_name()
