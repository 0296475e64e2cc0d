"""A small recursive-descent SQL parser (port of
``flink_tpu/table/sql_parser.py``).

The reference parses SQL with Apache Calcite (flink-table/flink-sql-parser)
into a full relational algebra. This framework needs the *streaming SQL
subset* that the reference's headline workloads (Nexmark Q5/Q7, GROUP BY HOP)
exercise: SELECT/WHERE/GROUP BY with window TVFs (TUMBLE/HOP/CUMULATE/SESSION,
reference: flink-table-runtime/.../window/tvf/slicing/SliceAssigners.java),
joins with time bounds, Top-N via ROW_NUMBER() OVER, views and INSERT INTO.

Grammar is hand-rolled: tokens -> AST dataclasses in this file +
expression nodes from flink_tpu_torch.table.expressions.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union

from flink_tpu_torch.table.expressions import (
    AGG_NAMES,
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
    SelectItem,
    Star,
    UnaryOp,
)

# ---------------------------------------------------------------------------
# Statement AST
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowTVF:
    kind: str                 # TUMBLE | HOP | CUMULATE | SESSION
    table: "TableRef"
    time_col: str
    size_ms: int              # TUMBLE size / HOP size / CUMULATE max / SESSION gap
    slide_ms: Optional[int] = None   # HOP slide / CUMULATE step
    alias: Optional[str] = None


@dataclasses.dataclass
class NamedTable:
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass
class SubQuery:
    query: "SelectStmt"
    alias: Optional[str] = None


@dataclasses.dataclass
class Join:
    left: "TableRef"
    right: "TableRef"
    kind: str            # INNER | LEFT
    condition: Expr
    #: FOR SYSTEM_TIME AS OF <left rowtime> — an event-time TEMPORAL
    #: join against the right side's versions (reference:
    #: StreamExecTemporalJoin); None = regular join
    temporal: "Expr | None" = None


@dataclasses.dataclass
class MLPredictTVF:
    """ML_PREDICT(TABLE t, MODEL m, DESCRIPTOR(f1, f2)) — reference:
    flink-table's ML_PREDICT table function over a CatalogModel."""

    table: "TableRef"
    model: str
    fields: List[str]
    alias: Optional[str] = None


@dataclasses.dataclass
class MatchRecognize:
    """FROM t MATCH_RECOGNIZE (PARTITION BY ... ORDER BY rowtime
    MEASURES ... PATTERN (...) DEFINE ...) — reference:
    StreamExecMatch (flink-table-planner/.../stream/StreamExecMatch.java)
    lowering onto the CEP library's NFA."""

    table: "TableRef"
    partition_by: list            # column names
    order_by: "str | None"        # rowtime column
    #: (func, var, col, alias); func in FIRST/LAST/SUM/AVG/MIN/MAX/COUNT
    measures: list
    #: (var, min_times, max_times-or-None, greedy)
    pattern: list
    define: dict                  # var -> Expr (bool condition)
    after_match: str = "PAST_LAST_ROW"   # or "TO_NEXT_ROW"
    within_ms: "int | None" = None
    alias: "str | None" = None


TableRef = Union[NamedTable, SubQuery, WindowTVF, Join, MLPredictTVF,
                 MatchRecognize]


@dataclasses.dataclass
class OrderItem:
    expr: Expr
    descending: bool = False


@dataclasses.dataclass
class SelectStmt:
    items: List[SelectItem]
    table: TableRef
    where: Optional[Expr] = None
    group_by: List[Expr] = dataclasses.field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False


@dataclasses.dataclass
class UnionAll:
    """SELECT ... UNION ALL SELECT ... (reference: SqlSetOperator UNION
    ALL; UNION DISTINCT would need a global dedup over an unbounded
    stream and is rejected at parse time). A trailing ORDER BY/LIMIT
    binds to the whole union."""

    selects: List["SelectStmt"]
    order_by: List["OrderItem"] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None


@dataclasses.dataclass
class Explain:
    """EXPLAIN <query> (reference: TableEnvironment.explainSql — prints
    the optimized plan instead of executing)."""

    query: Union["SelectStmt", "UnionAll"]


@dataclasses.dataclass
class ShowTables:
    """SHOW TABLES (reference: TableEnvironment.listTables via SQL)."""


@dataclasses.dataclass
class Describe:
    """DESCRIBE <table> (reference: TableEnvironment SQL DESCRIBE)."""

    name: str


@dataclasses.dataclass
class CreateView:
    name: str
    query: SelectStmt


@dataclasses.dataclass
class CreateModel:
    """CREATE MODEL name WITH ('provider'='python', ...) — reference:
    flink-table CREATE MODEL DDL producing a CatalogModel."""

    name: str
    options: dict


@dataclasses.dataclass
class CreateTable:
    """CREATE TABLE name (col [TYPE], ..., WATERMARK FOR ts AS ts -
    INTERVAL 'n' UNIT) WITH ('connector'='...', ...) — reference:
    connector DDL resolved through the DynamicTableFactory SPI."""

    name: str
    columns: list  # of (name, type-or-None)
    options: dict
    watermark_field: "str | None" = None
    watermark_delay_ms: int = 0
    #: PRIMARY KEY (...) NOT ENFORCED — the upsert key (reference:
    #: upsert-kafka's mandatory primary key)
    primary_key: "list | None" = None


@dataclasses.dataclass
class InsertInto:
    table: str
    query: SelectStmt


Statement = Union[SelectStmt, UnionAll, Explain, ShowTables, Describe, CreateView, CreateModel, CreateTable, InsertInto]

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*|`[^`]+`)
  | (?P<op><>|!=|<=|>=|\|\||[-+*/%(),.<>={}?])
    """,
    re.VERBOSE,
)

_INTERVAL_MS = {
    "MILLISECOND": 1, "MILLISECONDS": 1,
    "SECOND": 1000, "SECONDS": 1000,
    "MINUTE": 60_000, "MINUTES": 60_000,
    "HOUR": 3_600_000, "HOURS": 3_600_000,
    "DAY": 86_400_000, "DAYS": 86_400_000,
}


@dataclasses.dataclass
class Token:
    kind: str   # num | str | ident | op | end
    value: str

    @property
    def upper(self) -> str:
        return self.value.upper()


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise SqlParseError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        value = m.group()
        if kind == "ident" and value.startswith("`"):
            value = value[1:-1]
        tokens.append(Token(kind, value))
    tokens.append(Token("end", ""))
    return tokens


class SqlParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlParseError(f"expected {kw}, got {self.peek().value!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == op:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlParseError(f"expected {op!r}, got {self.peek().value!r}")

    # -- statements ---------------------------------------------------------

    def parse_statement(self) -> Statement:
        if self.accept_kw("EXPLAIN"):
            if self.accept_kw("PLAN"):  # EXPLAIN PLAN FOR ... spelling
                self.expect_kw("FOR")
            stmt = Explain(self.parse_query())
        elif self.accept_kw("SHOW"):
            self.expect_kw("TABLES")
            stmt = ShowTables()
        elif self.accept_kw("DESCRIBE") or self.accept_kw("DESC"):
            t = self.peek()
            if t.kind != "ident":
                raise SqlParseError(
                    f"DESCRIBE expects a table name, got {t.value!r}")
            stmt = Describe(self.next().value)
        elif self.at_kw("CREATE"):
            stmt = self._create_view()
        elif self.at_kw("INSERT"):
            stmt = self._insert_into()
        else:
            stmt = self.parse_query()
        self.accept_op(";")
        if self.peek().kind != "end":
            raise SqlParseError(f"trailing input at {self.peek().value!r}")
        return stmt

    def _create_view(self) -> Statement:
        self.expect_kw("CREATE")
        self.accept_kw("TEMPORARY")
        if self.accept_kw("MODEL"):
            return self._create_model()
        if self.accept_kw("TABLE"):
            return self._create_table()
        self.expect_kw("VIEW")
        name = self.next().value
        self.expect_kw("AS")
        return CreateView(name, self.parse_query())

    def _create_table(self) -> CreateTable:
        name = self.next().value
        columns: list = []
        wm_field = None
        wm_delay = 0
        primary_key: list = []
        self.expect_op("(")
        while True:
            if self.accept_kw("PRIMARY"):
                # PRIMARY KEY (k [, ...]) NOT ENFORCED — declares the
                # upsert key (reference: upsert-kafka requires a PRIMARY
                # KEY; enforcement is impossible on a changelog, hence
                # the mandatory NOT ENFORCED)
                self.expect_kw("KEY")
                self.expect_op("(")
                while True:
                    primary_key.append(self.next().value)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                self.expect_kw("NOT")
                self.expect_kw("ENFORCED")
            elif self.accept_kw("WATERMARK"):
                self.expect_kw("FOR")
                wm_field = self.next().value
                self.expect_kw("AS")
                # accept `ts` or `ts - INTERVAL 'n' UNIT`
                ref = self.next().value
                if ref != wm_field:
                    raise SqlParseError(
                        "WATERMARK expression must reference the "
                        f"watermark column {wm_field!r}")
                if self.accept_op("-"):
                    self.expect_kw("INTERVAL")
                    t = self.next()
                    if t.kind not in ("str", "num"):
                        raise SqlParseError(
                            "INTERVAL expects a quoted amount")
                    amount = float(t.value[1:-1] if t.kind == "str"
                                   else t.value)
                    unit = self.next().upper
                    if unit not in _INTERVAL_MS:
                        raise SqlParseError(
                            f"unknown interval unit {unit!r}")
                    wm_delay = int(amount * _INTERVAL_MS[unit])
            else:
                col = self.next()
                if col.kind != "ident":
                    raise SqlParseError(
                        f"expected a column name, got {col.value!r}")
                # optional type + modifiers (BIGINT, DECIMAL(10, 2),
                # TIMESTAMP(3), NOT NULL ...): consumed and recorded but
                # not enforced — the runtime is dtype-driven
                ctype_parts = []
                while self.peek().kind == "ident":
                    ctype_parts.append(self.next().value)
                    if self.accept_op("("):
                        depth = 1
                        while depth:
                            tok = self.next()
                            if tok.kind == "op" and tok.value == "(":
                                depth += 1
                            elif tok.kind == "op" and tok.value == ")":
                                depth -= 1
                columns.append((col.value,
                                " ".join(ctype_parts) or None))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        self.expect_kw("WITH")
        self.expect_op("(")
        options = {}
        while True:
            k = self.next()
            if k.kind != "str":
                raise SqlParseError("table options are 'key' = 'value'")
            self.expect_op("=")
            v = self.next()
            if v.kind != "str":
                raise SqlParseError("table options are 'key' = 'value'")
            options[k.value[1:-1]] = v.value[1:-1]
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return CreateTable(name, columns, options,
                           watermark_field=wm_field,
                           watermark_delay_ms=wm_delay,
                           primary_key=primary_key or None)

    def _create_model(self) -> CreateModel:
        name = self.next().value
        self.expect_kw("WITH")
        self.expect_op("(")
        options = {}
        while True:
            k = self.next()
            if k.kind != "str":
                raise SqlParseError("model options are 'key' = 'value'")
            self.expect_op("=")
            v = self.next()
            if v.kind != "str":
                raise SqlParseError("model options are 'key' = 'value'")
            options[k.value[1:-1]] = v.value[1:-1]
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return CreateModel(name, options)

    def _insert_into(self) -> InsertInto:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        name = self.next().value
        return InsertInto(name, self.parse_query())

    # -- SELECT -------------------------------------------------------------

    def parse_query(self):
        """One SELECT or a UNION ALL chain."""
        first = self.parse_select()
        if not self.at_kw("UNION"):
            return first
        selects = [first]
        while self.accept_kw("UNION"):
            if not self.accept_kw("ALL"):
                raise SqlParseError(
                    "only UNION ALL is supported (UNION DISTINCT would "
                    "require a global dedup over an unbounded stream)")
            selects.append(self.parse_select())
        for s in selects[:-1]:
            if s.order_by or s.limit is not None:
                raise SqlParseError(
                    "ORDER BY / LIMIT inside a UNION branch is not "
                    "supported; place it after the last branch")
        last = selects[-1]
        order_by, limit = last.order_by, last.limit
        selects[-1] = dataclasses.replace(last, order_by=[], limit=None)
        return UnionAll(selects, order_by, limit)

    def parse_select(self) -> SelectStmt:
        self.expect_kw("SELECT")
        distinct = self.accept_kw("DISTINCT")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        self.expect_kw("FROM")
        table = self._table_ref()
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        group_by: List[Expr] = []
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.accept_kw("HAVING") else None
        order_by: List[OrderItem] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self._order_item())
            while self.accept_op(","):
                order_by.append(self._order_item())
        limit = None
        if self.accept_kw("LIMIT"):
            limit = int(self.next().value)
        return SelectStmt(items, table, where, group_by, having, order_by,
                          limit, distinct)

    def _order_item(self) -> OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("DESC"):
            desc = True
        else:
            self.accept_kw("ASC")
        return OrderItem(e, desc)

    def _select_item(self) -> SelectItem:
        if self.accept_op("*"):
            return SelectItem(Star())
        e = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.next().value
        elif (self.peek().kind == "ident"
              and self.peek().upper not in _CLAUSE_KWS):
            alias = self.next().value
        return SelectItem(e, alias)

    # -- FROM / joins -------------------------------------------------------

    def _table_ref(self) -> TableRef:
        left = self._table_primary()
        while True:
            kind = None
            if self.accept_kw("JOIN"):
                kind = "INNER"
            elif self.at_kw("INNER") and self.peek(1).upper == "JOIN":
                self.i += 2
                kind = "INNER"
            elif self.at_kw("LEFT"):
                self.i += 1
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "LEFT"
            else:
                return left
            right = self._table_primary()
            temporal = None
            if self.accept_kw("FOR"):
                # JOIN versioned FOR SYSTEM_TIME AS OF o.rowtime AS v
                self.expect_kw("SYSTEM_TIME")
                self.expect_kw("AS")
                self.expect_kw("OF")
                temporal = self.parse_expr()
                alias = self._opt_alias()
                if alias is not None:
                    if not hasattr(right, "alias"):
                        raise SqlParseError(
                            "cannot alias this temporal join input")
                    right = dataclasses.replace(right, alias=alias)
            self.expect_kw("ON")
            cond = self.parse_expr()
            left = Join(left, right, kind, cond, temporal=temporal)

    def _table_primary(self) -> TableRef:
        if self.at_kw("TABLE") and self.peek(1).value == "(":
            return self._window_tvf()
        if self.peek().upper == "ML_PREDICT" and self.peek(1).value == "(":
            return self._ml_predict_tvf()
        if self.accept_op("("):
            q = self.parse_query()
            self.expect_op(")")
            alias = self._opt_alias()
            return SubQuery(q, alias)
        name = self.next().value
        ref = NamedTable(name, self._opt_alias())
        if self.at_kw("MATCH_RECOGNIZE"):
            return self._match_recognize(ref)
        return ref

    def _match_recognize(self, table: TableRef) -> MatchRecognize:
        """MATCH_RECOGNIZE (PARTITION BY ... ORDER BY ... MEASURES ...
        [ONE ROW PER MATCH] [AFTER MATCH SKIP ...] PATTERN (...)
        [WITHIN INTERVAL ...] DEFINE ...) [AS alias]."""
        self.expect_kw("MATCH_RECOGNIZE")
        self.expect_op("(")
        partition: List[str] = []
        order = None
        measures: List[tuple] = []
        after = "PAST_LAST_ROW"
        pattern: List[tuple] = []
        define: dict = {}
        within = None
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self.next().value)
            while self.accept_op(","):
                partition.append(self.next().value)
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order = self.next().value
            self.accept_kw("ASC")
        if self.accept_kw("MEASURES"):
            while True:
                measures.append(self._measure_item())
                if not self.accept_op(","):
                    break
        if self.accept_kw("ONE"):
            self.expect_kw("ROW")
            self.expect_kw("PER")
            self.expect_kw("MATCH")
        if self.accept_kw("AFTER"):
            self.expect_kw("MATCH")
            self.expect_kw("SKIP")
            if self.accept_kw("PAST"):
                self.expect_kw("LAST")
                self.expect_kw("ROW")
                after = "PAST_LAST_ROW"
            elif self.accept_kw("TO"):
                self.expect_kw("NEXT")
                self.expect_kw("ROW")
                after = "TO_NEXT_ROW"
            else:
                raise SqlParseError(
                    "AFTER MATCH SKIP supports PAST LAST ROW / "
                    "TO NEXT ROW")
        self.expect_kw("PATTERN")
        self.expect_op("(")
        while not self.accept_op(")"):
            pattern.append(self._pattern_var())
        if self.accept_kw("WITHIN"):
            self.expect_kw("INTERVAL")
            t = self.next()
            if t.kind not in ("str", "num"):
                raise SqlParseError("INTERVAL expects a quoted amount")
            amount = float(t.value[1:-1] if t.kind == "str" else t.value)
            unit = self.next().upper
            if unit not in _INTERVAL_MS:
                raise SqlParseError(f"unknown interval unit {unit!r}")
            within = int(amount * _INTERVAL_MS[unit])
        if self.accept_kw("DEFINE"):
            while True:
                var = self.next().value
                self.expect_kw("AS")
                define[var.upper()] = self.parse_expr()
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        return MatchRecognize(table, partition, order, measures, pattern,
                              define, after_match=after,
                              within_ms=within, alias=self._opt_alias())

    def _measure_item(self) -> tuple:
        """FIRST(V.c) | LAST(V.c) | SUM/AVG/MIN/MAX/COUNT(V.c) | V.c,
        each AS alias."""
        name = self.next()
        func = "LAST"
        if name.upper in ("FIRST", "LAST", "SUM", "AVG", "MIN", "MAX",
                          "COUNT") and self.peek().value == "(":
            func = name.upper
            self.expect_op("(")
            var = self.next().value
            self.expect_op(".")
            col = self.next().value
            self.expect_op(")")
        else:
            var = name.value
            self.expect_op(".")
            col = self.next().value
        self.expect_kw("AS")
        alias = self.next().value
        return (func, var.upper(), col, alias)

    def _pattern_var(self) -> tuple:
        """A pattern variable with its quantifier: V V* V+ V? V{n} V{n,}
        V{n,m}, with a trailing '?' marking RELUCTANT (SQL row-pattern
        quantifiers are greedy by default)."""
        var = self.next()
        if var.kind != "ident":
            raise SqlParseError(
                f"expected a pattern variable, got {var.value!r}")
        mn, mx = 1, 1
        loop = False
        if self.accept_op("*"):
            mn, mx, loop = 0, None, True
        elif self.accept_op("+"):
            mn, mx, loop = 1, None, True
        elif self.accept_op("?"):
            mn, mx = 0, 1
        elif self.accept_op("{"):
            t = self.next()
            if t.kind != "num":
                raise SqlParseError("pattern quantifier expects a count")
            mn = int(float(t.value))
            mx = mn
            if self.accept_op(","):
                if self.accept_op("}"):
                    mx, loop = None, True
                else:
                    t2 = self.next()
                    if t2.kind != "num":
                        raise SqlParseError(
                            "pattern quantifier expects a count")
                    mx = int(float(t2.value))
                    # exact {n} has no take/stop freedom — greedy is
                    # meaningless (and harmful) for it
                    loop = mx != mn
                    self.expect_op("}")
            else:
                loop = False
                self.expect_op("}")
        else:
            return (var.value.upper(), 1, 1, False)
        greedy = loop
        if self.accept_op("?"):
            greedy = False  # reluctant quantifier
        return (var.value.upper(), mn, mx, greedy)

    def _opt_alias(self) -> Optional[str]:
        if self.accept_kw("AS"):
            return self.next().value
        if (self.peek().kind == "ident"
                and self.peek().upper not in _CLAUSE_KWS):
            return self.next().value
        return None

    def _window_tvf(self) -> WindowTVF:
        self.expect_kw("TABLE")
        self.expect_op("(")
        kind = self.next().upper
        if kind not in ("TUMBLE", "HOP", "CUMULATE", "SESSION"):
            raise SqlParseError(f"unknown window TVF {kind}")
        self.expect_op("(")
        # positional `TABLE t` or named `DATA => TABLE t`
        if self.accept_kw("DATA"):
            self.expect_op("=")
            self.expect_op(">")
        self.expect_kw("TABLE")
        inner = NamedTable(self.next().value)
        self.expect_op(",")
        self.expect_kw("DESCRIPTOR")
        self.expect_op("(")
        time_col = self.next().value
        self.expect_op(")")
        self.expect_op(",")
        first = self._interval_ms()
        second = None
        if self.accept_op(","):
            second = self._interval_ms()
        self.expect_op(")")
        self.expect_op(")")
        alias = self._opt_alias()
        # argument order per the reference's TVF definitions:
        # HOP(data, desc, slide, size); CUMULATE(data, desc, step, max)
        if kind in ("HOP", "CUMULATE"):
            if second is None:
                raise SqlParseError(f"{kind} needs two intervals")
            slide, size = first, second
            return WindowTVF(kind, inner, time_col, size, slide, alias)
        return WindowTVF(kind, inner, time_col, first, None, alias)

    def _named_arg(self, *names: str) -> None:
        """Consume an optional ``NAME =>`` prefix (reference: ML_PREDICT's
        INPUT/DATA, MODEL, ARGS named arguments)."""
        if self.peek().upper in names and self.peek(1).value == "=":
            self.next()
            self.expect_op("=")
            self.expect_op(">")

    def _ml_predict_tvf(self) -> MLPredictTVF:
        """ML_PREDICT([INPUT|DATA =>] TABLE t, [MODEL =>] MODEL? m,
        [ARGS =>] DESCRIPTOR(f1, f2, ...))."""
        self.next()  # ML_PREDICT
        self.expect_op("(")
        self._named_arg("INPUT", "DATA")
        self.expect_kw("TABLE")
        inner: TableRef
        if self.accept_op("("):
            q = self.parse_select()
            self.expect_op(")")
            inner = SubQuery(q)
        else:
            inner = NamedTable(self.next().value)
        self.expect_op(",")
        # named form `MODEL => m` has no second MODEL keyword; positional
        # form is `MODEL m`
        if self.peek().upper == "MODEL" and self.peek(1).value == "=":
            self._named_arg("MODEL")
        else:
            self.expect_kw("MODEL")
        model = self.next().value
        self.expect_op(",")
        self._named_arg("ARGS")
        self.expect_kw("DESCRIPTOR")
        self.expect_op("(")
        fields = [self.next().value]
        while self.accept_op(","):
            fields.append(self.next().value)
        self.expect_op(")")
        self.expect_op(")")
        return MLPredictTVF(inner, model, fields, self._opt_alias())

    def _interval_ms(self) -> int:
        self.expect_kw("INTERVAL")
        tok = self.next()
        if tok.kind != "str":
            raise SqlParseError("INTERVAL value must be a quoted string")
        amount = float(tok.value[1:-1])
        unit = self.next().upper
        if unit not in _INTERVAL_MS:
            raise SqlParseError(f"unknown interval unit {unit}")
        return int(amount * _INTERVAL_MS[unit])

    # -- expressions (precedence climbing) ----------------------------------

    def parse_expr(self) -> Expr:
        return self._or_expr()

    def _or_expr(self) -> Expr:
        e = self._and_expr()
        while self.accept_kw("OR"):
            e = BinaryOp("OR", e, self._and_expr())
        return e

    def _and_expr(self) -> Expr:
        e = self._not_expr()
        while self.accept_kw("AND"):
            e = BinaryOp("AND", e, self._not_expr())
        return e

    def _not_expr(self) -> Expr:
        if self.accept_kw("NOT"):
            return UnaryOp("NOT", self._not_expr())
        return self._comparison()

    def _comparison(self) -> Expr:
        e = self._additive()
        if self.accept_kw("BETWEEN"):
            low = self._additive()
            self.expect_kw("AND")
            return Between(e, low, self._additive())
        if self.accept_kw("IN") or (self.at_kw("NOT")
                                    and self.peek(1).upper == "IN"):
            negated = False
            if self.at_kw("IN"):
                self.i += 1
            else:
                self.i += 2
                negated = True
            self.expect_op("(")
            opts = [self._literal_value()]
            while self.accept_op(","):
                opts.append(self._literal_value())
            self.expect_op(")")
            return InList(e, tuple(opts), negated)
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            return BinaryOp(t.value, e, self._additive())
        return e

    def _literal_value(self):
        t = self.next()
        if t.kind == "num":
            return float(t.value) if "." in t.value else int(t.value)
        if t.kind == "str":
            return t.value[1:-1].replace("''", "'")
        raise SqlParseError(f"expected literal, got {t.value!r}")

    def _additive(self) -> Expr:
        e = self._multiplicative()
        while True:
            if self.accept_op("+"):
                e = BinaryOp("+", e, self._multiplicative())
            elif self.accept_op("-"):
                e = BinaryOp("-", e, self._multiplicative())
            else:
                return e

    def _multiplicative(self) -> Expr:
        e = self._unary()
        while True:
            if self.accept_op("*"):
                e = BinaryOp("*", e, self._unary())
            elif self.accept_op("/"):
                e = BinaryOp("/", e, self._unary())
            elif self.accept_op("%"):
                e = BinaryOp("%", e, self._unary())
            else:
                return e

    def _unary(self) -> Expr:
        if self.accept_op("-"):
            return UnaryOp("-", self._unary())
        return self._primary()

    def _primary(self) -> Expr:
        t = self.peek()
        if t.kind == "num":
            self.next()
            v = float(t.value) if ("." in t.value or "e" in t.value.lower()) \
                else int(t.value)
            return Literal(v)
        if t.kind == "str":
            self.next()
            return Literal(t.value[1:-1].replace("''", "'"))
        if t.kind == "op" and t.value == "(":
            self.next()
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if self.at_kw("INTERVAL"):
            return Literal(self._interval_ms())
        if self.at_kw("CASE"):
            return self._case_expr()
        if self.at_kw("CAST"):
            self.next()
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_kw("AS")
            type_name = self.next().upper
            # swallow precision like VARCHAR(255)
            if self.accept_op("("):
                while not self.accept_op(")"):
                    self.next()
            self.expect_op(")")
            return Cast(inner, type_name)
        if self.at_kw("TRUE"):
            self.next()
            return Literal(True)
        if self.at_kw("FALSE"):
            self.next()
            return Literal(False)
        if t.kind == "ident":
            return self._identifier_or_call()
        raise SqlParseError(f"unexpected token {t.value!r}")

    def _case_expr(self) -> Case:
        self.expect_kw("CASE")
        whens = []
        while self.accept_kw("WHEN"):
            c = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((c, self.parse_expr()))
        default = self.parse_expr() if self.accept_kw("ELSE") else None
        self.expect_kw("END")
        return Case(tuple(whens), default)

    def _identifier_or_call(self) -> Expr:
        name = self.next().value
        upper = name.upper()
        if self.peek().kind == "op" and self.peek().value == "(":
            self.next()  # (
            if upper in AGG_NAMES:
                distinct = self.accept_kw("DISTINCT")
                if self.accept_op("*"):
                    self.expect_op(")")
                    arg = None
                else:
                    arg = self.parse_expr()
                    self.expect_op(")")
                if self.at_kw("OVER"):
                    if distinct:
                        raise SqlParseError(
                            "DISTINCT is not supported in OVER "
                            "aggregates")
                    return self._over_agg_clause(upper, arg)
                return AggCall(upper, arg, distinct)
            if upper in ("ROW_NUMBER", "RANK"):
                self.expect_op(")")
                return self._over_clause(upper)
            args = []
            if not self.accept_op(")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
                self.expect_op(")")
            return ScalarFunc(upper, tuple(args))
        if self.accept_op("."):
            col = self.next().value
            return Column(col, table=name)
        return Column(name)

    def _partition_order(self):
        """The shared OVER-window prefix: PARTITION BY ... ORDER BY ...
        (caller has consumed OVER and the opening paren)."""
        partition: List[Expr] = []
        order: List[Tuple[Expr, bool]] = []
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept_kw("DESC"):
                    desc = True
                else:
                    self.accept_kw("ASC")
                order.append((e, desc))
                if not self.accept_op(","):
                    break
        return tuple(partition), tuple(order)

    def _over_clause(self, func: str) -> OverCall:
        self.expect_kw("OVER")
        self.expect_op("(")
        partition, order = self._partition_order()
        self.expect_op(")")
        return OverCall(func, partition, order)

    def _over_agg_clause(self, func: str, arg):
        """agg(x) OVER (PARTITION BY ... ORDER BY rowtime
        [ROWS|RANGE BETWEEN <n | INTERVAL 'x' UNIT | UNBOUNDED>
        PRECEDING AND CURRENT ROW]) — reference:
        StreamExecOverAggregate. No frame clause = RANGE UNBOUNDED
        PRECEDING (the SQL default)."""
        from flink_tpu_torch.table.expressions import OverAgg

        self.expect_kw("OVER")
        self.expect_op("(")
        partition, order = self._partition_order()
        mode, preceding = "RANGE", None
        if self.at_kw("ROWS", "RANGE"):
            mode = self.next().upper
            self.expect_kw("BETWEEN")
            if self.accept_kw("UNBOUNDED"):
                preceding = None
            elif mode == "ROWS":
                t = self.next()
                if t.kind != "num" or not float(t.value).is_integer():
                    raise SqlParseError(
                        "ROWS BETWEEN expects a whole row count, got "
                        f"{t.value!r}")
                preceding = int(float(t.value))
            else:
                self.expect_kw("INTERVAL")
                t = self.next()
                if t.kind not in ("str", "num"):
                    raise SqlParseError("INTERVAL expects a quoted amount")
                amount = float(t.value[1:-1] if t.kind == "str"
                               else t.value)
                unit = self.next().upper
                if unit not in _INTERVAL_MS:
                    raise SqlParseError(
                        f"unknown interval unit {unit!r}")
                preceding = int(amount * _INTERVAL_MS[unit])
            self.expect_kw("PRECEDING")
            self.expect_kw("AND")
            self.expect_kw("CURRENT")
            self.expect_kw("ROW")
        self.expect_op(")")
        return OverAgg(func, arg, partition, order,
                       mode=mode, preceding=preceding)


_CLAUSE_KWS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "JOIN", "INNER",
    "LEFT", "RIGHT", "FULL", "OUTER", "ON", "AS", "AND", "OR", "NOT",
    "UNION", "SELECT", "BY", "ASC", "DESC", "BETWEEN", "IN", "CASE", "WHEN",
    "THEN", "ELSE", "END", "TABLE", "INTERVAL", "HAVING", "CROSS",
    "MATCH_RECOGNIZE", "FOR",
}


def parse(sql: str) -> Statement:
    return Parser(sql).parse_statement()
