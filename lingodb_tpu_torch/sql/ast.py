"""SQL abstract syntax tree.

Equivalent of the reference's ast::AstNode hierarchy
(reference: include/lingodb/compiler/frontend/ast/*.h,
src/compiler/frontend/ast/parsed_expression.cpp). Plain dataclasses; the
binder (sql/binder.py) turns these into a typed logical plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .types import Type


# ---------------------------------------------------------------- expressions
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: object  # python value; None for NULL
    type_hint: Optional[Type] = None  # e.g. DATE 'x', INTERVAL literals


@dataclass
class ColumnRef(Expr):
    parts: list[str]  # [col] or [table, col] (already lowercased)


@dataclass
class Star(Expr):
    table: Optional[str] = None  # t.* has table set


@dataclass
class BinaryOp(Expr):
    op: str  # + - * / % || and or = <> < <= > >=
    left: Expr
    right: Expr


@dataclass
class UnaryOp(Expr):
    op: str  # - not
    operand: Expr


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    expr: Expr
    items: list[Expr]
    negated: bool = False


@dataclass
class InSubquery(Expr):
    expr: Expr
    subquery: "SelectStmt"
    negated: bool = False


@dataclass
class Like(Expr):
    expr: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False


@dataclass
class Exists(Expr):
    subquery: "SelectStmt"
    negated: bool = False


@dataclass
class ScalarSubquery(Expr):
    subquery: "SelectStmt"


@dataclass
class QuantifiedComparison(Expr):
    """expr op ANY/ALL (subquery)"""

    op: str
    expr: Expr
    subquery: "SelectStmt"
    quantifier: str = "any"  # any | all


@dataclass
class Case(Expr):
    operand: Optional[Expr]  # CASE <operand> WHEN ...
    whens: list[tuple[Expr, Expr]] = field(default_factory=list)
    else_: Optional[Expr] = None


@dataclass
class Cast(Expr):
    expr: Expr
    target: Type


@dataclass
class FuncCall(Expr):
    name: str
    args: list[Expr] = field(default_factory=list)
    distinct: bool = False
    star: bool = False  # count(*)
    # window clause (OVER ...)
    over: Optional["WindowSpec"] = None


@dataclass
class WindowSpec:
    partition_by: list[Expr] = field(default_factory=list)
    order_by: list["OrderItem"] = field(default_factory=list)
    # frame: (mode, start, end) where start/end in
    # {"unbounded_preceding","current_row","unbounded_following",(n,"preceding"),(n,"following")}
    frame: Optional[tuple] = None


@dataclass
class ExtractExpr(Expr):
    part: str  # year, month, day, ...
    expr: Expr


@dataclass
class SubstringExpr(Expr):
    expr: Expr
    start: Expr
    length: Optional[Expr]


# ---------------------------------------------------------------- table refs
class TableRef:
    pass


@dataclass
class BaseTableRef(TableRef):
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef(TableRef):
    subquery: "SelectStmt"
    alias: str = ""
    column_aliases: list[str] = field(default_factory=list)


@dataclass
class JoinRef(TableRef):
    kind: str  # inner, left, right, full, cross
    left: TableRef
    right: TableRef
    condition: Optional[Expr] = None
    using: list[str] = field(default_factory=list)
    natural: bool = False


@dataclass
class ValuesRef(TableRef):
    rows: list[list[Expr]]
    alias: str = ""
    column_aliases: list[str] = field(default_factory=list)


# ---------------------------------------------------------------- statements
@dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = default (last for asc, first for desc)


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class CTE:
    name: str
    query: "SelectStmt"
    column_aliases: list[str] = field(default_factory=list)
    recursive: bool = False  # declared under WITH RECURSIVE


@dataclass
class SelectStmt:
    # core select
    items: list[SelectItem] = field(default_factory=list)
    distinct: bool = False
    from_refs: list[TableRef] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    # modifiers
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    ctes: list[CTE] = field(default_factory=list)
    # set operation: this node is `left <op> right` when set_op is set
    set_op: Optional[str] = None  # union, union_all, intersect, except
    left: Optional["SelectStmt"] = None
    right: Optional["SelectStmt"] = None
    # VALUES-as-query
    values: Optional[list[list[Expr]]] = None


@dataclass
class ExplainStmt:
    """EXPLAIN [VERBOSE] <query> (reference: relalg plan dumps used by the
    ct tooling, tools/ct/mlir-relalg-to-json.cpp; LingoDB exposes plans via
    snapshot files rather than an EXPLAIN statement — we expose both)."""

    query: "SelectStmt"
    verbose: bool = False
    analyze: bool = False


@dataclass
class ColumnDef:
    name: str
    type: Type
    not_null: bool = False
    primary_key: bool = False


@dataclass
class CreateTableStmt:
    name: str
    columns: list[ColumnDef]
    primary_key: list[str] = field(default_factory=list)


@dataclass
class CreateFunctionStmt:
    name: str
    arg_names: list[str]
    arg_types: list[Type]
    return_type: Type
    language: str
    body: str


@dataclass
class InsertStmt:
    table: str
    columns: list[str]  # empty = all
    query: SelectStmt  # VALUES are a SelectStmt with .values


@dataclass
class CopyStmt:
    table: str
    path: str
    options: dict


@dataclass
class SetStmt:
    key: str
    value: object


@dataclass
class DropTableStmt:
    name: str
    if_exists: bool = False


@dataclass
class CreateIndexStmt:
    """CREATE INDEX name ON table(cols) (reference: IndexCatalogEntry /
    LingoDBHashIndex; on the accelerator the index materializes as a cached direct-map
    lookup table for key->row-position joins)."""

    name: str
    table: str
    columns: list[str]


@dataclass
class CreateViewStmt:
    name: str
    query: "SelectStmt"
