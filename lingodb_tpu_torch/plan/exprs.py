"""Bound (typed) scalar expressions.

Equivalent of the reference's DB-dialect scalar ops
(reference: include/lingodb/compiler/Dialect/DB/IR/DBOps.td:164-567 — constants,
null handling, arithmetic with decimal/date/interval overloads, compares,
and/or/not, cast, runtime_call). Expressions here are pure trees over column
ids; evaluation lowers them to jnp operations over (data, validity) pairs in
ops/scalar.py, all traced inside one jitted stage function per plan node.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..sql.types import Type


class BExpr:
    """Base class: every bound expression carries its result type."""

    type: Type


@dataclass
class ColRef(BExpr):
    cid: int
    type: Type

    def __repr__(self):
        return f"#{self.cid}:{self.type}"


@dataclass
class Const(BExpr):
    value: object  # python-level value (None for NULL); decimals as scaled int
    type: Type

    def __repr__(self):
        return f"{self.value!r}:{self.type}"


@dataclass
class Call(BExpr):
    """Generic n-ary operation.

    op names (mirrors reference db ops + RuntimeFunctions registry):
      arithmetic: add sub mul div mod neg
      comparison: eq neq lt lte gt gte
      logic:      and or not  (Kleene 3-valued)
      null:       isnull isnotnull coalesce
      string:     like concat substring upper lower length ltrim rtrim trim
                  startswith endswith replace repeat reverse
      date:       extract_year extract_month extract_day extract_hour
                  extract_minute extract_second date_add date_sub date_trunc
      math:       abs round floor ceil sqrt exp ln log10 pow sin cos
      misc:       hash in
    """

    op: str
    args: list[BExpr]
    type: Type

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.args))})"


@dataclass
class Cast(BExpr):
    arg: BExpr
    type: Type

    def __repr__(self):
        return f"cast({self.arg!r} as {self.type})"


@dataclass
class CaseExpr(BExpr):
    """searched CASE (operand form is desugared by the binder)."""

    whens: list[tuple[BExpr, BExpr]]
    else_: Optional[BExpr]
    type: Type


def walk(e: BExpr):
    """Yield every node of the expression tree (pre-order)."""
    yield e
    if isinstance(e, Call):
        for a in e.args:
            yield from walk(a)
    elif isinstance(e, Cast):
        yield from walk(e.arg)
    elif isinstance(e, CaseExpr):
        for c, v in e.whens:
            yield from walk(c)
            yield from walk(v)
        if e.else_ is not None:
            yield from walk(e.else_)


def used_cols(e: BExpr) -> set[int]:
    return {n.cid for n in walk(e) if isinstance(n, ColRef)}


def map_cols(e: BExpr, mapping: dict[int, int]) -> BExpr:
    """Rewrite column ids (for renaming / CTE instantiation)."""
    if isinstance(e, ColRef):
        return ColRef(mapping.get(e.cid, e.cid), e.type)
    if isinstance(e, Const):
        return e
    if isinstance(e, Call):
        return Call(e.op, [map_cols(a, mapping) for a in e.args], e.type)
    if isinstance(e, Cast):
        return Cast(map_cols(e.arg, mapping), e.type)
    if isinstance(e, CaseExpr):
        return CaseExpr(
            [(map_cols(c, mapping), map_cols(v, mapping)) for c, v in e.whens],
            None if e.else_ is None else map_cols(e.else_, mapping),
            e.type,
        )
    raise TypeError(type(e))


def conjuncts(e: Optional[BExpr]) -> list[BExpr]:
    """Split a predicate into its top-level AND conjuncts."""
    if e is None:
        return []
    if isinstance(e, Call) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(conjuncts(a))
        return out
    return [e]


def disjuncts(e: BExpr) -> list[BExpr]:
    """Flatten nested ORs into the list of top-level disjuncts."""
    if isinstance(e, Call) and e.op == "or":
        out = []
        for a in e.args:
            out.extend(disjuncts(a))
        return out
    return [e]


def make_and(parts: list[BExpr]) -> Optional[BExpr]:
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    nullable = any(p.type.nullable for p in parts)
    return Call("and", list(parts), Type.bool_(nullable))
