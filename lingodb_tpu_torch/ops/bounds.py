"""Bounds of integer and decimal expressions, proved on the host before a
statement runs: where they show that an operator's result and every
intermediate fit int64, the operator computes in int64 and builds no check
(ops/scalar.py); elsewhere it goes through the checked kernel
(ops/checked.py).

A bound is an interval (lo, hi) of the unscaled value (a decimal's value
times 10^scale). It comes from the type (INT, BIGINT, DECIMAL(p, s): |v| <=
10^p), or, for a column of a base table, from the column's minimum and
maximum (the session keeps them with the uploaded table), and is carried
through the plan: a Map's expression, an aggregate's min / max, a sum as its
argument's bound times the rows its input can hold. Every value a checked
operator, a cast or a base table gives lies inside its type, so the type is
always a sound bound; the rest only narrows it.

A statement's bounds live in a PlanBounds, set for the statement's run
(`scope`); outside one (a constant folded on the host, a test calling the
operators) a column reference has its type's bound.
"""

from __future__ import annotations

import contextlib
import contextvars

from ..plan import logical as L
from ..plan.exprs import CaseExpr, Call, Cast, ColRef, Const
from ..sql.types import K, Type

INT64_MAX = (1 << 63) - 1

_PLAN: contextvars.ContextVar = contextvars.ContextVar(
    "lingodb_plan_bounds", default=None)


@contextlib.contextmanager
def scope(pb: "PlanBounds | None"):
    tok = _PLAN.set(pb)
    try:
        yield pb
    finally:
        _PLAN.reset(tok)


def scale_of(t: Type) -> int:
    return t.s if t.kind == K.DECIMAL else 0


def type_bound(t: Type):
    if t.kind == K.INT:
        return (-(1 << 31), (1 << 31) - 1)
    if t.kind == K.BIGINT:
        return (-(1 << 63), INT64_MAX)
    if t.kind == K.BOOL:
        return (0, 1)
    if t.kind == K.DECIMAL:
        # 10^p, not 10^p - 1: round() may carry a value to the next digit
        return (-(10**t.p), 10**t.p)
    if t.kind == K.NULL:
        return (0, 0)
    return None


def _rescale(b, a: int, c: int):
    lo, hi = b
    if c >= a:
        f = 10 ** (c - a)
        return (lo * f, hi * f)
    d = 10 ** (a - c)
    return (-((-lo * 2 + d) // (2 * d)) if lo < 0 else (lo * 2 + d) // (2 * d),
            -((-hi * 2 + d) // (2 * d)) if hi < 0 else (hi * 2 + d) // (2 * d))


def _mag(b) -> int:
    return max(abs(b[0]), abs(b[1]))


def _union(a, b):
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def _meet(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return (max(a[0], b[0]), min(a[1], b[1]))


def _step(b, a: int, c: int) -> int:
    """The largest magnitude the int64 operators meet rescaling values in
    `b` from scale a to c: the product up, or the dividend plus half the
    divisor (the rounding) down."""
    if c >= a:
        return _mag(b) * 10 ** (c - a)
    return _mag(b) + 10 ** (a - c) // 2


def arith_bound(op: str, ba, bb, sa: int, sb: int, s: int):
    """(result bound, largest intermediate magnitude) of add / sub / mul /
    mod / cast (bb None) over operand bounds at scales sa, sb, at result
    scale s."""
    if op == "cast":
        r = _rescale(ba, sa, s)
        return r, max(_mag(ba), _step(ba, sa, s))
    if op == "mul":
        ps = [ba[0] * bb[0], ba[0] * bb[1], ba[1] * bb[0], ba[1] * bb[1]]
        p = (min(ps), max(ps))
        r = _rescale(p, sa + sb, s)
        return r, max(_mag(p), _step(p, sa + sb, s))
    a2, b2 = _rescale(ba, sa, s), _rescale(bb, sb, s)
    inter = max(_mag(ba), _mag(bb), _step(ba, sa, s), _step(bb, sb, s))
    if op == "mod":
        # |R| < |b| and |R| <= |a|, with a's sign
        m = min(_mag(a2), max(_mag(b2) - 1, 0))
        return (-m if a2[0] < 0 else 0, m if a2[1] > 0 else 0), inter
    r = ((a2[0] + b2[0], a2[1] + b2[1]) if op == "add"
         else (a2[0] - b2[1], a2[1] - b2[0]))
    return r, max(inter, _mag(r))


def fits(op: str, ba, bb, sa: int, sb: int, s: int, lo: int, hi: int,
         prec: int = 0) -> bool:
    """Whether the int64 operators compute op exactly on every row within
    the bounds and no row leaves [lo, hi] or a DECIMAL(prec)."""
    if ba is None or (op != "cast" and bb is None):
        return False
    r, m = arith_bound(op, ba, bb, sa, sb, s)
    if m > INT64_MAX or r[0] < lo or r[1] > hi:
        return False
    return not prec or _mag(r) < 10**prec


def bound(e, t: Type | None = None):
    """The bound of expression `e` (None: only its type's, `t` where there
    is no expression)."""
    if e is None:
        return None if t is None else type_bound(t)
    pb = _PLAN.get()
    if pb is not None:
        return pb.expr(e)
    return _expr_bound(e, None)


def _const_bound(e: Const):
    if e.value is None:
        return (0, 0)
    if e.type.kind not in (K.INT, K.BIGINT, K.DECIMAL, K.BOOL):
        return None
    from .scalar import _const_physical

    try:
        v = int(_const_physical(e.value, e.type))
    except (TypeError, ValueError, OverflowError):
        return type_bound(e.type)
    return (v, v)


def _expr_bound(e, pb):
    t = e.type
    tb = type_bound(t)
    if tb is None:
        return None
    sub = (lambda x: _expr_bound(x, None)) if pb is None else pb.expr
    if isinstance(e, ColRef):
        return tb if pb is None else _meet(pb.col(e.cid), tb)
    if isinstance(e, Const):
        return _const_bound(e)
    if isinstance(e, Cast):
        a = sub(e.arg)
        if a is None or e.arg.type.kind not in (K.INT, K.BIGINT, K.DECIMAL,
                                                K.BOOL):
            return tb  # a cast from a double or a string: checked
        return _meet(_rescale(a, scale_of(e.arg.type), scale_of(t)), tb)
    if isinstance(e, CaseExpr):
        out = (0, 0) if e.else_ is None else sub(e.else_)
        for _c, v in e.whens:
            out = _union(out, sub(v))
        return _meet(out, tb)
    if isinstance(e, Call):
        if e.op in ("add", "sub", "mul", "mod") and len(e.args) == 2:
            a, b = sub(e.args[0]), sub(e.args[1])
            if a is None or b is None:
                return tb
            r, _m = arith_bound(e.op, a, b, scale_of(e.args[0].type),
                                scale_of(e.args[1].type), scale_of(t))
            # an INT or BIGINT result beyond its type raises
            return _meet(r, tb) if t.kind != K.DECIMAL else r
        if e.op == "neg":
            a = sub(e.args[0])
            return tb if a is None else (-a[1], -a[0])
        if e.op == "abs":
            a = sub(e.args[0])
            return tb if a is None else (0, _mag(a))
        if e.op == "coalesce":
            out = None
            for x in e.args:
                bx = sub(x)
                out = bx if out is None else _union(out, bx)
            return _meet(out, tb)
        if e.op in ("round", "floor", "ceil") and t.kind == K.DECIMAL:
            a = sub(e.args[0])
            u = 10**t.s
            return tb if a is None else (a[0] - u, a[1] + u)
    return tb


class PlanBounds:
    """The bounds of one statement's plan: each column id's definition (a
    base column, a Map's expression, an aggregate or window function, a
    set operation's or shared subtree's output), resolved and kept at
    first use. `stats(table, column)` gives a base column's (min, max), or
    None."""

    def __init__(self, root, stats, rows_of, catalog=None):
        self._stats = stats
        self._rows_of = rows_of
        self._catalog = catalog
        self._defs: dict = {}
        self._cols: dict = {}
        self._exprs: dict = {}
        self._rows: dict = {}
        self._seen: set = set()
        self._nodes: dict = {}
        self._map_exprs: dict = {}
        self._walk(root)

    def _define(self, cid: int, d) -> None:
        old = self._defs.get(cid, d)
        # a column id defined twice in two ways has no bound
        self._defs[cid] = d if old == d else ("none",)

    def _walk(self, node) -> None:
        if id(node) in self._seen:
            return
        self._seen.add(id(node))
        if isinstance(node, L.Scan):
            for c in node.cols:
                self._define(c.cid, ("base", node.table, c.name))
        elif isinstance(node, L.Map):
            for info, e in node.computed:
                self._map_exprs[id(e)] = e
                self._define(info.cid, ("expr", id(e)))
        elif isinstance(node, L.Aggregate):
            self._nodes[id(node)] = node
            for spec in node.aggs:
                self._define(spec.out.cid, ("agg", spec.fn, spec.arg,
                                            id(node)))
        elif isinstance(node, L.Window):
            self._nodes[id(node)] = node
            for f in node.funcs:
                self._define(f.out.cid, ("agg", f.fn, f.arg, id(node)))
        elif isinstance(node, L.SetOp):
            for i, c in enumerate(node.cols):
                args = [m[i] for m in (node.lmap, node.rmap) if i < len(m)]
                self._define(c.cid, ("union", tuple(args)))
        elif isinstance(node, L.Tmp):
            for src, c in node.mapping:
                if src != c.cid:  # (the same id: the holder defines it)
                    self._define(c.cid, ("union", (src,)))
            self._walk(node.holder.plan)
        elif isinstance(node, L.Iterate):
            for c in node.cols:
                self._define(c.cid, ("none",))
        elif isinstance(node, L.IterRef):
            for c in node.cols:
                self._define(c.cid, ("none",))
        for c in node.children():
            self._walk(c)

    def rows(self, node):
        """An upper bound of the rows `node` gives (None: unbounded)."""
        key = id(node)
        if key in self._rows:
            return self._rows[key]
        self._rows[key] = None  # a cycle (an Iterate) is unbounded
        if isinstance(node, L.Scan):
            r = self._rows_of(node.table)
        elif isinstance(node, L.ConstRel):
            r = len(node.rows)
        elif isinstance(node, (L.Iterate, L.IterRef)):
            r = None
        elif isinstance(node, L.Tmp):
            r = self.rows(node.holder.plan)
        elif isinstance(node, L.Join):
            lr, rr = self.rows(node.left), self.rows(node.right)
            if lr is None or rr is None:
                r = None
            elif node.kind in ("semi", "anti", "single", "mark"):
                r = lr
            elif node.kind == "inner" and self._unique_on_join(node,
                                                               node.right):
                r = lr  # each left row meets at most one right row
            elif node.kind == "inner" and self._unique_on_join(node,
                                                               node.left):
                r = rr
            else:
                r = (lr + 1) * (rr + 1)
        elif isinstance(node, L.SetOp):
            lr, rr = self.rows(node.left), self.rows(node.right)
            r = None if lr is None or rr is None else lr + rr
        else:
            kids = [self.rows(c) for c in node.children()]
            r = None if any(k is None for k in kids) else max(kids, default=1)
        self._rows[key] = r
        return r

    def _unique_on_join(self, join, side) -> bool:
        """Whether `side` of an inner join is unique on the join's equality
        columns (a declared key, opt/constraints.py)."""
        from ..opt.constraints import _eq_col_pairs, collect_fds

        if self._catalog is None:
            return False
        other = join.left if side is join.right else join.right
        cids = {c.cid for c in side.output_cols()}
        ocids = {c.cid for c in other.output_cols()}
        # the side's columns equal to the other side's
        keys = {x for a, b in _eq_col_pairs(join.predicate)
                for x, y in ((a, b), (b, a)) if x in cids and y in ocids}
        while isinstance(side, L.Tmp) and all(
                src == c.cid for src, c in side.mapping):
            side = side.holder.plan  # a shared subtree under the same ids
        fds = collect_fds(side, self._catalog)
        return bool(keys) and fds.key is not None and fds.key <= fds.expand(
            frozenset(keys))

    def col(self, cid: int):
        if cid in self._cols:
            return self._cols[cid]
        self._cols[cid] = None  # a definition that reaches itself
        d = self._defs.get(cid, ("none",))
        b = None
        if d[0] == "base":
            b = self._stats(d[1], d[2])
        elif d[0] == "expr":
            b = self.expr(self._map_exprs[d[1]])
        elif d[0] == "union":
            got = [self.col(src) for src in d[1]]
            if got and all(g is not None for g in got):
                b = got[0]
                for g in got[1:]:
                    b = _union(b, g)
        elif d[0] == "agg":
            b = self._agg(d[1], d[2], self._nodes[d[3]])
        self._cols[cid] = b
        return b

    def _agg(self, fn, arg, node):
        child = node.children()[0]
        if fn in ("count", "count_star", "row_number", "rank", "dense_rank",
                  "ntile"):
            n = self.rows(child)
            return None if n is None else (0, n)
        if arg is None:
            return None
        a = self.col(arg)
        if fn in ("min", "max", "any_value", "first_value", "last_value",
                  "nth_value"):
            return a
        if fn == "sum":
            n = self.rows(child)
            if a is None or n is None:
                return None
            return (min(0, a[0] * n), max(0, a[1] * n))
        return None

    def expr(self, e):
        key = id(e)
        if key not in self._exprs:
            self._exprs[key] = (e, _expr_bound(e, self))
        return self._exprs[key][1]
