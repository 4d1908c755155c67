"""Constant expressions, evaluated once on the host by the engine's own
operators (ops/scalar.py, over 0-dim host arrays).

Used by the binder for VALUES rows, LIMIT/OFFSET and window arguments, by
INSERT for the coercion to the table's types, and by the optimizer's
constant folding (opt/optimizer.py::fold_constants). Being the operators
that evaluate a column, a constant gives the value and the data error
("integer out of range", "invalid input syntax for type integer: ...") that
the same expression gives over rows (reference: mlir-support/eval.cpp
evaluates constants with the kernels that evaluate columns, Arrow
compute)."""

from __future__ import annotations

import numpy as np

from ..plan.exprs import BExpr, Call, CaseExpr, Cast, Const, used_cols
from ..runtime.vtable import SCol, dec_is_float
from ..sql.types import K, Type
from . import backend as be
from . import scalar as sc


class ConstEvalError(Exception):
    pass


def eval_host(e: BExpr, target: Type | None = None) -> SCol:
    """The column-free expression `e`, cast to `target` where given, as a
    0-dim host column; its data error is raised here (as PostgreSQL raises
    it when it folds a constant, whatever the rows)."""
    if used_cols(e):
        raise ConstEvalError(f"not a constant: {e!r}")
    with sc.error_scope():
        c = sc.eval_expr(e, {})
        if target is not None and target.kind != K.NULL and not (
                c.type.base_eq(target)):
            c = sc._with_err(sc.eval_cast(c, target), c.err)
        return _raised(c)


def eval_const(e: BExpr, target: Type):
    """The value of the constant expression `e` coerced to `target`, in the
    host form the storage keeps (None for NULL): a decimal as its scaled int
    (a float above 18 digits of scale), a date as days, a timestamp as
    microseconds, a string as str."""
    return host_values(eval_host(e, target), 1)[0]


def coerce_values(data, valid, dictionary, s: Type, t: Type) -> list:
    """A result column of type `s` cast to `t` as CAST casts it (each non-NULL
    row's error raised), as host values in eval_const's form."""
    c = SCol(s, data, valid, dictionary)
    n = len(data)
    if t.kind != K.NULL and not s.base_eq(t):
        with sc.error_scope():
            c = _raised(sc.eval_cast(c, t), n)
    return host_values(c, n)


def host_values(c: SCol, n: int) -> list:
    """The n values of a host column (0-dim: broadcast) in eval_const's
    form."""
    if c.type.kind == K.NULL:
        return [None] * n
    if not hasattr(c.data, "ndim"):  # a wide literal's Python int
        c = SCol(c.type, np.array(c.data, dtype=object), c.valid,
                 c.dictionary)
    c = sc._bcast(c, n)
    data = be.to_host(c.data).reshape(-1)
    if c.dictionary is not None:
        # a NULL row's code may lie past the dictionary: clamped
        d = list(c.dictionary) or [""]
        vals = [str(d[min(max(int(x), 0), len(d) - 1)]) for x in data]
    else:
        vals = data.tolist()
    if c.valid is not None:
        valid = be.to_host(c.valid).reshape(-1)
        vals = [v if ok else None for v, ok in zip(vals, valid)]
    return vals


def fold(e: BExpr) -> BExpr:
    """`e` with each column-free Call, Cast and CASE replaced by its value, a
    Const (a user-defined function is left to run with its rows)."""
    if isinstance(e, Call):
        args = [fold(a) for a in e.args]
        if any(x is not y for x, y in zip(args, e.args)):
            e = Call(e.op, args, e.type)
        if e.op.startswith("udf:") or not all(
                isinstance(a, Const) for a in args):
            return e
    elif isinstance(e, Cast):
        arg = fold(e.arg)
        if arg is not e.arg:
            e = Cast(arg, e.type)
        if not isinstance(arg, Const):
            return e
    elif isinstance(e, CaseExpr):
        whens = [(fold(c), fold(v)) for c, v in e.whens]
        else_ = None if e.else_ is None else fold(e.else_)
        parts = [x for w in whens for x in w] + (
            [] if else_ is None else [else_])
        old = [x for w in e.whens for x in w] + (
            [] if e.else_ is None else [e.else_])
        if any(x is not y for x, y in zip(parts, old)):
            e = CaseExpr(whens, else_, e.type)
        if not all(isinstance(x, Const) for x in parts):
            return e
    else:
        return e
    c = eval_host(e)
    value = host_values(c, 1)[0]
    t = c.type
    if (value is not None and t.kind == K.DECIMAL and not dec_is_float(t)):
        value = _dec_str(value, t.s)  # a Const holds a decimal's text
    return Const(value, e.type)


def _raised(c: SCol, n: int = 1) -> SCol:
    """`c` once the data error of its first failing row is raised."""
    if c.err is not None:
        sc.raise_data_error(be.to_host(sc.first_error(c.err, None, n))[0])
        c = sc.without_err(c)
    return c


def _dec_str(v: int, s: int) -> str:
    sign = "-" if v < 0 else ""
    v = abs(v)
    if s == 0:
        return f"{sign}{v}"
    ip, fp = divmod(v, 10**s)
    return f"{sign}{ip}.{fp:0{s}d}"
