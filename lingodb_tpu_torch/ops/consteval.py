"""Constant-expression evaluation on the host.

Used by the binder for VALUES rows, LIMIT/OFFSET, and by the optimizer for
constant folding (reference: mlir-support/eval.cpp + parsing.cpp evaluate
literals via Arrow compute; here plain Python suffices)."""

from __future__ import annotations

import numpy as np

from ..plan.exprs import BExpr, Call, CaseExpr, Cast, Const
from ..sql.types import IntervalUnit, K, Type
from ..storage.column import EPOCH, decimal_str_to_int


class ConstEvalError(Exception):
    pass


def eval_const(e: BExpr, target: Type):
    """Evaluate a constant expression tree to a Python value coerced to
    `target`'s canonical host representation:
      decimal -> scaled int (or float when scale > 18)
      date    -> int days, timestamp -> int micros
      string  -> str, bool -> bool, ints -> int, floats -> float
    """
    v, t = _eval(e)
    return coerce_py(v, t, target)


def _eval(e: BExpr):
    if isinstance(e, Const):
        return e.value, e.type
    if isinstance(e, Cast):
        v, t = _eval(e.arg)
        return coerce_py(v, t, e.type), e.type
    if isinstance(e, CaseExpr):
        for c, val in e.whens:
            cv, _ = _eval(c)
            if cv:
                v, t = _eval(val)
                return coerce_py(v, t, e.type), e.type
        if e.else_ is not None:
            v, t = _eval(e.else_)
            return coerce_py(v, t, e.type), e.type
        return None, e.type
    if isinstance(e, Call):
        args = [_eval(a) for a in e.args]
        vals = [a[0] for a in args]
        if any(v is None for v in vals) and e.op not in ("isnull", "isnotnull", "coalesce", "and", "or"):
            return None, e.type
        return _apply(e.op, args, e.type), e.type
    raise ConstEvalError(f"not a constant: {e!r}")


def _num(v, t: Type):
    """To a Python number in logical units (decimal -> Fraction-free float/int)."""
    if t.kind == K.DECIMAL:
        if isinstance(v, str):
            v = decimal_str_to_int(v, t.s)
        return v, t.s
    if t.kind in (K.DATE,):
        if isinstance(v, str):
            return int((np.datetime64(_norm_date_str(v), "D") - EPOCH).astype(np.int64)), 0
        return int(v), 0
    if t.kind == K.TIMESTAMP:
        if isinstance(v, str):
            return int(np.datetime64(_norm_date_str(v), "us").astype(np.int64)), 0
        return int(v), 0
    return v, 0


def _apply(op: str, args, out_t: Type):
    vals = [a[0] for a in args]
    types = [a[1] for a in args]
    if op in ("add", "sub", "mul", "div", "mod", "neg"):
        scaled = [_num(v, t) for v, t in args]
        if out_t.kind == K.DECIMAL:
            # align scales
            def at_scale(x, s_from, s_to):
                return x * 10 ** (s_to - s_from) if s_to >= s_from else x // 10 ** (s_from - s_to)

            if op == "neg":
                return -at_scale(scaled[0][0], scaled[0][1], out_t.s)
            a, sa = scaled[0]
            b, sb = scaled[1]
            if op in ("add", "sub"):
                a = at_scale(a, sa, out_t.s)
                b = at_scale(b, sb, out_t.s)
                return a + b if op == "add" else a - b
            if op == "mul":
                prod = a * b  # scale sa+sb
                return at_scale(prod, sa + sb, out_t.s)
            if op == "div":
                # a/b at out scale: a * 10^(s_out - sa + sb) / b, rounded
                shift = out_t.s - sa + sb
                num = a * 10**shift if shift >= 0 else a // 10**-shift
                q, r = divmod(num, b)
                if 2 * abs(r) >= abs(b):
                    q += 1 if (num >= 0) == (b >= 0) else -1
                return q
            if op == "mod":
                a = at_scale(a, sa, out_t.s)
                b = at_scale(b, sb, out_t.s)
                return a - (a // b) * b if b else None
        a = scaled[0][0] / 10 ** scaled[0][1] if scaled[0][1] else scaled[0][0]
        if op == "neg":
            return -a
        b = scaled[1][0] / 10 ** scaled[1][1] if scaled[1][1] else scaled[1][0]
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
        if op == "div":
            if out_t.is_integer:
                return int(a / b) if b else None
            return a / b if b else None
        if op == "mod":
            return a % b if b else None
    if op == "date_add" or op == "date_sub":
        v, _ = _num(vals[0], types[0])
        iv = vals[1]
        sign = 1 if op == "date_add" else -1
        if types[1].unit == IntervalUnit.MONTH:
            return _shift_months(v, sign * iv, types[0])
        if types[0].kind == K.DATE:
            return v + sign * iv // 86_400_000_000
        return v + sign * iv
    if op in ("eq", "neq", "lt", "lte", "gt", "gte"):
        a, sa = _num(vals[0], types[0])
        b, sb = _num(vals[1], types[1])
        if sa or sb:
            a, b = a * 10**sb, b * 10**sa
        import operator

        f = {"eq": operator.eq, "neq": operator.ne, "lt": operator.lt,
             "lte": operator.le, "gt": operator.gt, "gte": operator.ge}[op]
        return f(a, b)
    if op == "and":
        return all(bool(v) for v in vals)
    if op == "or":
        return any(bool(v) for v in vals)
    if op == "not":
        return not vals[0]
    if op == "isnull":
        return vals[0] is None
    if op == "isnotnull":
        return vals[0] is not None
    if op == "coalesce":
        for v in vals:
            if v is not None:
                return v
        return None
    if op == "concat":
        return "".join(str(v) for v in vals)
    if op == "upper":
        return str(vals[0]).upper()
    if op == "lower":
        return str(vals[0]).lower()
    if op == "length":
        return len(str(vals[0]))
    if op == "substring":
        s = str(vals[0])
        start = int(vals[1]) - 1
        ln = int(vals[2])
        return s[max(start, 0):max(start, 0) + ln]
    if op == "abs":
        return abs(vals[0])
    raise ConstEvalError(f"cannot const-eval op {op}")


def _shift_months(days_or_us: int, months: int, t: Type):
    unit = "D" if t.kind == K.DATE else "us"
    if t.kind == K.DATE:
        d = EPOCH + np.timedelta64(int(days_or_us), "D")
    else:
        d = np.datetime64(int(days_or_us), "us")
    m = d.astype("datetime64[M]")
    day_off = (d - m.astype(f"datetime64[{unit}]")).astype(int)
    m2 = m + np.timedelta64(int(months), "M")
    res = m2.astype(f"datetime64[{unit}]") + day_off
    if t.kind == K.DATE:
        return int((res - EPOCH).astype(np.int64))
    return int(res.astype(np.int64))


def coerce_py(v, t: Type, target: Type):
    """Coerce a host value from type t to target's host representation."""
    if v is None:
        return None
    if target.kind == K.NULL:
        return v
    if target.kind == K.DECIMAL:
        if t.kind == K.DECIMAL:
            if target.s >= t.s:
                return v * 10 ** (target.s - t.s) if isinstance(v, int) else decimal_str_to_int(str(v), target.s)
            div = 10 ** (t.s - target.s)
            q, r = divmod(v, div)
            if 2 * r >= div:
                q += 1
            return q
        if isinstance(v, str):
            return decimal_str_to_int(v, target.s)
        if isinstance(v, bool):
            return int(v) * 10**target.s
        if isinstance(v, int):
            return v * 10**target.s
        return round(v * 10**target.s)
    if target.kind in (K.INT, K.BIGINT):
        if t.kind == K.DECIMAL and isinstance(v, int):
            return v // 10**t.s
        if isinstance(v, str):
            return int(float(v))
        return int(v)
    if target.kind in (K.FLOAT, K.DOUBLE):
        if t.kind == K.DECIMAL and isinstance(v, int):
            return v / 10**t.s
        return float(v)
    if target.is_string:
        if t.kind == K.DECIMAL and isinstance(v, int):
            return _dec_str(v, t.s)
        if t.kind == K.DATE and isinstance(v, int):
            return str(EPOCH + np.timedelta64(v, "D"))
        if t.kind == K.BOOL:
            return "t" if v else "f"
        return str(v)
    if target.kind == K.DATE:
        if isinstance(v, str):
            return int((np.datetime64(_norm_date_str(v), "D") - EPOCH).astype(np.int64))
        if t.kind == K.TIMESTAMP:
            return int(v // 86_400_000_000)
        return int(v)
    if target.kind == K.TIMESTAMP:
        if isinstance(v, str):
            return int(np.datetime64(_norm_date_str(v), "us").astype(np.int64))
        if t.kind == K.DATE:
            return int(v) * 86_400_000_000
        return int(v)
    if target.kind == K.BOOL:
        if isinstance(v, str):
            return v.lower() in ("t", "true", "1", "yes")
        return bool(v)
    if target.kind == K.INTERVAL:
        return int(v)
    raise ConstEvalError(f"cannot coerce {v!r} from {t} to {target}")


def _dec_str(v: int, s: int) -> str:
    sign = "-" if v < 0 else ""
    v = abs(v)
    if s == 0:
        return f"{sign}{v}"
    ip, fp = divmod(v, 10**s)
    return f"{sign}{ip}.{fp:0{s}d}"


def _norm_date_str(v: str) -> str:
    """Normalize non-zero-padded ISO dates (accepted by the reference's date
    parser, mlir-support/parsing.cpp) for numpy: 2002-2-1 -> 2002-02-01."""
    import re as _re

    m = _re.match(r"^(\d{4})-(\d{1,2})-(\d{1,2})(.*)$", v.strip())
    if m:
        return f"{m.group(1)}-{int(m.group(2)):02d}-{int(m.group(3)):02d}{m.group(4)}"
    return v.strip()
