"""Scalar expression evaluation over device columns.

Equivalent of the reference's DB-dialect lowering
(reference: src/compiler/Conversion/DBToStd/LowerToStd.cpp — nullable<T> ->
(i1, T) pairs, decimal arith on i128, string/date ops via runtime calls).
Here each expression lowers to array ops over SCol (data, validity) pairs:
  - NULLs: separate bool validity tensors, Kleene 3-valued logic for and/or
  - decimals: scaled int64 while every value fits 63 bits; beyond that the
    exact wide tier takes over (host Python-int limbs, ops/decwide.py — a
    superset of the reference's i128 range)
  - strings: host-computed dictionary LUTs + one device gather (ops/strings.py)
String ops build LUTs on the host against the dictionary, never the data.

Constants evaluate to 0-dim arrays; `eval_expr` places them beside the
environment's tensors (same device), so infix arithmetic between a column and
a constant never mixes a tensor with a numpy array."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re

import numpy as np
import torch

from . import backend as be
from .backend import xnp as jnp

from ..plan.exprs import BExpr, Call, CaseExpr, Cast, ColRef, Const
from ..runtime.vtable import SCol, dec_is_float, dec_is_wide, is_obj, np_dtype
from ..sql.types import IntervalUnit, K, Type
from ..storage.column import EPOCH, decimal_str_to_int
from . import bounds, bytestr, dates, decwide, strings
from . import checked as ckd

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)

US_PER_DAY = 86_400_000_000


class EvalError(Exception):
    pass


# ----------------------------------------------------------------- data errors
# An error the data raises (PostgreSQL's "integer out of range", "invalid
# input syntax for type integer: ..."): each row's code in SCol.err, an
# int64, 0 for none. The code's low _KIND_BITS bits are its kind, the form
# of its message (_KINDS, fixed); a kind that names a value (a string that
# does not parse) also holds where the value is: the dictionary the cast
# parsed, by its number among the sources of the scope that evaluates it
# (error_scope: a statement, a fused program, a constant), and the entry's
# position in it. So a code built into a captured program means the same at
# every replay, and nothing outlives the scope's sources. An expression
# that cannot fail carries None and costs nothing. Operators combine their
# arguments' codes, the first argument's first (PostgreSQL evaluates
# arguments left to right); CASE, COALESCE, AND and OR take the code of
# what they evaluate for the row. The operator that consumes a value (a
# Map, a Select, join keys: runtime/executor.py, runtime/fused.py) raises
# the first code among its live rows: at once in the eager operators (one
# reduction and one read), or, inside a fused program, into the program's
# one scalar (deferred_errors), raised after its packed fetch. NULL rows
# never raise; division by zero stays NULL.
_KIND_BITS, _SOURCE_BITS = 6, 20
# (the message, the value it shows: "" none, "s" the text, "strip" the text
# without its blanks)
_KINDS = [("", ""), ("integer out of range", ""),
          ("bigint out of range", ""), ("numeric field overflow", ""),
          ('date/time field value out of range: "{}"', "s")]
# PostgreSQL's text input, per type: its name in the messages
_TEXT_TYPE = {K.INT: "integer", K.BIGINT: "bigint", K.DECIMAL: "numeric",
              K.FLOAT: "real", K.DOUBLE: "double precision", K.DATE: "date",
              K.TIMESTAMP: "timestamp", K.BOOL: "boolean"}
for _name in _TEXT_TYPE.values():
    _KINDS += [(f'invalid input syntax for type {_name}: "{{}}"', "s"),
               (f'value "{{}}" is out of range for type {_name}', "s"),
               (f'"{{}}" is out of range for type {_name}', "strip")]
# not an error: a checked operator's result that int64 cannot hold (a
# DECIMAL + - * or cast) marks its row so, with the expression among the
# scope's sources; its consumer raises NeedsExact, and the statement runs
# again with that expression on the exact host path
_KINDS += [("the exact path is needed", "")]
_KIND_OF = {form: k for k, (form, _shown) in enumerate(_KINDS)}
assert len(_KINDS) <= 1 << _KIND_BITS
ERR_INT = _KIND_OF["integer out of range"]
ERR_BIGINT = _KIND_OF["bigint out of range"]
ERR_NUMERIC = _KIND_OF["numeric field overflow"]
ERR_EXACT = _KIND_OF["the exact path is needed"]
_ERR_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "lingodb_data_errors", default=None)
_ERR_SOURCES: contextvars.ContextVar = contextvars.ContextVar(
    "lingodb_error_sources", default=None)


@contextlib.contextmanager
def error_scope(sources: list | None = None):
    """Inside the block a cast from strings numbers its dictionary among
    `sources` (a new list by default), which the block yields: the list a
    code's message is read from (raise_data_error)."""
    sources = [] if sources is None else sources
    tok = _ERR_SOURCES.set(sources)
    try:
        yield sources
    finally:
        _ERR_SOURCES.reset(tok)


def _source_number(dictionary) -> int:
    """The number of `dictionary` among the scope's sources, from 1 (0
    outside a scope, or past the code's room: its messages then show "?"
    for the value)."""
    sources = _ERR_SOURCES.get()
    if sources is None:
        return 0
    for i, d in enumerate(sources):
        if d is dictionary:
            return i + 1
    if len(sources) + 1 >= 1 << _SOURCE_BITS:
        return 0
    sources.append(dictionary)
    return len(sources)


def error_message(code: int, sources: list | None = None) -> str:
    """The message of the nonzero `code`, its value read from `sources`
    (the current scope's by default)."""
    form, shown = _KINDS[code & ((1 << _KIND_BITS) - 1)]
    if not shown:
        return form
    src = (code >> _KIND_BITS) & ((1 << _SOURCE_BITS) - 1)
    entry = code >> (_KIND_BITS + _SOURCE_BITS)
    sources = _ERR_SOURCES.get() if sources is None else sources
    if not src or sources is None or src > len(sources):
        return form.format("?")
    text = str(sources[src - 1][entry])
    return form.format(text.strip() if shown == "strip" else text)


class NeedsExact(Exception):
    """A live row of a checked operator's result passed int64: the
    statement runs again with the operator on the exact host path. `key` is
    the expression's plan key (plan/serial.py expr_key), None for every
    checked operator of the statement."""

    def __init__(self, key):
        super().__init__(f"the exact path is needed for {key}")
        self.key = key


_EXACT: contextvars.ContextVar = contextvars.ContextVar(
    "lingodb_exact_exprs", default=frozenset())


@contextlib.contextmanager
def exact_exprs(keys):
    """Inside the block the checked operators whose plan keys are in `keys`
    (None among them: every one) compute on the exact host path."""
    tok = _EXACT.set(frozenset(keys))
    try:
        yield
    finally:
        _EXACT.reset(tok)


def goes_exact(e) -> bool:
    """Whether expression `e` computes on the exact host path here."""
    keys = _EXACT.get()
    if not keys or e is None:
        return False
    if None in keys:
        return True
    from ..plan.serial import expr_key

    return expr_key(e) in keys


def _exact_code(e) -> int:
    """The code that marks a row of expression `e` as needing the exact
    path: e's number among the scope's sources beside the kind."""
    src = 0 if e is None else _source_number(e)
    return ERR_EXACT | (src << _KIND_BITS)


def raise_data_error(code, sources: list | None = None) -> None:
    """Raise the error of `code` (a host int, 0 for none); `sources` as in
    error_message. A row that needs the exact path raises NeedsExact."""
    code = int(code)
    if not code:
        return
    if code & ((1 << _KIND_BITS) - 1) == ERR_EXACT:
        src = (code >> _KIND_BITS) & ((1 << _SOURCE_BITS) - 1)
        sources = _ERR_SOURCES.get() if sources is None else sources
        key = None
        if src and sources is not None and src <= len(sources):
            from ..plan.serial import expr_key

            key = expr_key(sources[src - 1])
        raise NeedsExact(key)
    raise EvalError(error_message(code, sources))


def _err_where(cond, valid, code: int):
    """Per-row codes: `code` where `cond` holds on a row that is not NULL."""
    if valid is not None:
        ref = _first_torch(cond, valid)
        if ref is not None:
            cond, valid = be.like(cond, ref), be.like(valid, ref)
        cond = cond & valid
    return be.astype(cond, np.int32) * code  # a fixed kind: below 2^31


def _first_err(*errs):
    """Per-row codes: each row's first nonzero code among `errs` (None where
    every one is None)."""
    out = None
    for e in errs:
        if e is None:
            continue
        if out is None:
            out = e
            continue
        ref = _first_torch(out, e)
        if ref is not None:
            out, e = be.like(out, ref), be.like(e, ref)
        out = jnp.where(out != 0, out, e)
    return out


def _with_err(c: SCol, err) -> SCol:
    """`c` with the codes `err` ahead of its own (an argument's error is
    raised before the function's)."""
    if err is None:
        return c
    return dataclasses.replace(c, err=_first_err(err, c.err))


def first_error(err, live, n: int):
    """The code of the first of the n rows that is live (`live` None: every
    row) and has a nonzero code, 0 if none, as a (1,) int64 array beside
    `err`: a pass over bytes, an argmax and a gather, nothing read."""
    ref = _first_torch(err, live)
    if ref is not None:
        err = be.like(err, ref)
        live = None if live is None else be.like(live, ref)
    bad = err != 0
    if live is not None:
        bad = bad & live
    if bad.ndim == 0:
        bad = jnp.broadcast_to(bad, (n,))
    m = bad.shape[0]
    if err.ndim == 0:
        err = jnp.broadcast_to(err, (m,))
    if m == 0:
        return be.full(1, 0, np.int64, ref)
    if ref is None:
        at = np.flatnonzero(bad)
        return np.array([err[at[0]] if len(at) else 0], np.int64)
    # the first True: argmax gives the first of the maxima
    at = torch.argmax(bad.contiguous().view(torch.uint8)).reshape(1)
    code = err.gather(0, at).to(torch.int64)
    return torch.where(bad.gather(0, at), code, 0)


class _Deferred:
    """The data errors of one fused program: the first nonzero code of the
    consumers in program order, a (1,) int64 tensor, or None where no
    consumer could fail; and the sources its codes' messages read, which
    the program keeps for its replays."""

    def __init__(self):
        self.code = None
        self.sources: list = []

    def add(self, code) -> None:
        self.code = code if self.code is None else jnp.where(
            self.code != 0, self.code, code)


@contextlib.contextmanager
def deferred_errors():
    """Inside the block a consumer's data errors are not read but kept:
    the block's object holds their code (`.code`), which the fused program
    returns beside its outputs, for its packed fetch, and the block is an
    error_scope over its `.sources`."""
    d = _Deferred()
    tok = _ERR_SINK.set(d)
    try:
        with error_scope(d.sources):
            yield d
    finally:
        _ERR_SINK.reset(tok)


def raise_data_errors(errs, live=None, n: int = 1) -> None:
    """Raise the first error among the live rows of the codes `errs` (in
    the order PostgreSQL evaluates them; None entries can fail on no row),
    or, inside deferred_errors, keep its code for the program's fetch."""
    err = _first_err(*errs)
    if err is None:
        return
    code = first_error(err, live, n)
    sink = _ERR_SINK.get()
    if sink is not None:
        sink.add(code)
        return
    raise_data_error(be.to_host(code)[0])


def without_err(c: SCol) -> SCol:
    return c if c.err is None else dataclasses.replace(c, err=None)


def checked(c: SCol, live=None, n: int = 1) -> SCol:
    """`c` once the errors of its live rows are raised (or deferred): the
    same column without its codes."""
    if c.err is None:
        return c
    raise_data_errors([c.err], live, n)
    return without_err(c)


def checked_all(cols: dict, cids, live=None, n: int = 1) -> None:
    """checked() for the columns `cids` of `cols` together (a Map's
    outputs: one reduction, one read), in place."""
    errs = [cols[cid].err for cid in cids]
    if all(e is None for e in errs):
        return
    raise_data_errors(errs, live, n)
    for cid in cids:
        cols[cid] = without_err(cols[cid])


def const_scol(value, t: Type) -> SCol:
    """Build a broadcastable scalar SCol for a constant."""
    if value is None:
        return SCol(t.as_nullable(), jnp.zeros((), np_dtype(t)), jnp.zeros((), jnp.bool_),
                    np.array([""], dtype=object) if t.is_string else None)
    if t.is_string:
        return SCol(t, jnp.zeros((), jnp.int32), None, np.array([str(value)], dtype=object))
    v = _const_physical(value, t)
    if (t.kind in (K.DECIMAL, K.INT, K.BIGINT) and isinstance(v, int)
            and not (INT64_MIN <= v <= INT64_MAX)):
        return SCol(t, decwide.obj_scalar(v), None)  # wide literal: exact
    return SCol(t, jnp.asarray(v, np_dtype(t)), None)


def _const_physical(v, t: Type):
    if t.kind == K.DECIMAL:
        if isinstance(v, str):
            iv = decimal_str_to_int(v, t.s)
        elif isinstance(v, int):
            iv = v * 10**t.s
        else:
            iv = round(v * 10**t.s)
        return iv / 10**t.s if dec_is_float(t) else iv
    if t.kind == K.DATE:
        if isinstance(v, str):
            return int(be.astype((np.datetime64(_norm_date_str(v), "D") - EPOCH), np.int64))
        return int(v)
    if t.kind == K.TIMESTAMP:
        if isinstance(v, str):
            return int(be.astype(np.datetime64(_norm_date_str(v), "us"), np.int64))
        return int(v)
    if t.kind == K.BOOL:
        return bool(v)
    if t.kind in (K.FLOAT, K.DOUBLE):
        return float(v)
    return int(v)


def eval_expr(e: BExpr, env: dict[int, SCol]) -> SCol:
    if isinstance(e, ColRef):
        return env[e.cid]
    if isinstance(e, Const):
        return _place(const_scol(e.value, e.type), env)
    if isinstance(e, Cast):
        a = eval_expr(e.arg, env)
        out = _with_err(eval_cast(a, e.type, e), a.err)
        return _beside(out, env) if is_obj(a.data) else out
    if isinstance(e, CaseExpr):
        return eval_case(e, env)
    if isinstance(e, Call):
        return eval_call(e, env)
    raise EvalError(f"cannot evaluate {e!r}")


def _env_device(env):
    for c in env.values():
        if be.is_torch(c.data):
            return c.data.device
    return None


def _place(c: SCol, env) -> SCol:
    """Move a constant's 0-dim arrays beside the environment's tensors."""
    dev = _env_device(env)
    if dev is None or is_obj(c.data) or be.is_torch(c.data):
        return c
    return SCol(c.type, be.to_device(c.data, dev),
                None if c.valid is None else be.to_device(c.valid, dev),
                c.dictionary)


def _exact_result(t: Type, data, valid, ref) -> SCol:
    """SCol for a result computed exactly on the host in Python ints: data
    that needs more than 63 bits stays a host object column (its validity
    comes to the host too); data that fits int64 goes back beside `ref`, so
    a table of tensors holds no stray host array."""
    data = decwide.demote_if_possible(data)
    if is_obj(data):
        return SCol(t, data, None if valid is None else be.to_host(valid))
    return SCol(t, be.like(data, ref),
                None if valid is None else be.like(valid, ref))


def _first_torch(*xs):
    return next((x for x in xs if be.is_torch(x)), None)


def truth_mask(c: SCol) -> jnp.ndarray:
    """3-valued boolean -> WHERE mask (NULL counts as false).
    (reference: db.derive_truth, DBOps.td:322)"""
    m = be.astype(c.data, jnp.bool_)
    if c.valid is not None:
        # (an exact host column's validity beside a tensor's: its tier)
        m = m & be.like(c.valid, m) if be.is_torch(m) else m & be.to_host(
            c.valid)
    return m


# --------------------------------------------------------------------- helpers
def _and_valid(*cols: SCol):
    out = None
    for c in cols:
        if c.valid is not None:
            v = c.valid
            if out is not None and be.is_torch(out) != be.is_torch(v):
                # an exact wide decimal's host column meets a tensor's
                # validity: combine them on the host, where its arithmetic
                # runs
                out, v = be.to_host(out), be.to_host(v)
            out = v if out is None else (out & v)
    return out


def _bcast(c: SCol, n: int) -> SCol:
    """Broadcast scalar SCol (or scalar validity, or scalar codes) to n
    rows."""
    if c.data.ndim != 0 and (c.valid is None or c.valid.ndim != 0) and (
            c.err is None or c.err.ndim != 0):
        return c
    data = c.data if c.data.ndim != 0 else jnp.broadcast_to(c.data, (n,))
    valid = c.valid
    if valid is not None and valid.ndim == 0:
        valid = jnp.broadcast_to(valid, (n,))
    err = c.err
    if err is not None and err.ndim == 0:
        err = jnp.broadcast_to(err, (n,))
    return SCol(c.type, data, valid, c.dictionary, err)


def _is_const_string(c: SCol) -> bool:
    return c.dictionary is not None and c.data.ndim == 0


# --------------------------------------------------------------------- casts
def eval_cast(a: SCol, t: Type, e=None) -> SCol:
    """`a` cast to `t`; `e`, the cast's expression where there is one, gives
    the operand's bound (ops/bounds.py) and marks rows that need the exact
    path."""
    s, d = a.type, t
    valid = a.valid
    if s.base_eq(d):
        return SCol(d, a.data, valid, a.dictionary)
    if s.kind == K.NULL:
        return const_scol(None, d)
    if s.is_string:
        return _cast_from_string(a, d)
    if d.is_string:
        return _cast_to_string(a, d)
    data = _int_scalar(a.data)
    if data is not a.data:
        a = dataclasses.replace(a, data=data)
    arg = None if e is None else e.arg
    if s.kind in (K.DECIMAL, K.INT, K.BIGINT, K.BOOL) and d.kind == K.DECIMAL:
        return _cast_to_decimal(a, d, e)
    if s.kind in (K.DECIMAL, K.INT, K.BIGINT) and d.kind in (K.INT, K.BIGINT):
        if is_obj(data):
            # numeric to integer rounds half away from zero (PostgreSQL)
            q = decwide.div_round(data, 10**s.s) if (
                s.kind == K.DECIMAL and s.s) else data
            return _exact_int(d, q, valid, None)
        ss = s.s if s.kind == K.DECIMAL else 0
        if ss > ckd.MAX_SHIFT:
            # divisor 10^s exceeds int64: exact
            return _exact_int(
                d, decwide.div_round(decwide.to_obj(data), 10**ss), valid,
                _first_torch(data, valid))
        lo, hi = _int_range(d)
        if bounds.fits("cast", _bound(arg, a), None, ss, 0, 0, lo, hi):
            q = _div_round(data, 10**ss) if ss else data
            return SCol(d, be.astype(q, np_dtype(d)), valid)
        return _checked(d, "cast", data, None, valid, ss, 0, 0, lo, hi,
                        _range_code(d))
    if s.kind == K.DECIMAL:
        if d.kind in (K.FLOAT, K.DOUBLE):
            if is_obj(data):
                f = np.array([float(v) for v in data.reshape(-1)],
                             np.dtype(np_dtype(d))).reshape(data.shape)
                return SCol(d, f / (10.0**s.s), valid)
            return SCol(d, be.astype(be.fdiv(data, 10.0**s.s), np_dtype(d)), valid)
        if d.kind == K.BOOL:
            return SCol(d, be.astype((data != 0), np.bool_), valid)
    if s.kind in (K.INT, K.BIGINT, K.BOOL):
        if d.kind in (K.INT, K.BIGINT):  # from a BOOL
            return SCol(d, be.astype(data, np_dtype(d)), valid)
        if d.kind in (K.FLOAT, K.DOUBLE):
            if is_obj(data):
                f = np.array([float(v) for v in data.reshape(-1)],
                             np.dtype(np_dtype(d))).reshape(data.shape)
                return SCol(d, f, valid)
            return SCol(d, be.astype(data, np_dtype(d)), valid)
        if d.kind == K.BOOL:
            return SCol(d, data != 0, valid)
    if s.kind in (K.FLOAT, K.DOUBLE):
        if d.kind == K.DECIMAL:
            return _cast_double_to_decimal(a, d, e)
        if d.kind in (K.INT, K.BIGINT):
            # rounded to the nearest, half to even (PostgreSQL's rint); NaN
            # and values beyond the type are out of range
            f = be.astype(data, np.float64)
            r = torch.round(f) if be.is_torch(f) else np.rint(f)
            lo, hi = _int_range(d)
            ok = (r >= float(lo)) & ((r <= float(hi)) if d.kind == K.INT
                                     else (r < 2.0**63))
            return SCol(d, be.astype(jnp.where(ok, r, 0.0), np_dtype(d)),
                        valid, None, _err_where(~ok, valid, _range_code(d)))
        if d.kind in (K.FLOAT, K.DOUBLE):
            return SCol(d, be.astype(data, np_dtype(d)), valid)
        if d.kind == K.BOOL:
            return SCol(d, data != 0, valid)
    if s.kind == K.DATE and d.kind == K.TIMESTAMP:
        return SCol(d, be.astype(data, jnp.int64) * US_PER_DAY, valid)
    if s.kind == K.TIMESTAMP and d.kind == K.DATE:
        return SCol(d, be.astype(jnp.floor_divide(data, US_PER_DAY), jnp.int32), valid)
    raise EvalError(f"cast {s} -> {t} not supported")


def _int_scalar(x):
    """A bare Python int (what arithmetic on a 0-dim object array gives) as
    a 0-dim array: int64, or object past int64; anything else unchanged."""
    if isinstance(x, (int, np.integer)) and not isinstance(x, (bool, np.bool_)):
        v = int(x)
        if INT64_MIN <= v <= INT64_MAX:
            return np.asarray(v, np.int64)
        return decwide.obj_scalar(v)
    return x


def _checked(t: Type, op: str, x, y, valid, sx: int, sy: int, s: int,
             lo: int, hi: int, code: int, prec: int = 0,
             code_prec: int = 0, digits: int = 0) -> SCol:
    """A checked operator's column (ops/checked.py): its value and codes,
    the operands placed beside each other."""
    ref = _first_torch(x, y, valid)
    if ref is not None:
        x = be.like(x, ref)
        y = None if y is None else be.like(y, ref)
        valid = None if valid is None else be.like(valid, ref)
    value, err = ckd.checked_arith(
        op, x, y, valid, sx, sy, s, lo, hi, code, prec, code_prec,
        be.tdtype(np_dtype(t)), digits)
    return SCol(t, value, valid, None, err)


def _marks_exact(c: SCol) -> bool:
    """Whether a host (numpy) checked column marks a row for the exact
    path: the host computes it exactly at once, no statement runs again."""
    err = c.err
    return (err is not None and not be.is_torch(err)
            and bool(np.any((np.asarray(err) & ((1 << _KIND_BITS) - 1))
                            == ERR_EXACT)))


def _exact_decimal(d: Type, vals, valid, ref) -> SCol:
    """An exact (Python-int) DECIMAL(p, s) result: a live row with more
    than p digits raises "numeric field overflow"; the rest as
    _exact_result places them."""
    vals = decwide.to_obj(vals)
    bad = np.abs(vals) >= 10**d.p
    err = None
    if bool(np.any(bad)):
        hvalid = None if valid is None else be.to_host(valid)
        err = _err_where(bad, hvalid, ERR_NUMERIC)
        vals = np.where(bad, 0, vals).astype(np.object_)
    out = _exact_result(d, vals, valid, ref)
    if err is not None and ref is not None and not is_obj(out.data):
        err = be.like(err, ref)
    return dataclasses.replace(out, err=err)


def _cast_to_decimal(a: SCol, d: Type, e) -> SCol:
    """An INT, BIGINT, BOOL or DECIMAL cast to DECIMAL(p, s): rescaled
    (rounding half away from zero), and a live row with more than p - s
    integer digits raises "numeric field overflow" (PostgreSQL's typmod).
    Where int64 cannot hold a value the exact host path computes it."""
    s, data, valid = a.type, a.data, a.valid
    ss = s.s if s.kind == K.DECIMAL else 0
    ref = _first_torch(data, valid)
    if (is_obj(data) or abs(d.s - ss) > ckd.MAX_SHIFT
            or (dec_is_wide(d) and d.s > ss and ref is None)
            or goes_exact(e)):
        return _exact_decimal(
            d, decwide.rescale(decwide.to_obj(data), ss, d.s), valid, ref)
    if s.kind == K.BOOL:
        data = be.astype(data, np.int64)
    arg = None if e is None else e.arg
    if bounds.fits("cast", _bound(arg, a), None, ss, 0, d.s, INT64_MIN,
                   INT64_MAX, d.p):
        return SCol(d, _rescale_int(be.astype(data, np.int64), ss, d.s),
                    valid)
    out = _checked(d, "cast", data, None, valid, ss, 0, d.s, INT64_MIN,
                   INT64_MAX, _exact_code(e), d.p, ERR_NUMERIC)
    if _marks_exact(out):
        return _exact_decimal(
            d, decwide.rescale(decwide.to_obj(data), ss, d.s), valid, ref)
    return out


def _cast_double_to_decimal(a: SCol, d: Type, e) -> SCol:
    """A double or real cast to DECIMAL(p, s) as PostgreSQL casts it: the
    value rounded to 15 significant digits (a real's to 6), then half away
    from zero at scale s (ops/checked.py, cast_f, one pass); a live row with
    more than p - s integer digits (or infinite, or NaN, which the engine's
    decimals do not hold) raises "numeric field overflow", and one int64
    cannot hold needs the exact path."""
    real = a.type.kind == K.FLOAT
    digits = ckd.FLOAT_DIGITS[torch.float32 if real else torch.float64]
    data = be.astype(a.data, jnp.float32 if real else jnp.float64)
    valid = a.valid
    if d.s <= ckd.MAX_SHIFT and not goes_exact(e):
        out = _checked(d, "cast_f", data, None, valid, 0, 0, d.s, INT64_MIN,
                       INT64_MAX, _exact_code(e), d.p, ERR_NUMERIC, digits)
        if not _marks_exact(out):
            return out
    host = be.to_host(data)
    vals = [ckd.float_result(float(v), digits, d.s) for v in host.reshape(-1)]
    vals = np.array([10**d.p if v is None else v for v in vals],
                    dtype=np.object_).reshape(np.shape(host))
    return _exact_decimal(d, vals, valid, _first_torch(data, valid))


def _exact_int(d: Type, q, valid, ref) -> SCol:
    """An exact (Python-int) result cast to INT or BIGINT: a row beyond the
    type's range is an error (and 0); the rest go beside `ref`."""
    lo, hi = _int_range(d)
    q = decwide.to_obj(q)
    bad = (q < lo) | (q > hi)
    hvalid = None if valid is None else be.to_host(valid)
    err = _err_where(bad, hvalid, _range_code(d)) if bad.any() else None
    out = be.astype(decwide.demote_if_possible(np.where(bad, 0, q)),
                    np_dtype(d))
    if ref is None:
        return SCol(d, out, valid, None, err)
    return SCol(d, be.like(out, ref),
                None if valid is None else be.like(valid, ref), None,
                None if err is None else be.like(err, ref))


def _rescale_int(data, s_from: int, s_to: int, to_float=False):
    if to_float:
        return be.astype(be.fdiv(data, 10.0**s_from), jnp.float64)
    if s_to == s_from:
        return data
    if s_to > s_from:
        return data * (10 ** (s_to - s_from))
    return _div_round(data, 10 ** (s_from - s_to))


def _div_round(a, b):
    """Integer division rounding half away from zero."""
    if isinstance(b, int):
        bb = b
        habs = abs(b) // 2
    else:
        bb = b
        habs = jnp.abs(b) // 2
    sign = jnp.where(a >= 0, 1, -1) * (1 if isinstance(b, int) and b > 0 else jnp.where(bb >= 0, 1, -1))
    num = jnp.abs(a) + habs
    q = jnp.floor_divide(num, abs(b) if isinstance(b, int) else jnp.abs(bb))
    return be.astype((q * sign), be.dt(a))


def _round_half_away_f(x):
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def _div_shift_exact(a, b, shift: int):
    """round(a * 10^shift / b) exactly in int64, even when a * 10^shift would
    overflow: chunked long division carrying the remainder k digits at a time.
    k=6 is exact while |b| <= 2^43 (r*10^6 must not overflow); a digit-at-a-time
    (k=1) pass covers |b| up to (2^63-1)/10 ~ 9.2e17. Only divisors beyond that
    (>= 18 digits) blend in a float64 result, where the quotient is tiny."""
    sign = be.astype(jnp.where((a >= 0) == (b >= 0), 1, -1), jnp.int64)
    aa = jnp.abs(be.astype(a, jnp.int64))
    bb = jnp.abs(be.astype(b, jnp.int64))

    def longdiv(kmax: int):
        q = jnp.floor_divide(aa, bb)
        r = aa - q * bb
        rem = shift
        while rem > 0:
            k = min(kmax, rem)
            m = 10**k
            q = q * m + jnp.floor_divide(r * m, bb)
            r = (r * m) % bb
            rem -= k
        return q + (2 * r >= bb)

    out = be.astype((longdiv(6) * sign), jnp.int64)
    big = bb > (1 << 43)  # k=6 unsafe: r*10^6 could overflow
    if shift > 0:
        out = jnp.where(big, be.astype((longdiv(1) * sign), jnp.int64), out)
    huge = bb > ((1 << 63) - 1) // 10  # even k=1 unsafe
    if shift <= 18:
        approx = be.astype(_round_half_away_f(
            be.fdiv(aa, bb) * (10.0**shift)
        ), jnp.int64) * sign
        out = jnp.where(huge, approx, out)
    return out


def _cast_from_string(a: SCol, d: Type) -> SCol:
    """A string column cast to `d`: each dictionary entry parsed once on the
    host by PostgreSQL's input rules for `d` (parse_text) into two tables,
    its value and its error code; the codes gather both, and a row whose
    entry is bad raises where it is live and not NULL."""
    assert a.dictionary is not None
    if d.is_string:
        return SCol(d, a.data, a.valid, a.dictionary)
    if d.kind not in _TEXT_TYPE:
        raise EvalError(f"cast string -> {d}")
    vals, codes = [], []
    src = None
    for i, s in enumerate(a.dictionary):
        v, kind = parse_text(str(s), d)
        vals.append(0 if kind else v)
        if kind and _KINDS[kind][1]:  # the message shows the entry
            src = _source_number(a.dictionary) if src is None else src
            if src:
                kind |= (src << _KIND_BITS) | (i << (_KIND_BITS + _SOURCE_BITS))
        codes.append(kind)
    valid = a.valid
    if (d.kind == K.DECIMAL and dec_is_wide(d)
            and not all(INT64_MIN <= v <= INT64_MAX for v in vals)):
        # a value beyond int64: an exact column on the host (a NULL row's
        # code may lie past the dictionary: clamped, as lut_take does)
        host = be.to_host(a.data)
        data = np.take(np.array(vals, dtype=np.object_), host, mode="clip")
        if valid is not None:
            valid = be.to_host(valid)
        codes_at = (np.take(np.asarray(codes, np.int64), host, mode="clip")
                    if any(codes) else None)
    else:
        dtype = np.dtype(np_dtype(d))
        data = be.lut_take(np.array(vals, dtype=dtype), a.data)
        codes_at = (be.lut_take(np.asarray(codes, np.int64), a.data)
                    if any(codes) else None)
    err = None
    if codes_at is not None:
        err = codes_at if valid is None else jnp.where(valid, codes_at, 0)
    return SCol(d, data, valid, None, err)


# PostgreSQL's text input grammar of integers (int4in, int8in: blanks
# around an optional sign and decimal digits), numerics (numeric_in: digits
# with one point and an exponent) and doubles (float8in: those, or infinity
# and NaN)
_INT_TEXT = re.compile(r"\s*[+-]?[0-9]+\s*\Z")
_NUM_TEXT = re.compile(
    r"\s*[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?\s*\Z")
_FLOAT_TEXT = re.compile(
    r"\s*[+-]?(([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?|inf|infinity"
    r"|nan)\s*\Z", re.IGNORECASE)
# the engine's dates and timestamps: ISO year-month-day, then a time (a
# date drops it)
_DATETIME_TEXT = re.compile(
    r"\s*([0-9]{4}-[0-9]{1,2}-[0-9]{1,2})([ T][0-9:.]*)?\s*\Z")
_BOOL_WORDS = (("true", True, 1), ("false", False, 1), ("yes", True, 1),
               ("no", False, 1), ("on", True, 2), ("off", False, 2))


def parse_text(s: str, d: Type):
    """PostgreSQL's input of the text `s` as a value of type `d`: (the value
    in d's physical form, 0), or (None, the kind of PostgreSQL's error,
    _KINDS)."""
    name = _TEXT_TYPE[d.kind]
    bad = (None, _KIND_OF[f'invalid input syntax for type {name}: "{{}}"'])
    if d.kind in (K.INT, K.BIGINT):
        if not _INT_TEXT.match(s):
            return bad
        v = int(s)
        lo, hi = _int_range(d)
        if not lo <= v <= hi:
            return None, _KIND_OF[
                f'value "{{}}" is out of range for type {name}']
        return v, 0
    if d.kind == K.DECIMAL:
        if not _NUM_TEXT.match(s):
            return bad
        v = decimal_str_to_int(s, d.s)
        if abs(v) >= 10**d.p:  # more digits than the type's precision
            return None, _KIND_OF["numeric field overflow"]
        return v, 0
    if d.kind in (K.FLOAT, K.DOUBLE):
        if not _FLOAT_TEXT.match(s):
            return bad
        v = float(s)
        big = 3.4028234663852886e38 if d.kind == K.FLOAT else float("inf")
        if abs(v) >= big and "inf" not in s.lower():
            return None, _KIND_OF[f'"{{}}" is out of range for type {name}']
        return v, 0
    if d.kind == K.BOOL:
        w = s.strip().lower()
        if w in ("1", "0"):
            return w == "1", 0
        for word, value, least in _BOOL_WORDS:
            if len(w) >= least and word.startswith(w):
                return value, 0
        return bad
    m = _DATETIME_TEXT.match(s)
    if m is None:
        return bad
    try:
        if d.kind == K.DATE:
            v = np.datetime64(_norm_date_str(m.group(1)), "D")
        else:
            v = np.datetime64(_norm_date_str(s), "us")
    except ValueError:  # a month or day past its end
        return None, _KIND_OF['date/time field value out of range: "{}"']
    v = be.astype(v - EPOCH, np.int64) if d.kind == K.DATE else be.astype(
        v, np.int64)
    return int(v), 0


def _format_value(v, t: Type) -> str:
    if t.kind == K.DECIMAL and not dec_is_float(t):
        sign = "-" if v < 0 else ""
        v = abs(int(v))
        if t.s == 0:
            return f"{sign}{v}"
        ip, fp = divmod(v, 10**t.s)
        return f"{sign}{ip}.{fp:0{t.s}d}"
    if t.kind == K.DATE:
        return str(EPOCH + np.timedelta64(int(v), "D"))
    if t.kind == K.TIMESTAMP:
        return str(np.datetime64(int(v), "us"))
    if t.kind == K.BOOL:
        return "true" if v else "false"
    if t.kind in (K.FLOAT, K.DOUBLE):
        return repr(float(v))
    return str(v)


def _cast_to_string(a: SCol, d: Type) -> SCol:
    # host roundtrip: pull codes/values, format, re-encode (rare path)
    host = be.to_host(a.data)
    vals = [_format_value(v, a.type) for v in host.reshape(-1)]
    dictionary, codes = strings.encode_strings(vals)
    codes = be.like(codes.reshape(host.shape), a.data)
    return SCol(d, codes, a.valid, dictionary)


# --------------------------------------------------------------------- case
def eval_case(e: CaseExpr, env: dict[int, SCol]) -> SCol:
    t = e.type
    else_c = eval_expr(e.else_, env) if e.else_ is not None else _place(const_scol(None, t), env)
    result, rvalid, rdict = None, None, None
    # normalize string branches onto one dictionary
    branches = [(eval_expr(c, env), eval_expr(v, env)) for c, v in e.whens]
    if t.is_string:
        branches, else_c, rdict = _unify_string_dicts([b for _, b in branches], else_c, branches)
    data = else_c.data
    valid = else_c.valid_mask() if (else_c.valid is not None or else_c.type.kind == K.NULL) else None

    # apply WHENs in reverse so the first match wins; a row raises what
    # it evaluates: the conditions up to the one that holds, then its value
    err = else_c.err
    for cond_c, val_c in reversed(branches):
        m = truth_mask(cond_c)
        data = _where_mixed(m, val_c.data, data)
        vvalid = val_c.valid
        if valid is not None or vvalid is not None:
            va = jnp.ones_like(m) if vvalid is None else (jnp.broadcast_to(vvalid, m.shape) if vvalid.ndim == 0 else vvalid)
            vb = jnp.ones_like(m) if valid is None else (jnp.broadcast_to(valid, m.shape) if valid.ndim == 0 else valid)
            valid = jnp.where(m, va, vb)
        if val_c.err is not None or err is not None:
            err = _pick_err(m, val_c.err, err)
        err = _first_err(cond_c.err, err)
    return SCol(t, data, valid, rdict, err)


def _where_mixed(m, x, y):
    """jnp.where, where a wide (Python-int object) decimal side selects on
    the host."""
    if is_obj(x) or is_obj(y):
        mh = be.to_host(m)
        return np.where(mh, decwide.to_obj(x) if not is_obj(x) else x,
                        decwide.to_obj(y) if not is_obj(y) else y)
    return jnp.where(m, x, y)


def _pick_err(m, a, b):
    """Per-row codes: a's where m holds, else b's (None: no code)."""
    ref = _first_torch(m, a, b)
    a = 0 if a is None else (be.like(a, ref) if ref is not None else a)
    b = 0 if b is None else (be.like(b, ref) if ref is not None else b)
    if isinstance(a, int) and isinstance(b, int):
        return None
    if ref is not None:
        m = be.like(m, ref)
    return jnp.where(m, a, b)


def _unify_string_dicts(vals: list[SCol], else_c: SCol, branches):
    cols = vals + [else_c]
    merged = None
    for c in cols:
        if c.dictionary is None:
            continue
        merged = c.dictionary if merged is None else strings.remap_to_merged(merged, c.dictionary)[0]
    if merged is None:
        merged = np.array([""], dtype=object)
    out_branches = []
    for cond_c, v in branches:
        out_branches.append((cond_c, _remap_string(v, merged)))
    return out_branches, _remap_string(else_c, merged), merged


def _remap_string(c: SCol, merged: np.ndarray) -> SCol:
    if c.dictionary is None:
        return SCol(c.type, c.data, c.valid, merged, c.err)
    remap = be.astype(np.searchsorted(merged, c.dictionary), np.int32)
    return SCol(c.type, be.lut_take(remap, c.data), c.valid, merged, c.err)


# --------------------------------------------------------------------- calls
def eval_call(e: Call, env: dict[int, SCol]) -> SCol:
    op = e.op
    if op == "and":
        return _eval_and([eval_expr(a, env) for a in e.args], e.type)
    if op == "or":
        return _eval_or([eval_expr(a, env) for a in e.args], e.type)
    args = [eval_expr(a, env) for a in e.args]
    if op == "coalesce":
        return _eval_coalesce(args, e.type)
    out = _with_err(_apply_call(e, args), _first_err(*(a.err for a in args)))
    return _beside(out, env) if any(is_obj(a.data) for a in args) else out


def _beside(c: SCol, env) -> SCol:
    """A host result of exact wide arithmetic (a comparison's flags, a value
    int64 holds again) moved beside the environment's tensors: the tensor
    tier's operators combine it with their masks. An object column stays
    on the host."""
    ref = next((x.data for x in env.values() if be.is_torch(x.data)), None)
    if ref is None or is_obj(c.data) or be.is_torch(c.data):
        return c
    return SCol(c.type, be.like(c.data, ref),
                None if c.valid is None else be.like(c.valid, ref),
                c.dictionary, None if c.err is None else be.like(c.err, ref))


def _apply_call(e: Call, args: list[SCol]) -> SCol:
    """A function over its evaluated arguments (their codes are the
    caller's; the result carries only the function's own)."""
    op = e.op
    if op in _STRICT and any(_plan_null(a) for a in e.args):
        return _null_result(e.type, args)
    if op == "not":
        a = args[0]
        return SCol(e.type, ~be.astype(a.data, jnp.bool_), a.valid)
    if op in ("eq", "neq", "lt", "lte", "gt", "gte"):
        return eval_compare(op, args[0], args[1], e.type)
    if op == "nseq":  # null-safe equality: NULL == NULL is TRUE
        a, b = args
        c = eval_compare("eq", a, b, Type.bool_(True))
        va = a.valid_mask() if a.valid is not None else None
        vb = b.valid_mask() if b.valid is not None else None
        both_valid = c.valid if c.valid is not None else None
        eq_and_valid = c.data if both_valid is None else (c.data & both_valid)
        if va is None and vb is None:
            return SCol(e.type, c.data, None)
        both_null = (~va & ~vb) if (va is not None and vb is not None) else False
        return SCol(e.type, eq_and_valid | both_null, None)
    if op in ("add", "sub", "mul", "div", "mod"):
        return eval_arith(op, args[0], args[1], e.type, e)
    if op == "neg":
        a = args[0]
        return SCol(e.type, -a.data, a.valid, None, _int_min_err(a, e.type))
    if op == "isnull":
        a = args[0]
        v = jnp.zeros_like(a.data, dtype=jnp.bool_) if a.valid is None else ~a.valid
        return SCol(e.type, v, None)
    if op == "isnotnull":
        a = args[0]
        v = jnp.ones_like(a.data, dtype=jnp.bool_) if a.valid is None else a.valid
        return SCol(e.type, v, None)
    if op == "nullif":
        a, b = args
        eqc = eval_compare("eq", a, b, Type.bool_(True))
        m = truth_mask(eqc)
        valid = a.valid_mask() & ~m if a.valid is not None else ~m
        return SCol(e.type, a.data, valid, a.dictionary)
    if op == "in":
        return _eval_in(args, e.type)
    if op in ("like", "ilike"):
        return _eval_like(args[0], args[1], e.type, op == "ilike")
    if op in ("date_add", "date_sub"):
        return _eval_date_addsub(op, args[0], e.args[1], args[1], e.type)
    if op.startswith("extract_"):
        part = op[len("extract_"):]
        a = args[0]
        out = dates.extract(part, a.data, a.type.kind == K.TIMESTAMP)
        return SCol(e.type, be.astype(out, jnp.int64), a.valid)
    if op.startswith("datediff_"):
        unit = op[len("datediff_"):]
        a, b = args[0], args[1]
        valid = _and_valid(a, b)

        def us_of(c):
            return be.astype(c.data, jnp.int64) * US_PER_DAY if c.type.kind == K.DATE else be.astype(c.data, jnp.int64)

        diff = us_of(b) - us_of(a)
        per = {"second": 1_000_000, "minute": 60_000_000, "hour": 3_600_000_000,
               "day": US_PER_DAY, "week": US_PER_DAY * 7}
        if unit in per:
            out = diff // per[unit]
        elif unit in ("month", "year", "quarter"):
            am = dates.extract("year", us_of(a) // US_PER_DAY, False) * 12 + dates.extract("month", us_of(a) // US_PER_DAY, False)
            bm = dates.extract("year", us_of(b) // US_PER_DAY, False) * 12 + dates.extract("month", us_of(b) // US_PER_DAY, False)
            m = bm - am
            out = m // 12 if unit == "year" else (m // 3 if unit == "quarter" else m)
        else:
            raise EvalError(f"datediff unit {unit}")
        return SCol(e.type, be.astype(out, jnp.int64), valid)
    if op == "date_trunc":
        part_c, a = args[0], args[1]
        part = str(part_c.dictionary[0]) if part_c.dictionary is not None else "day"
        out = dates.date_trunc(part.lower(), a.data, a.type.kind == K.TIMESTAMP)
        return SCol(e.type, be.astype(out, be.dt(a.data)), a.valid)
    if op == "regexp_replace":
        import re as _re

        a, p, r = args[0], args[1], args[2]
        if not (_is_const_string(p) and _is_const_string(r)):
            raise EvalError("regexp_replace requires constant pattern")
        rx = _re.compile(str(p.dictionary[0]))
        rep = str(r.dictionary[0]).replace("\\0", "\\g<0>")
        new_dict, remap = strings.map_dictionary(a.dictionary, lambda s: rx.sub(rep, s))
        return SCol(e.type, be.lut_take(remap, a.data), a.valid, new_dict)
    if op in ("upper", "lower", "ltrim", "rtrim", "trim", "reverse"):
        return _eval_string_map(op, args[0], e.type)
    if op == "length":
        a = args[0]
        lut = strings.value_lut(a.dictionary, len, np.int64)
        return SCol(e.type, be.lut_take(lut, a.data), a.valid)
    if op == "substring":
        return _eval_substring(args, e.type, e.args)
    if op == "concat":
        return _eval_concat(args, e.type)
    if op == "replace":
        a, frm, to = args
        f, t_ = str(frm.dictionary[0]), str(to.dictionary[0])
        if not f:  # an empty search string matches nothing
            return SCol(e.type, a.data, a.valid, a.dictionary)
        nd, remap = strings.map_dictionary(a.dictionary, lambda s: s.replace(f, t_))
        return SCol(e.type, be.lut_take(remap, a.data), a.valid, nd)
    if op in ("startswith", "endswith"):
        a, p = args
        pat = str(p.dictionary[0])
        fn = (lambda s: s.startswith(pat)) if op == "startswith" else (lambda s: s.endswith(pat))
        lut = strings.predicate_lut(a.dictionary, fn)
        return SCol(e.type, be.lut_take(lut, a.data), _and_valid(a, p))
    if op in ("abs", "floor", "ceil", "sqrt", "exp", "ln", "log10", "sin", "cos"):
        return _eval_math1(op, args[0], e.type)
    if op == "round":
        return _eval_round(args, e.type, e.args)
    if op == "pow":
        a, b = args
        return SCol(e.type, jnp.power(a.data, b.data), _and_valid(a, b))
    if op == "hash":
        from .hashing import hash_columns

        h = hash_columns(args)
        return SCol(e.type, be.astype(h, jnp.int64), None)
    if op.startswith("udf:"):
        return _eval_udf(op[4:], args, e.type)
    raise EvalError(f"unknown op {op}")


def _eval_udf(name: str, args: list[SCol], t: Type) -> SCol:
    """A user-defined function over whole columns, on the host: each
    argument is broadcast to n rows and read back with one copy
    (be.to_host), decoded to the values the function expects (str for a
    dictionary column, datetime.date for DATE, datetime.datetime for
    TIMESTAMP; the reference passes real PyObjects into its
    sub-interpreters, PythonRuntime.cpp), and the result goes to the device
    of the arguments. On the card this is a device -> host -> device round
    trip by design. Inside a fused program be.to_host raises HostRead: the
    program declines, as the reference's trace fails on the same call (the
    executor declines such plans on the host before they run,
    executor._udf_in_exprs)."""
    import datetime as _dt

    call = udfmod_registry_get(name)
    if call is None:
        raise EvalError(f"UDF {name} is not compiled")
    n = max((a.data.shape[0] for a in args if a.data.ndim), default=1)
    dev = be.device_of(*[a.data for a in args])
    host = []
    for a in args:
        h = be.to_host(jnp.broadcast_to(a.data, (n,)))
        if a.dictionary is not None:
            codes = np.clip(h.astype(np.int64), 0, len(a.dictionary) - 1)
            h = np.asarray(a.dictionary, dtype=object)[codes]
        elif a.type.kind == K.DATE:
            epoch = _dt.date(1970, 1, 1)
            h = np.array([epoch + _dt.timedelta(days=int(d)) for d in h],
                         dtype=object)
        elif a.type.kind == K.TIMESTAMP:
            epoch = _dt.datetime(1970, 1, 1)
            h = np.array([epoch + _dt.timedelta(microseconds=int(v))
                          for v in h], dtype=object)
        host.append(h)
    out = call(host)
    valid = _and_valid(*args)
    if t.is_string:
        from ..storage.column import encode_strings

        dct, out = encode_strings([x if isinstance(x, str) else str(x)
                                   for x in out])
        return SCol(t, out if dev is None else be.to_device(out, dev), valid,
                    dct)
    out = np.asarray(out)
    return SCol(t, out if dev is None else be.to_device(out, dev), valid)


_UDF_REGISTRY: dict[str, object] = {}


def udf_register(name: str, call):
    _UDF_REGISTRY[name.lower()] = call


def udfmod_registry_get(name: str):
    return _UDF_REGISTRY.get(name.lower())


def _eval_and(cols: list[SCol], t: Type) -> SCol:
    # Kleene: FALSE dominates NULL. A row evaluates its conjuncts left to
    # right up to the first FALSE one (as PostgreSQL does): it raises only
    # what it evaluates
    val = None
    known_false = None
    all_valid = None
    err = None
    for c in cols:
        if c.err is not None:
            err = _first_err(err, c.err if known_false is None
                             else _pick_err(known_false, None, c.err))
        d = be.astype(c.data, jnp.bool_)
        val = d if val is None else (val & d)
        v = c.valid
        if v is not None:
            kf = ~d & v
            known_false = kf if known_false is None else (known_false | kf)
            all_valid = v if all_valid is None else (all_valid & v)
        else:
            kf = ~d
            known_false = kf if known_false is None else (known_false | kf)
    if all_valid is None:
        return SCol(t, val, None, None, err)
    valid = all_valid | known_false
    return SCol(t, val & valid, valid, None, err)


def _eval_or(cols: list[SCol], t: Type) -> SCol:
    val = None
    known_true = None
    all_valid = None
    any_invalid = None
    err = None
    for c in cols:
        if c.err is not None:  # up to the first TRUE disjunct
            err = _first_err(err, c.err if known_true is None
                             else _pick_err(known_true, None, c.err))
        d = be.astype(c.data, jnp.bool_)
        val = d if val is None else (val | d)
        v = c.valid
        if v is not None:
            kt = d & v
            any_invalid = ~v if any_invalid is None else (any_invalid | ~v)
        else:
            kt = d
        known_true = kt if known_true is None else (known_true | kt)
    if any_invalid is None:
        return SCol(t, val, None, None, err)
    valid = known_true | ~any_invalid
    return SCol(t, known_true | (val & valid), valid, None, err)


def _eval_coalesce(cols: list[SCol], t: Type) -> SCol:
    if t.is_string:
        merged = None
        for c in cols:
            if c.dictionary is not None:
                merged = c.dictionary if merged is None else strings.remap_to_merged(merged, c.dictionary)[0]
        cols = [_remap_string(c, merged) for c in cols]
        rdict = merged
    else:
        rdict = None
    data = cols[-1].data
    valid = cols[-1].valid_mask() if cols[-1].valid is not None else None
    # a row evaluates its arguments up to the first that is not NULL
    err = cols[-1].err
    for c in reversed(cols[:-1]):
        if c.valid is None:
            # non-nullable argument: everything to its left still wins, but the
            # result is definitely non-null from here down
            data, valid = c.data, None
            err = c.err
        else:
            m = c.valid
            data = _where_mixed(m, c.data, data)
            if is_obj(data) and be.is_torch(m):  # on the host, beside data
                m = be.to_host(m)
                valid = None if valid is None else be.to_host(valid)
            if valid is not None:
                valid = m | valid
            # valid None means "all rows valid already": m | all-true stays all-true
            err = _first_err(c.err, _pick_err(m, None, err))
    return SCol(t, data, valid, rdict, err)


def _eval_in(args: list[SCol], t: Type) -> SCol:
    """Three-valued IN: TRUE on any non-null match; NULL when unmatched but
    some comparison was NULL (NULL probe or NULL list item); else FALSE."""
    v, items = args[0], args[1:]
    acc = None
    any_null = None  # per-row: some item comparison evaluated to NULL
    for it in items:
        c = eval_compare("eq", v, it, Type.bool_(True))
        if c.valid is not None:
            m = c.data & c.valid
            any_null = ~c.valid if any_null is None else (any_null | ~c.valid)
        else:
            m = c.data
        acc = m if acc is None else (acc | m)
    valid = None if any_null is None else (acc | ~any_null)
    return SCol(t, acc, valid)


def _eval_like(a: SCol, p: SCol, t: Type, ci: bool) -> SCol:
    if not _is_const_string(p):
        raise EvalError("LIKE with non-constant pattern not supported yet")
    pat = str(p.dictionary[0])
    lut = None
    if be.is_torch(a.data) and len(a.dictionary) >= bytestr.DEVICE_DICT_MIN:
        # high-cardinality dictionary with codes on the tensor tier: match
        # the pattern over the dictionary's byte planes on the codes'
        # device instead of a host loop (reference: StringRuntime.cpp byte
        # matchers); None where the pattern or the data needs the host
        lut = bytestr.device_like_mask(a.dictionary, pat, ci, a.data.device)
    if lut is None:
        lut = strings.like_lut(a.dictionary, pat, ci)
    return SCol(t, be.lut_take(lut, a.data), a.valid)


def _eval_string_map(op: str, a: SCol, t: Type) -> SCol:
    fn = {
        "upper": str.upper,
        "lower": str.lower,
        "ltrim": str.lstrip,
        "rtrim": str.rstrip,
        "trim": str.strip,
        "reverse": lambda s: s[::-1],
    }[op]
    nd, remap = strings.map_dictionary(a.dictionary, fn)
    return SCol(t, be.lut_take(remap, a.data), a.valid, nd)


def _host_int(expr, c: SCol):
    """A constant integer argument's value on the host, None for NULL: read
    from the plan where the argument is a constant expression (its
    evaluated copy may lie on the card, and reading it back would stall the
    stream, and a CUDA graph's capture refuses it)."""
    from .consteval import ConstEvalError, eval_const

    try:
        return eval_const(expr, Type.bigint())
    except ConstEvalError:
        return int(c.data)


def _plan_null(expr) -> bool:
    """True where an argument is a NULL literal of the plan (cast or not),
    decided on the host."""
    while isinstance(expr, Cast):
        expr = expr.arg
    return isinstance(expr, Const) and expr.value is None


# functions that give NULL where any argument is NULL, and read a constant
# argument on the host (a pattern, a search string, digits, a position): a
# NULL literal there gives a NULL column before anything is read
_STRICT = frozenset((
    "like", "ilike", "regexp_replace", "replace", "substring", "startswith",
    "endswith", "round", "date_trunc", "length", "upper", "lower", "ltrim",
    "rtrim", "trim", "reverse"))


def _null_result(t: Type, args: list[SCol]) -> SCol:
    """A column of NULLs of type `t`, as long as the arguments' rows and
    beside them (a 0-dim constant where every argument is one)."""
    t = t.as_nullable()
    ref = next((a.data for a in args if a.data.ndim != 0), None)
    if ref is None:
        return const_scol(None, t)
    n = ref.shape[0]
    like = ref if be.is_torch(ref) else None
    return SCol(t, be.full(n, 0, np_dtype(t), like),
                be.full(n, False, jnp.bool_, like),
                np.array([""], dtype=object) if t.is_string else None)


def _eval_substring(args: list[SCol], t: Type, exprs) -> SCol:
    """PostgreSQL's substring(s, start, length): the characters at the
    positions [start, start + length) that lie inside [1, len(s)]."""
    a, start, ln = args
    if start.data.ndim == 0 and ln.data.ndim == 0:
        s0 = _host_int(exprs[1], start)
        l0 = _host_int(exprs[2], ln)
        if l0 < 0:
            raise EvalError("negative substring length not allowed")
        lo, hi = max(s0 - 1, 0), max(s0 - 1 + l0, 0)

        def fn(s):
            return s[lo:hi]

        nd, remap = strings.map_dictionary(a.dictionary, fn)
        return SCol(t, be.lut_take(remap, a.data), a.valid, nd)
    raise EvalError("substring with per-row start/length not supported yet")


def _eval_concat(args: list[SCol], t: Type) -> SCol:
    # fast path: exactly one non-constant dictionary column
    non_const = [a for a in args if not _is_const_string(a) and a.data.ndim != 0]
    if len(non_const) <= 1 and all(a.dictionary is not None for a in args):
        if not non_const:
            s = "".join(str(a.dictionary[0]) for a in args)
            return const_scol(s, t)
        var = non_const[0]
        pieces = []
        for a in args:
            pieces.append(None if a is var else str(a.dictionary[0]))
        def fn(s):
            return "".join(s if p is None else p for p in pieces)
        nd, remap = strings.map_dictionary(var.dictionary, fn)
        return SCol(t, be.lut_take(remap, var.data), _and_valid(*args), nd)
    # general: host roundtrip
    host = []
    n = max(a.data.shape[0] for a in args if a.data.ndim)
    for a in args:
        codes = be.to_host(jnp.broadcast_to(a.data, (n,)))
        # a NULL row's code may lie outside the dictionary: clamp it, as
        # be.lut_take does
        host.append(np.take(a.dictionary, codes, mode="clip"))
    vals = ["".join(str(x) for x in row) for row in zip(*host)]
    nd, codes = strings.encode_strings(vals)
    valid = _and_valid(*args)
    return SCol(t, be.like(codes, valid if valid is not None else args[0].data), valid, nd)


def _eval_math1(op: str, a: SCol, t: Type) -> SCol:
    d = a.data
    if op == "abs":
        return SCol(t, jnp.abs(d), a.valid, None, _int_min_err(a, t))
    if op == "floor":
        if t.kind == K.DECIMAL and not dec_is_float(t):
            f = 10**t.s
            return SCol(t, jnp.floor_divide(d, f) * f, a.valid)
        return SCol(t, jnp.floor(d), a.valid)
    if op == "ceil":
        if t.kind == K.DECIMAL and not dec_is_float(t):
            f = 10**t.s
            return SCol(t, -jnp.floor_divide(-d, f) * f, a.valid)
        return SCol(t, jnp.ceil(d), a.valid)
    fn = {"sqrt": jnp.sqrt, "exp": jnp.exp, "ln": jnp.log, "log10": jnp.log10,
          "sin": jnp.sin, "cos": jnp.cos}[op]
    return SCol(t, fn(be.astype(d, jnp.float64)), a.valid)


def _eval_round(args: list[SCol], t: Type, exprs) -> SCol:
    a = args[0]
    digits = _host_int(exprs[1], args[1]) if len(args) > 1 else 0
    if t.kind == K.DECIMAL and not dec_is_float(t):
        if digits >= t.s:
            return a
        f = 10 ** (t.s - digits)
        return SCol(t, _div_round(a.data, f) * f, a.valid)
    if t.kind in (K.INT, K.BIGINT):
        return a
    f = 10.0**digits
    return SCol(t, _round_half_away_f(a.data * f) / f, a.valid)


# ----------------------------------------------------------------- comparisons
def eval_compare(op: str, a: SCol, b: SCol, t: Type) -> SCol:
    valid = _and_valid(a, b)
    if a.type.is_string or b.type.is_string:
        return _compare_strings(op, a, b, t, valid)
    x, y = _align_numeric(a, b)
    fn = {
        "eq": jnp.equal, "neq": jnp.not_equal, "lt": jnp.less,
        "lte": jnp.less_equal, "gt": jnp.greater, "gte": jnp.greater_equal,
    }[op]
    out = fn(x, y)
    if is_obj(out):
        # exact comparison of wide decimals on the host; the flags and
        # their validity go back beside the tensors of the table
        ref = _first_torch(a.data, b.data, valid)
        out = be.like(out.astype(np.bool_), ref)
        if valid is not None and ref is not None:
            valid = be.like(valid, ref)
    return SCol(t, out, valid)


def _align_numeric(a: SCol, b: SCol):
    """Bring two numeric/date columns to directly comparable tensors."""
    ta, tb = a.type, b.type
    if ta.kind == K.DECIMAL or tb.kind == K.DECIMAL:
        fa = ta.kind == K.DECIMAL and dec_is_float(ta)
        fb = tb.kind == K.DECIMAL and dec_is_float(tb)
        if fa or fb or ta.kind in (K.FLOAT, K.DOUBLE) or tb.kind in (K.FLOAT, K.DOUBLE):
            va = be.fdiv(a.data, 10.0**ta.s) if (ta.kind == K.DECIMAL and not fa) else a.data
            vb = be.fdiv(b.data, 10.0**tb.s) if (tb.kind == K.DECIMAL and not fb) else b.data
            return be.astype(va, jnp.float64), be.astype(vb, jnp.float64)
        sa = ta.s if ta.kind == K.DECIMAL else 0
        sb = tb.s if tb.kind == K.DECIMAL else 0
        s = max(sa, sb)
        if is_obj(a.data) or is_obj(b.data):
            # exact wide comparison in Python ints
            va = decwide.to_obj(a.data) * (10 ** (s - sa))
            vb = decwide.to_obj(b.data) * (10 ** (s - sb))
            return va, vb
        va = be.astype(a.data, jnp.int64) * (10 ** (s - sa))
        vb = be.astype(b.data, jnp.int64) * (10 ** (s - sb))
        return va, vb
    return a.data, b.data


def _compare_strings(op: str, a: SCol, b: SCol, t: Type, valid) -> SCol:
    # const vs column: use sorted-dictionary order directly
    if _is_const_string(b) and not _is_const_string(a):
        return _compare_col_const(op, a, str(b.dictionary[0]), t, valid)
    if _is_const_string(a) and not _is_const_string(b):
        flipped = {"eq": "eq", "neq": "neq", "lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte"}[op]
        return _compare_col_const(flipped, b, str(a.dictionary[0]), t, valid)
    if _is_const_string(a) and _is_const_string(b):
        import operator

        f = {"eq": operator.eq, "neq": operator.ne, "lt": operator.lt,
             "lte": operator.le, "gt": operator.gt, "gte": operator.ge}[op]
        return SCol(t, jnp.asarray(f(str(a.dictionary[0]), str(b.dictionary[0]))), valid)
    # two columns: same dictionary -> code compare; else remap to merged
    ca, cb = a, b
    if a.dictionary is not b.dictionary:
        merged, ra, rb = strings.remap_to_merged(a.dictionary, b.dictionary)
        ca = SCol(a.type, be.lut_take(ra, a.data), a.valid, merged)
        cb = SCol(b.type, be.lut_take(rb, b.data), b.valid, merged)
    fn = {
        "eq": jnp.equal, "neq": jnp.not_equal, "lt": jnp.less,
        "lte": jnp.less_equal, "gt": jnp.greater, "gte": jnp.greater_equal,
    }[op]
    return SCol(t, fn(ca.data, cb.data), valid)


def _compare_col_const(op: str, a: SCol, v: str, t: Type, valid) -> SCol:
    if a.type.kind == K.CHAR:
        v = v.rstrip()  # char(N) semantics: trailing-space-insensitive
    left, right, present = strings.const_code_bounds(a.dictionary, v)
    c = a.data
    if op == "eq":
        out = (c == left) if present else jnp.zeros_like(c, dtype=jnp.bool_)
    elif op == "neq":
        out = (c != left) if present else jnp.ones_like(c, dtype=jnp.bool_)
    elif op == "lt":
        out = c < left
    elif op == "lte":
        out = c < right
    elif op == "gt":
        out = c >= right
    else:  # gte
        out = c >= left
    return SCol(t, out, valid)


# ----------------------------------------------------------------- arithmetic
def eval_arith(op: str, a: SCol, b: SCol, t: Type, e=None) -> SCol:
    """`a` op `b` of type `t`; `e`, the call's expression where there is
    one, gives the operands' bounds (ops/bounds.py) and marks rows that need
    the exact path."""
    valid = _and_valid(a, b)
    ta, tb = a.type, b.type
    # interval +- interval
    if ta.kind == K.INTERVAL or tb.kind == K.INTERVAL:
        f = jnp.add if op == "add" else jnp.subtract
        return SCol(t, f(a.data, b.data), valid)
    if ta.kind == K.DATE and tb.kind == K.DATE and op == "sub":
        return SCol(t, be.astype((be.astype(a.data, jnp.int64) - be.astype(b.data, jnp.int64)), jnp.int32), valid)
    a = dataclasses.replace(a, data=_int_scalar(a.data))
    b = dataclasses.replace(b, data=_int_scalar(b.data))
    if t.kind == K.DECIMAL:
        return _decimal_arith(op, a, b, t, valid, e)
    if t.kind in (K.INT, K.BIGINT) and op in ("add", "sub", "mul") and not (
            is_obj(a.data) or is_obj(b.data)):
        return _int_arith(op, a, b, t, valid, e)
    x = be.astype(a.data, np_dtype(t)) if be.dt(a.data) != np_dtype(t) else a.data
    y = be.astype(b.data, np_dtype(t)) if be.dt(b.data) != np_dtype(t) else b.data
    if op == "add":
        return SCol(t, x + y, valid)
    if op == "sub":
        return SCol(t, x - y, valid)
    if op == "mul":
        return SCol(t, x * y, valid)
    if op == "div":
        if t.is_integer:
            zero = y == 0
            q = _div_trunc_arr(x, jnp.where(zero, 1, y))
            err = None
            if t.kind in (K.INT, K.BIGINT):
                # the one quotient beyond the range: MIN / -1
                err = _err_where((x == _int_range(t)[0]) & (y == -1), valid,
                                 _range_code(t))
            valid = _mask_and(valid, ~zero)
            return SCol(t, q, valid, None, err)
        zero = y == 0
        out = x / jnp.where(zero, 1, y)
        valid = _mask_and(valid, ~zero)
        return SCol(t, out, valid)
    if op == "mod":
        zero = y == 0
        ysafe = jnp.where(zero, 1, y)
        r = x - _div_trunc_arr(x, ysafe) * ysafe
        valid = _mask_and(valid, ~zero)
        return SCol(t, r, valid)
    raise EvalError(op)


def _int_range(t: Type) -> tuple[int, int]:
    bits = 32 if t.kind == K.INT else 64
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def _range_code(t: Type) -> int:
    return ERR_INT if t.kind == K.INT else ERR_BIGINT


def _int_min_err(a: SCol, t: Type):
    """The codes of -x and abs(x) of an INT or BIGINT: the type's least
    value has no opposite (None for other types)."""
    if t.kind not in (K.INT, K.BIGINT) or is_obj(a.data):
        return None
    return _err_where(a.data == _int_range(t)[0], a.valid, _range_code(t))


def _int_arith(op: str, a: SCol, b: SCol, t: Type, valid, e) -> SCol:
    """INT / BIGINT +, -, * with PostgreSQL's overflow errors: in int64
    where the operands' bounds prove every row fits, else through the
    checked kernel (one pass: each row's value and its code)."""
    lo, hi = _int_range(t)
    ea, eb = (None, None) if e is None else e.args
    if bounds.fits(op, _bound(ea, a), _bound(eb, b), 0, 0, 0, lo, hi):
        x, y = be.astype(a.data, np.int64), be.astype(b.data, np.int64)
        r = x + y if op == "add" else (x - y if op == "sub" else x * y)
        return SCol(t, be.astype(r, np_dtype(t)), valid)
    return _checked(t, op, a.data, b.data, valid, 0, 0, 0, lo, hi,
                    _range_code(t))


def _bound(expr, c: SCol):
    """The bound of an operand (its expression's, or its type's), within
    what its storage holds."""
    b = bounds.bound(expr, c.type)
    if b is None or is_obj(c.data):
        return b
    bits = 8 * np.dtype(be.dt(c.data)).itemsize
    if bits > 64 or not np.issubdtype(be.dt(c.data), np.integer):
        return b
    return (max(b[0], -(1 << (bits - 1))), min(b[1], (1 << (bits - 1)) - 1))


def _div_trunc_arr(x, y):
    with np.errstate(over="ignore"):  # MIN / -1 wraps (an error, above)
        q = jnp.floor_divide(jnp.abs(x), jnp.abs(y))
        return be.astype((q * jnp.sign(x) * jnp.sign(y)), be.dt(x))


def _mask_and(valid, extra):
    if valid is None:
        return extra
    return valid & extra


def _dec_logical(c: SCol):
    """(tensor, scale) with tensor int64-scaled or float64 logical."""
    t = c.type
    if t.kind == K.DECIMAL:
        if dec_is_float(t):
            return c.data, None  # float logical value
        return c.data, t.s
    if t.kind in (K.FLOAT, K.DOUBLE):
        return be.astype(c.data, jnp.float64), None
    return be.astype(c.data, jnp.int64), 0


def _decimal_arith(op: str, a: SCol, b: SCol, t: Type, valid, e=None) -> SCol:
    xa, sa = _dec_logical(a)
    xb, sb = _dec_logical(b)
    from .backend import is_torch

    # rescale constants beyond 18 digits cannot exist in int64: such ops MUST
    # go exact (mul result scale far below/above operand-scale sum happens in
    # deeply-derived decimal types, e.g. tpcxbb q23's variance over AVGs)
    big_shift = (
        sa is not None and sb is not None
        and ((op in ("add", "sub", "mod")
              and max(abs(t.s - sa), abs(t.s - sb)) > 18)
             or (op == "mul" and abs(t.s - (sa + sb)) > 18)
             # a remainder at a scale below an operand's (a type cut to 38
             # digits) never comes to int64's rescale
             or (op == "mod" and t.s < max(sa, sb))
             # wide division: the quotient a*10^shift/b routinely exceeds
             # int64 (12.51 at scale 19 wraps negative); magnitude is not
             # statically knowable, so wide result types always go exact
             or (op == "div" and dec_is_wide(t))))
    exact = (sa is not None and sb is not None and (
        is_obj(xa) or is_obj(xb)
        or (dec_is_wide(t) and not (is_torch(xa) or is_torch(xb)))
        or big_shift))
    checks = (sa is not None and sb is not None
              and op in ("add", "sub", "mul", "mod") and not exact)
    if checks:
        ea, eb = (None, None) if e is None else e.args
        if op == "mul" and t.s > sa + sb:
            # a product scaled up: int64 where the bounds prove it, else
            # exactly on the host (the checked kernel never scales up)
            exact = not bounds.fits(op, _bound(ea, a), _bound(eb, b), sa, sb,
                                    t.s, INT64_MIN, INT64_MAX)
            checks = False
        elif goes_exact(e):
            exact, checks = True, False
        elif bounds.fits(op, _bound(ea, a), _bound(eb, b), sa, sb, t.s,
                         INT64_MIN, INT64_MAX):
            checks = False  # the int64 operators below are exact
    if checks:
        # each row's exact result where int64 holds it, and a mark where it
        # does not: the consumer runs the statement again with this
        # expression on the exact host path (on the host, at once)
        out = _checked(t, op, xa, xb, valid, sa, sb, t.s, INT64_MIN,
                       INT64_MAX, _exact_code(e))
        if not _marks_exact(out):
            if op == "mod":  # a divisor of 0 gives NULL (no code)
                nonzero = be.like(xb, out.data) != 0
                out = dataclasses.replace(
                    out, valid=_mask_and(out.valid, nonzero))
            return out
        exact = True
    if exact:
        # a side needs >63 bits, the host-resident result type may, the
        # rescale constant itself overflows int64, or a row's result passed
        # int64: compute exactly in Python ints (overflow-detected by
        # construction — the reference's i128 path,
        # LowerToStd.cpp:128-330)
        data, zero = decwide.arith(
            op, decwide.to_obj(xa), decwide.to_obj(xb), sa, sb, t.s)
        ref = _first_torch(xa, xb, valid)
        if zero is not None:
            if is_torch(valid):
                valid = be.to_host(valid)
            valid = _mask_and(valid, ~zero)
        return _exact_result(t, data, valid, ref)
    if dec_is_float(t) or sa is None or sb is None:
        va = be.fdiv(xa, 10.0**sa) if sa else be.astype(xa, jnp.float64)
        vb = be.fdiv(xb, 10.0**sb) if sb else be.astype(xb, jnp.float64)
        if op == "add":
            out = va + vb
        elif op == "sub":
            out = va - vb
        elif op == "mul":
            out = va * vb
        elif op == "div":
            zero = vb == 0
            out = va / jnp.where(zero, 1.0, vb)
            valid = _mask_and(valid, ~zero)
        else:
            zero = vb == 0
            out = va - jnp.trunc(va / jnp.where(zero, 1.0, vb)) * vb
            valid = _mask_and(valid, ~zero)
        if not dec_is_float(t):
            out = be.astype(_round_half_away_f(out * (10.0**t.s)), jnp.int64)
        return SCol(t, out, valid)
    s = t.s
    if op in ("add", "sub"):
        va = xa * (10 ** (s - sa)) if s >= sa else _div_round(xa, 10 ** (sa - s))
        vb = xb * (10 ** (s - sb)) if s >= sb else _div_round(xb, 10 ** (sb - s))
        return SCol(t, va + vb if op == "add" else va - vb, valid)
    if op == "mul":
        prod = xa * xb  # scale sa+sb
        ps = sa + sb
        out = prod * (10 ** (s - ps)) if s >= ps else _div_round(prod, 10 ** (ps - s))
        return SCol(t, out, valid)
    if op == "div":
        # out = a/b at scale s: a*10^(s - sa + sb) / b. The scale shift can
        # exceed what int64 holds (e.g. AVG's divide at scale 18), so the
        # quotient is computed by exact chunked long division (the reference
        # uses i128 arithmetic here, LowerToStd.cpp:128-330).
        shift = s - sa + sb
        zero = xb == 0
        bsafe = jnp.where(zero, 1, xb)
        if shift >= 0:
            q = _div_shift_exact(xa, bsafe, shift)
        else:
            q = _div_round(_div_round(xa, 10**-shift), bsafe)
        valid = _mask_and(valid, ~zero)
        return SCol(t, q, valid)
    if op == "mod":
        va = xa * (10 ** (s - sa))
        vb = xb * (10 ** (s - sb))
        zero = vb == 0
        vbs = jnp.where(zero, 1, vb)
        r = va - _div_trunc_arr(va, vbs) * vbs
        valid = _mask_and(valid, ~zero)
        return SCol(t, r, valid)
    raise EvalError(op)


def _eval_date_addsub(op: str, a: SCol, iv_expr: BExpr, iv: SCol, t: Type) -> SCol:
    sign = 1 if op == "date_add" else -1
    valid = _and_valid(a, iv)
    if iv.type.unit == IntervalUnit.MONTH:
        months = be.astype(iv.data, jnp.int64) * sign
        if a.type.kind == K.DATE:
            out = dates.add_months_days(a.data, months)
            return SCol(t, be.astype(out, jnp.int32), valid)
        days = jnp.floor_divide(a.data, US_PER_DAY)
        rem = a.data - days * US_PER_DAY
        out = dates.add_months_days(days, months) * US_PER_DAY + rem
        return SCol(t, out, valid)
    us = be.astype(iv.data, jnp.int64) * sign
    if a.type.kind == K.DATE:
        out = be.astype(a.data, jnp.int64) + us // US_PER_DAY
        return SCol(t, be.astype(out, jnp.int32), valid)
    return SCol(t, a.data + us, valid)


def _norm_date_str(v: str) -> str:
    """Normalize non-zero-padded ISO dates (accepted by the reference's date
    parser, mlir-support/parsing.cpp) for numpy: 2002-2-1 -> 2002-02-01."""
    import re as _re

    m = _re.match(r"^(\d{4})-(\d{1,2})-(\d{1,2})(.*)$", v.strip())
    if m:
        return f"{m.group(1)}-{int(m.group(2)):02d}-{int(m.group(3)):02d}{m.group(4)}"
    return v.strip()
