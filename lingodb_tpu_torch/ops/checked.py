"""Checked integer and decimal arithmetic: each row's exact result and its
error code in one pass (csrc/checked_arith.cu on the card).

    checked_arith(op, x, y, valid, sx, sy, s, lo, hi, code_range,
                  prec=0, code_prec=0, out_dtype=torch.int64, digits=0)
        -> (value, code)

op is "add", "sub", "mul", "mod", "cast" or "cast_f" (the two casts: y
None). x and y are int32 or int64 (a decimal as its unscaled value at scale
sx, sy), each a column or a 0-dim scalar broadcast over the rows; for
cast_f x is float32 or float64. Every row's result R is exact:

    add, sub   rescale(x, sx, s) +- rescale(y, sy, s)
    mul        rescale(x * y, sx + sy, s)
    mod        rescale(x, sx, s) % rescale(y, sy, s), the truncated
               remainder (the dividend's sign, as PostgreSQL's); 0 where
               the divisor is 0 (the caller makes such a row NULL)
    cast       rescale(x, sx, s)
    cast_f     |x| rounded to `digits` significant digits, half to even on
               its exact binary value (printf's "%.*g": PostgreSQL's
               float8_numeric at DBL_DIG = 15, float4_numeric at FLT_DIG =
               6), then to scale s half away from zero, with x's sign;
               NaN and infinities are bad at the precision

rescale multiplies by 10^k up, or divides by 10^k rounding half away from
zero (PostgreSQL's numeric rounding). A row is bad where prec > 0 and |R| >=
10^prec (a DECIMAL(prec, s) cannot hold it), or where R lies outside
[lo, hi] (the storage: int32, int64). Its value is 0 and, where it is valid
(not NULL), its code is code_prec or code_range; every other row holds R
and code 0. The codes are int32; a NULL row's code is 0 whatever its value.

Each shift |s - sx|, |s - sy| (mul: sx + sy - s; cast_f: s) is at most 18,
mul never scales up (s <= sx + sy) and mod never down (s >= sx, sy): then
every intermediate fits 128 bits (ops/scalar.py sends the rest to the exact
host path before this).

On a CUDA tensor the wrapper launches the kernel (one launch a call,
counted in pgather.LAUNCHES["checked_arith"], or in a CUDA graph's capture
tally) or raises; it never takes the plain version there. On CPU tensors and
numpy arrays it takes the plain version, checked_arith_plain: the int64
(cast_f: float64) operations, a conservative test on float64 magnitudes
that picks the rows whose result or intermediates could come near a limit
(cast_f: whose rounding the float cannot decide), and those rows alone
evaluated in Python ints and decimals (read to the host: on the card the
plain version runs only where chip_smoke.py holds the kernel against it).
Its values and codes equal the kernel's bit for bit.
"""

from __future__ import annotations

import decimal
import math

import numpy as np
import torch

OPS = {"add": 0, "sub": 1, "mul": 2, "cast": 3, "mod": 4, "cast_f": 5}
MAX_SHIFT = 18
# the significant digits PostgreSQL keeps casting a float to numeric:
# DBL_DIG for a double, FLT_DIG for a real
FLOAT_DIGITS = {torch.float64: 15, torch.float32: 6}
_BLOCKS_PER_SM = 8


def check_shifts(op: str, sx: int, sy: int, s: int) -> bool:
    """Whether (op, scales) lies inside what the kernel computes exactly."""
    if op == "mul":
        return 0 <= sx + sy - s <= MAX_SHIFT
    if op == "mod":
        return 0 <= s - sx <= MAX_SHIFT and 0 <= s - sy <= MAX_SHIFT
    if op == "cast":
        return abs(s - sx) <= MAX_SHIFT
    if op == "cast_f":
        return 0 <= s <= MAX_SHIFT
    return abs(s - sx) <= MAX_SHIFT and abs(s - sy) <= MAX_SHIFT


# ------------------------------------------------------------ exact (host)
def _rescale(v: int, a: int, b: int) -> int:
    if b >= a:
        return v * 10 ** (b - a)
    d = 10 ** (a - b)
    q = (abs(v) * 2 + d) // (2 * d)
    return q if v >= 0 else -q


_CTX = decimal.Context(prec=400, Emax=10**6, Emin=-10**6)


def float_result(v: float, digits: int, s: int) -> int | None:
    """A float cast to scale s as PostgreSQL casts it (cast_f): None for NaN
    and the infinities."""
    if not math.isfinite(v):
        return None
    d = decimal.Decimal(f"%.{digits}g" % v).scaleb(s, context=_CTX)
    return int(d.quantize(decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP,
                          context=_CTX))


def exact_result(op: str, x, y, sx: int, sy: int, s: int,
                 digits: int = 0) -> int | None:
    """One row's exact R in Python ints (cast_f: x a float; None for NaN
    and the infinities)."""
    if op == "cast_f":
        return float_result(x, digits, s)
    if op == "cast":
        return _rescale(x, sx, s)
    if op == "mul":
        return _rescale(x * y, sx + sy, s)
    a, b = _rescale(x, sx, s), _rescale(y, sy, s)
    if op == "mod":
        if b == 0:
            return 0
        r = abs(a) % abs(b)
        return r if a >= 0 else -r
    return a + b if op == "add" else a - b


def classify(r: int | None, lo: int, hi: int, code_range: int, prec: int,
             code_prec: int) -> tuple[int, int]:
    """(value, code) of an exact R before its validity: 0 and the code
    where it is bad (R None: a NaN or infinity, bad at the precision)."""
    if r is None:
        return 0, code_prec
    if prec and abs(r) >= 10**prec:
        return 0, code_prec
    if r < lo or r > hi:
        return 0, code_range
    return r, 0


# ------------------------------------------------------------ plain version
def _as_tensor(a):
    if a is None or isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _int64_path(op, x, y, sx, sy, s):
    """The results in int64, wrapping where they do not fit."""
    def up_or_down(v, a, b):
        if b >= a:
            return v * (10 ** (b - a))
        return _div_round(v, 10 ** (a - b))

    if op == "cast":
        return up_or_down(x, sx, s)
    if op == "mul":
        return up_or_down(x * y, sx + sy, s)
    a, b = up_or_down(x, sx, s), up_or_down(y, sy, s)
    if op == "mod":
        # fmod truncates; a divisor of 0 gives 0, and one of -1 (whose
        # remainder is 0) divides as 1, so that INT64_MIN % -1 cannot trap
        one = (b == 0) | (b == -1)
        r = torch.fmod(a, torch.where(one, torch.ones_like(b), b))
        return torch.where(b == 0, torch.zeros_like(r), r)
    return a + b if op == "add" else a - b


def _float_path(x, s: int, digits: int):
    """cast_f in float64 and int64: the results these decide (0 elsewhere),
    their magnitudes' estimate, and the rows they cannot decide."""
    f = x.to(torch.float64)
    ax = f.abs()
    t = ax * (10.0**s)
    # (a) the float's own answer, |x| * 10^s rounded: |x| rounded to
    # `digits` digits moves by at most half a unit of its last digit, 0.5 *
    # 10^(E + 1 - digits) (E + 2 bounds its exponent E from above, log10's
    # error included), and t is off |x| * 10^s by its own rounding: a row
    # decides where both stay below its distance to the nearest half (NaN
    # and the infinities never do)
    e = torch.floor(torch.log10(ax))
    moved = 0.5 * torch.pow(10.0, e + (3 - digits + s)) + t * 2.0**-50
    done_a = (t < 2.0**52) & ((t - torch.floor(t) - 0.5).abs() > moved)
    r = torch.floor(t + 0.5)
    # (b) the digits first, where a double resolves them (a real's six):
    # v = |x| * 10^(digits - 1 - E) in [10^(digits-1), 10^digits), D its
    # rounding half to even, then D * 10^(E - digits + 1 + s) in int64
    # (0, NaN and the infinities: any finite E, decided by (a) or not at all)
    e = torch.where(torch.isfinite(e), e, torch.zeros_like(e))
    e = e + (ax * torch.pow(10.0, digits - 1 - e) >= 10.0**digits).to(
        e.dtype)
    e = e - (ax * torch.pow(10.0, digits - 1 - e) < 10.0**(digits - 1)).to(
        e.dtype)
    v = ax * torch.pow(10.0, digits - 1 - e)
    margin = v * 2.0**-45
    done_b = (~done_a & (v >= 10.0**(digits - 1) + margin)
              & (v < 10.0**digits - margin)
              & ((v - torch.floor(v) - 0.5).abs() > margin))
    d = torch.round(v)  # half to even, away from the ties done_b leaves out
    shift = (e - digits + 1 + s).clamp(-19, 19).to(torch.int64)
    p10 = torch.pow(10, shift.abs().clamp(0, 18))
    up = d.to(torch.int64) * p10
    half = p10 // 2
    down = torch.where(shift < -18, torch.zeros_like(up),
                       torch.div(d.to(torch.int64) + half, p10,
                                 rounding_mode="floor"))
    done_b = done_b & (shift.abs() <= 18) & ((shift < 0) | (
        d * 10.0**shift.clamp(min=0).to(torch.float64) < 2.0**62))
    rb = torch.where(shift >= 0, up, down).to(torch.float64)
    r = torch.where(done_a, r, torch.where(done_b, rb, torch.zeros_like(r)))
    r = torch.where(f < 0, -r, r)
    decided = done_a | done_b
    return r.to(torch.int64), t, ~decided


def _mod_by_digits(x, y, sx, sy, s):
    """mod in int64 wherever the divisor at scale s is below 2^59: the
    dividend's remainder, then its rescale by 10^(s - sx) taken one digit
    at a time modulo the divisor (each step below 2^63); 0 for a divisor of
    0. Returns the results and the rows it cannot take."""
    b = y * (10 ** (s - sy)) if s > sy else y
    fb = y.to(torch.float64).abs() * (10.0 ** (s - sy))
    small = fb < 2.0**59
    bs = torch.where(small & (b != 0) & (b != -1), b, torch.ones_like(b))
    r = torch.fmod(x, bs).abs()
    m = bs.abs()
    for _ in range(s - sx):
        r = torch.fmod(r * 10, m)
    r = torch.where(x < 0, -r, r)
    return torch.where(b == 0, torch.zeros_like(r), r), ~small


def _div_round(v, d: int):
    q = torch.floor_divide(v.abs() + d // 2, d)
    return torch.where(v >= 0, q, -q)


def _magnitude(op, x, y, sx, sy, s):
    """Float64 estimates, from above up to rounding, of the largest
    magnitude among a row's int64 intermediates and of its result."""
    def scaled(f, a):  # |v| rescaled from scale a to s
        return f * (10.0 ** (s - a))

    fx = x.to(torch.float64).abs()
    if op == "cast":
        return torch.maximum(fx, scaled(fx, sx)), scaled(fx, sx)
    fy = y.to(torch.float64).abs()
    if op == "mul":
        p = fx * fy
        return p, scaled(p, sx + sy)
    a, b = scaled(fx, sx), scaled(fy, sy)
    inter = torch.maximum(torch.maximum(fx, a), torch.maximum(fy, b))
    if op == "mod":  # |R| < |b| and |R| <= |a|
        return inter, torch.minimum(a, b)
    return torch.maximum(inter, a + b), a + b


def checked_arith_plain(op, x, y, valid, sx, sy, s, lo, hi, code_range,
                        prec=0, code_prec=0, out_dtype=torch.int64,
                        digits=0):
    """The plain version of checked_arith, on any device (numpy in, numpy
    out): reads the candidate rows to the host."""
    host = not isinstance(x, torch.Tensor) and not isinstance(
        y, torch.Tensor)
    x, y, valid = _as_tensor(x), _as_tensor(y), _as_tensor(valid)
    dev = x.device
    y = None if y is None else y.to(dev)
    valid = None if valid is None else valid.to(dev)
    shape = torch.broadcast_shapes(
        x.shape, *(() if y is None else (y.shape,)),
        *(() if valid is None else (valid.shape,)))
    limit = 0.999 * min(hi, -lo)
    if prec:
        limit = min(limit, 0.999 * 10.0**prec)
    yy = None
    if op == "cast_f":
        xx = x.to(torch.float64).expand(shape)
        r, result, cand = _float_path(xx, s, digits)
        cand = cand | (result + 1.0 >= limit)
    else:
        xx = x.to(torch.int64).expand(shape)
        yy = None if y is None else y.to(torch.int64).expand(shape)
        inter, result = _magnitude(op, xx, yy, sx, sy, s)
        if op == "mod":
            r, cand = _mod_by_digits(xx, yy, sx, sy, s)
            cand = cand | (result + 1.0 >= limit)
        else:
            r = _int64_path(op, xx, yy, sx, sy, s)
            # (+1: a rescale that divides rounds up by at most one)
            cand = (inter >= 2.0**61) | (result + 1.0 >= limit)
    value = r.clone().contiguous()
    code = torch.zeros(shape, dtype=torch.int32, device=dev)
    at = torch.nonzero(cand.reshape(-1)).reshape(-1)
    if at.numel():
        xs = xx.reshape(-1)[at].tolist()
        ys = None if yy is None else yy.reshape(-1)[at].tolist()
        got = [classify(exact_result(op, xs[j], None if ys is None else ys[j],
                                     sx, sy, s, digits),
                        lo, hi, code_range, prec, code_prec)
               for j in range(len(xs))]
        value.view(-1)[at] = torch.tensor([v for v, _c in got],
                                          dtype=torch.int64, device=dev)
        code.view(-1)[at] = torch.tensor([c for _v, c in got],
                                         dtype=torch.int32, device=dev)
    if valid is not None:
        code = torch.where(valid.expand(shape), code, torch.zeros_like(code))
    value = value.to(out_dtype)
    if host:
        return value.numpy(), code.numpy()
    return value, code


# ------------------------------------------------------------ kernel route
def _operand(t, n: int, what: str, floats: bool = False):
    """(pointer, byte width, element stride) of an operand on the card: a
    column of n rows or a 0-dim scalar (stride 0)."""
    kinds = ((torch.float32, torch.float64) if floats else
             (torch.int32, torch.int64, torch.bool, torch.uint8))
    if t.dtype not in kinds:
        raise ValueError(f"checked_arith: {what} must be "
                         + ("float32 or float64" if floats
                            else "int32 or int64"))
    if t.ndim == 0:
        return t.data_ptr(), t.element_size(), 0
    if t.ndim != 1 or int(t.shape[0]) != n:
        raise ValueError(f"checked_arith: {what} must be 0-dim or of the "
                         f"rows' length")
    return t.data_ptr(), t.element_size(), t.stride(0)


def checked_arith(op, x, y, valid, sx, sy, s, lo, hi, code_range, prec=0,
                  code_prec=0, out_dtype=torch.int64, digits=0):
    """See the module's docstring."""
    if op not in OPS:
        raise ValueError(f"checked_arith: unknown op {op!r}")
    if (op in ("cast", "cast_f")) != (y is None):
        raise ValueError("checked_arith: the casts take one operand, the "
                         "others two")
    if not check_shifts(op, sx, sy, s):
        raise ValueError(f"checked_arith: scales {sx}, {sy} -> {s} out of "
                         f"the kernel's range for {op}")
    if op == "cast_f" and not (1 <= digits <= 17 and prec > 0):
        raise ValueError("checked_arith: cast_f needs digits in 1..17 and a "
                         "precision")
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        return checked_arith_plain(op, x, y, valid, sx, sy, s, lo, hi,
                                   code_range, prec, code_prec, out_dtype,
                                   digits)
    from . import cuda_build
    from . import pgather as pg

    dev = x.device
    for t in (y, valid):
        if t is not None and (not isinstance(t, torch.Tensor)
                              or t.device != dev):
            raise ValueError("checked_arith: operands on different devices")
    shape = torch.broadcast_shapes(
        x.shape, *(() if y is None else (y.shape,)),
        *(() if valid is None else (valid.shape,)))
    if len(shape) > 1:
        raise ValueError("checked_arith: 1-D columns only")
    n = int(shape[0]) if shape else 1
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    code = torch.empty(shape, dtype=torch.int32, device=dev)
    if n == 0:
        return out, code
    xp, xw, xs = _operand(x, n, "x", floats=op == "cast_f")
    yp, yw, ys = (0, 8, 0) if y is None else _operand(y, n, "y")
    if valid is None:
        vp, vs = 0, 0
    else:
        vp, _vw, vs = _operand(valid, n, "valid")
    lib = cuda_build.lib("checked_arith")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        err = lib.ldb_checked_arith(
            OPS[op], n, xp, xw, xs, yp, yw, ys, vp, vs, sx, sy, s, lo, hi,
            code_range, prec, code_prec, digits, out.data_ptr(),
            out.element_size(), code.data_ptr(), sms * _BLOCKS_PER_SM,
            torch.cuda.current_stream(dev).cuda_stream)
    pg._launched("checked_arith")
    if err != 0:
        raise RuntimeError(f"checked_arith: CUDA launch failed with error "
                           f"{err}")
    return out, code


def int64_passes(op, x, y, sx, sy, s):
    """The wrapping int64 result alone, in PyTorch's own operators (what the
    operators computed before the checked kernel, without any check): the
    library call timed beside the kernel. cast_f: torch.round(x * 10^s),
    the binary value rounded (half to even) with no digits kept."""
    if op == "cast_f":
        return torch.round(x.to(torch.float64) * (10.0**s)).to(torch.int64)
    xx = x.to(torch.int64)
    yy = None if y is None else y.to(torch.int64)
    return _int64_path(op, xx, yy, sx, sy, s)
