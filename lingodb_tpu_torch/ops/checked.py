"""Checked integer and decimal arithmetic: each row's exact result and its
error code in one pass (csrc/checked_arith.cu on the card).

    checked_arith(op, x, y, valid, sx, sy, s, lo, hi, code_range,
                  prec=0, code_prec=0, out_dtype=torch.int64)
        -> (value, code)

op is "add", "sub", "mul" or "cast" (y None). x and y are int32 or int64
(a decimal as its unscaled value at scale sx, sy), each a column or a 0-dim
scalar broadcast over the rows. Every row's result R is exact:

    add, sub   rescale(x, sx, s) +- rescale(y, sy, s)
    mul        rescale(x * y, sx + sy, s)
    cast       rescale(x, sx, s)

rescale multiplies by 10^k up, or divides by 10^k rounding half away from
zero (PostgreSQL's numeric rounding). A row is bad where prec > 0 and |R| >=
10^prec (a DECIMAL(prec, s) cannot hold it), or where R lies outside
[lo, hi] (the storage: int32, int64). Its value is 0 and, where it is valid
(not NULL), its code is code_prec or code_range; every other row holds R
and code 0. The codes are int32; a NULL row's code is 0 whatever its value.

Each shift |s - sx|, |s - sy| (mul: sx + sy - s) is at most 18, and mul
never scales up (s <= sx + sy): then every intermediate fits 128 bits
(ops/scalar.py sends the rest to the exact host path before this).

On a CUDA tensor the wrapper launches the kernel (one launch a call,
counted in pgather.LAUNCHES["checked_arith"], or in a CUDA graph's capture
tally) or raises; it never takes the plain version there. On CPU tensors and
numpy arrays it takes the plain version, checked_arith_plain: the int64
operations, a conservative test on float64 magnitudes that picks the rows
whose result or intermediates could come near a limit (candidates), and
those rows alone evaluated in Python ints (read to the host: on the card
the plain version runs only where chip_smoke.py holds the kernel against
it). Its values and codes equal the kernel's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

OPS = {"add": 0, "sub": 1, "mul": 2, "cast": 3}
MAX_SHIFT = 18
_BLOCKS_PER_SM = 8


def check_shifts(op: str, sx: int, sy: int, s: int) -> bool:
    """Whether (op, scales) lies inside what the kernel computes exactly."""
    if op == "mul":
        return 0 <= sx + sy - s <= MAX_SHIFT
    if op == "cast":
        return abs(s - sx) <= MAX_SHIFT
    return abs(s - sx) <= MAX_SHIFT and abs(s - sy) <= MAX_SHIFT


# ------------------------------------------------------------ exact (host)
def _rescale(v: int, a: int, b: int) -> int:
    if b >= a:
        return v * 10 ** (b - a)
    d = 10 ** (a - b)
    q = (abs(v) * 2 + d) // (2 * d)
    return q if v >= 0 else -q


def exact_result(op: str, x: int, y, sx: int, sy: int, s: int) -> int:
    """One row's exact R in Python ints."""
    if op == "cast":
        return _rescale(x, sx, s)
    if op == "mul":
        return _rescale(x * y, sx + sy, s)
    a, b = _rescale(x, sx, s), _rescale(y, sy, s)
    return a + b if op == "add" else a - b


def classify(r: int, lo: int, hi: int, code_range: int, prec: int,
             code_prec: int) -> tuple[int, int]:
    """(value, code) of an exact R before its validity: 0 and the code
    where it is bad."""
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
    return a + b if op == "add" else a - b


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
    return torch.maximum(inter, a + b), a + b


def checked_arith_plain(op, x, y, valid, sx, sy, s, lo, hi, code_range,
                        prec=0, code_prec=0, out_dtype=torch.int64):
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
    xx = x.to(torch.int64).expand(shape)
    yy = None if y is None else y.to(torch.int64).expand(shape)
    r = _int64_path(op, xx, yy, sx, sy, s)
    limit = 0.999 * min(hi, -lo)
    if prec:
        limit = min(limit, 0.999 * 10.0**prec)
    inter, result = _magnitude(op, xx, yy, sx, sy, s)
    # (+1: a rescale that divides rounds up by at most one)
    cand = (inter >= 2.0**61) | (result + 1.0 >= limit)
    value = r.clone().contiguous()
    code = torch.zeros(shape, dtype=torch.int32, device=dev)
    at = torch.nonzero(cand.reshape(-1)).reshape(-1)
    if at.numel():
        xs = xx.reshape(-1)[at].tolist()
        ys = None if yy is None else yy.reshape(-1)[at].tolist()
        got = [classify(exact_result(op, xs[j], None if ys is None else ys[j],
                                     sx, sy, s),
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
def _operand(t, n: int, what: str):
    """(pointer, byte width, element stride) of an operand on the card: a
    column of n rows or a 0-dim scalar (stride 0)."""
    if t.dtype not in (torch.int32, torch.int64, torch.bool, torch.uint8):
        raise ValueError(f"checked_arith: {what} must be int32 or int64")
    if t.ndim == 0:
        return t.data_ptr(), t.element_size(), 0
    if t.ndim != 1 or int(t.shape[0]) != n:
        raise ValueError(f"checked_arith: {what} must be 0-dim or of the "
                         f"rows' length")
    return t.data_ptr(), t.element_size(), t.stride(0)


def checked_arith(op, x, y, valid, sx, sy, s, lo, hi, code_range, prec=0,
                  code_prec=0, out_dtype=torch.int64):
    """See the module's docstring."""
    if op not in OPS:
        raise ValueError(f"checked_arith: unknown op {op!r}")
    if (op == "cast") != (y is None):
        raise ValueError("checked_arith: cast takes one operand, the others "
                         "two")
    if not check_shifts(op, sx, sy, s):
        raise ValueError(f"checked_arith: scales {sx}, {sy} -> {s} out of "
                         f"the kernel's range for {op}")
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        return checked_arith_plain(op, x, y, valid, sx, sy, s, lo, hi,
                                   code_range, prec, code_prec, out_dtype)
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
    xp, xw, xs = _operand(x, n, "x")
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
            code_range, prec, code_prec, out.data_ptr(), out.element_size(),
            code.data_ptr(), sms * _BLOCKS_PER_SM,
            torch.cuda.current_stream(dev).cuda_stream)
    pg._launched("checked_arith")
    if err != 0:
        raise RuntimeError(f"checked_arith: CUDA launch failed with error "
                           f"{err}")
    return out, code


def int64_passes(op, x, y, sx, sy, s):
    """The wrapping int64 result alone, in PyTorch's own operators (what the
    operators computed before the checked kernel, without any check): the
    library call timed beside the kernel."""
    xx = x.to(torch.int64)
    yy = None if y is None else y.to(torch.int64)
    return _int64_path(op, xx, yy, sx, sy, s)
