"""Exact wide-decimal kernels: host object arrays of Python ints.

Decimals whose precision or scale exceeds 18 cannot always be held in a
scaled int64. The reference computes those in i128
(reference: src/compiler/Dialect/DB/Transforms/... DBToStd lowering,
LowerToStd.cpp:128-330, and runtime DecimalRuntime). The accelerator has no native
i128, so this engine uses a tiered representation:

  - physical int64 whenever the actual values fit (the common case; device
    programs, including the fused pipelines, run on these unchanged);
  - host numpy object arrays of Python ints (arbitrary precision — a strict
    superset of i128) whenever a literal, load, or host-side arithmetic
    result needs more than 63 bits. Object columns never upload to the
    device; every operator that meets one runs its numpy twin.

All helpers here operate on object arrays (or scalars) of Python ints that
represent `value * 10**scale`.
"""

from __future__ import annotations

import numpy as np

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)


def to_obj(a) -> np.ndarray:
    """Any int array (numpy int64, tensor, or object) -> object array of
    PYTHON ints (np.int64 scalars would silently wrap in arithmetic)."""
    if isinstance(a, np.ndarray) and a.dtype == np.object_:
        return a
    if not isinstance(a, np.ndarray):
        from .backend import to_host

        a = to_host(a)
    return np.array(a.tolist(), dtype=np.object_)


def obj_scalar(v: int) -> np.ndarray:
    return np.array(int(v), dtype=np.object_)


def fits_int64(a: np.ndarray) -> bool:
    if a.size == 0:
        return True
    flat = a.reshape(-1)
    return all(INT64_MIN <= int(v) <= INT64_MAX for v in flat)


def demote_if_possible(a):
    """Object array -> int64 numpy when every value fits (keeps downstream
    device paths available); otherwise the object array unchanged. Accepts
    bare Python ints too (0-d object arrays decay to ints in arithmetic)."""
    if not isinstance(a, np.ndarray):
        a = np.asarray(a, dtype=np.object_)
    if fits_int64(a):
        return a.astype(np.int64)
    return a


def div_round(a, b):
    """Elementwise round-half-away-from-zero division of Python-int arrays.
    b may be a scalar int or an array; b == 0 entries must be pre-masked."""
    # sign as object dtype: int64 signs would wrap huge Python-int products
    sign = np.where(
        (a >= 0) == (np.asarray(b, dtype=np.object_) >= 0), 1, -1
    ).astype(np.object_)
    aa = abs(a)
    bb = abs(np.asarray(b, dtype=np.object_))
    q = (2 * aa + bb) // (2 * bb)
    return q * sign


def div_trunc(a, b):
    """Elementwise divide truncating toward zero (SQL integer semantics)."""
    sign = np.where(
        (a >= 0) == (np.asarray(b, dtype=np.object_) >= 0), 1, -1
    ).astype(np.object_)
    return (abs(a) // abs(np.asarray(b, dtype=np.object_))) * sign


def rescale(a, s_from: int, s_to: int):
    if s_to == s_from:
        return a
    if s_to > s_from:
        return a * (10 ** (s_to - s_from))
    return div_round(a, 10 ** (s_from - s_to))


def arith(op: str, a, b, sa: int, sb: int, s_out: int):
    """Exact scaled arithmetic on object arrays. Returns (data, zero_mask)
    where zero_mask flags division/modulo by zero (result rows to NULL)."""
    if op == "add":
        return rescale(a, sa, s_out) + rescale(b, sb, s_out), None
    if op == "sub":
        return rescale(a, sa, s_out) - rescale(b, sb, s_out), None
    if op == "mul":
        return rescale(a * b, sa + sb, s_out), None
    if op in ("div", "mod"):
        zero = np.asarray(b == 0, dtype=bool)
        bsafe = np.where(zero, np.ones_like(np.asarray(b, dtype=np.object_)), b)
        if op == "div":
            # a/b at scale s_out = round(a * 10^(s_out - sa + sb) / b)
            shift = s_out - sa + sb
            num = a * (10**shift) if shift >= 0 else div_round(a, 10**-shift)
            return div_round(num, bsafe), zero
        va = rescale(a, sa, s_out)
        vb = rescale(b, sb, s_out)
        vbs = np.where(zero, np.ones_like(vb), vb)
        r = va - div_trunc(va, vbs) * vbs
        return r, zero
    raise ValueError(op)


def order_images(a: np.ndarray) -> list[np.ndarray]:
    """Three int64 images whose lexicographic order equals the numeric order
    of arbitrarily wide (< 2^124-bit) Python ints: the base-2^62 radix
    decomposition (hi uses arithmetic shift, so sign order is preserved)."""
    M = (1 << 62) - 1
    hi = a >> 124
    mid = (a >> 62) & M
    lo = a & M
    return [hi.astype(np.int64), mid.astype(np.int64), lo.astype(np.int64)]


def combine_limb_sums(hi, lo):
    """hi * 2^32 + lo exactly, for sums of int64 values split into their
    high (signed) and low (unsigned 32-bit) limbs over fewer than 2^30
    rows: int64 beside `hi` where every total fits (one read of one flag),
    else a host object array (both limbs read)."""
    from . import backend as be

    if not bool(be.to_host((abs(hi) < (1 << 30)).all())):
        return demote_if_possible(combine_limbs(be.to_host(hi),
                                                be.to_host(lo)))
    return hi * (1 << 32) + lo


def combine_limbs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Exact recombination of device 32-bit-split sum accumulators:
    total = sum(v >> 32) * 2^32 + sum(v & 0xFFFFFFFF), both in int64 lanes
    (exact for any int64 inputs and up to 2^30 rows per segment)."""
    return to_obj(hi) * (1 << 32) + to_obj(lo)
