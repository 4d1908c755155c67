"""Vectorized 64-bit hashing of column sets.

Equivalent of the reference's runtime hash support
(reference: src/runtime/Hash.cpp, include/lingodb/runtime/helpers.h — CRC
combine + varlen hashing called per tuple). Here: murmur-style finalizer over
whole columns, combined across key columns; strings hash their dictionary
codes (dictionaries are per-column stable, so equal codes <=> equal strings
within a column; cross-column joins remap through a merged dictionary first,
see ops/join.py).

The arithmetic is that of unsigned 64-bit integers. numpy arrays use uint64
directly. torch has no complete uint64 kernel set, so tensors carry the same
bit patterns in int64: multiplication, addition, xor and left shift agree bit
for bit between the two's-complement and the unsigned reading, and the
logical right shift is written as an arithmetic shift followed by a mask.
Hashes of tensors are therefore int64 tensors whose `.view(uint64)` equals
the numpy result; callers only sort, search and compare them for equality."""

from __future__ import annotations

import numpy as np
import torch

from . import backend as be

_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB
_GOLD = 0x9E3779B97F4A7C15
NULL_BUCKET = 0xFFFFFFFFFFFFFFFF  # sentinel hash for NULL-keyed build rows


def _s64(v: int) -> int:
    """The int64 whose bit pattern equals unsigned 64-bit v."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def as_hash_const(v: int, like):
    """Constant `v` (unsigned 64-bit) in the representation of hash `like`."""
    return _s64(v) if be.is_torch(like) else np.uint64(v)


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x):
    """Murmur/splitmix finalizer, uint64 -> uint64, vectorized."""
    if be.is_torch(x):
        x = x.to(torch.int64)
        x = (x ^ _lsr(x, 30)) * _s64(_C1)
        x = (x ^ _lsr(x, 27)) * _s64(_C2)
        return x ^ _lsr(x, 31)
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_C1)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_C2)
    x = x ^ (x >> np.uint64(31))
    return x


def _to_u64(data):
    if getattr(data, "dtype", None) == np.object_:
        # wide (Python-int) decimals: fold 64-bit limbs (equal values hash
        # equal; joins verify candidates exactly so collisions are safe)
        M = (1 << 64) - 1
        flat = data.reshape(-1)
        folded = np.fromiter(
            ((int(v) & M) ^ ((int(v) >> 64) & M) ^ ((int(v) >> 128) & M)
             for v in flat),
            dtype=np.uint64, count=flat.size)
        return folded.reshape(data.shape)
    if be.is_torch(data):
        if data.dtype.is_floating_point:
            # bitcast so -0.0 == 0.0 hash equal: normalize -0 to +0 first
            d = torch.where(data == 0, torch.zeros_like(data), data)
            return d.to(torch.float64).view(torch.int64)
        return data.to(torch.int64)
    if data.dtype == np.bool_:
        return data.astype(np.uint64)
    if data.dtype in (np.float32, np.float64):
        d = np.where(data == 0, np.zeros_like(data), data)
        bits = np.asarray(d, np.float64).view(np.int64)
        return bits.astype(np.uint64)
    return data.astype(np.int64).astype(np.uint64)


def hash_column(data, valid=None):
    h = splitmix64(_to_u64(data))
    if valid is not None:
        # NULLs get a distinct fixed hash
        h = be.xnp.where(valid, h, as_hash_const(_GOLD, h))
    return h


def combine(h1, h2):
    """Order-dependent combine (boost::hash_combine style)."""
    if be.is_torch(h1) or be.is_torch(h2):
        dev = be.device_of(h1, h2)
        h1, h2 = _as_i64_tensor(h1, dev), _as_i64_tensor(h2, dev)
        return splitmix64(h1 ^ (h2 + _s64(_GOLD) + (h1 << 6) + _lsr(h1, 2)))
    return splitmix64(h1 ^ (h2 + np.uint64(_GOLD) + (h1 << np.uint64(6)) + (h1 >> np.uint64(2))))


def _as_i64_tensor(h, device):
    if be.is_torch(h):
        return h
    return be.to_device(np.asarray(h).astype(np.uint64).view(np.int64), device)


def hash_columns(cols):
    """Hash a list of SCol into one 64-bit value per row (uint64 array, or
    int64 tensor with the same bits)."""
    h = None
    for c in cols:
        hc = hash_column(c.data, c.valid)
        h = hc if h is None else combine(h, hc)
    return h
