"""HyperLogLog distinct-count sketches (numpy, vectorized).

Parity with the reference's sketch (include/lingodb/utility/HyperLogLog.h:
p=6, m=64 registers, tau/sigma bias-free estimator from Ertl's paper —
src/utility/HyperLogLog.cpp:41-56).  Registers are built from our splitmix64
column hashes, so register *contents* differ from a reference-built sketch of
the same data (different hash function) — estimates and the serialized layout
are compatible, which is what the catalog interop needs.
"""

from __future__ import annotations

import math

import numpy as np

P = 6
M = 1 << P          # 64 registers
Q = 64 - P
# fold in bounded chunks: fresh multi-hundred-MB numpy temporaries cost
# seconds of page faulting in this environment, while 32MB chunks recycle
# through the allocator at full speed (60x measured difference at 60M rows)
CHUNK = 1 << 22


def new_counts() -> np.ndarray:
    """(register, rank) occupancy accumulator for fold_hashes."""
    return np.zeros(M * 64, np.int64)


def fold_hashes(hashes: np.ndarray, counts: np.ndarray) -> None:
    """Accumulate one batch of uint64 hashes into a (register, rank)
    occupancy table (reference: HyperLogLog::add, HyperLogLog.h:24-29:
    register index = top p bits, rank = clz((h << p) | 1 << (p-1)) + 1)."""
    for lo_i in range(0, len(hashes), CHUNK):
        h = hashes[lo_i:lo_i + CHUNK].astype(np.uint64, copy=False)
        idx = (h >> np.uint64(Q)).astype(np.int64)
        # shifted = (h << p) | (1 << (p-1)): the or-term caps rank at q+1
        shifted = (h << np.uint64(P)) | np.uint64(1 << (P - 1))
        # clz via bit_length: frexp-free log2 on 32-bit halves keeps every
        # value float64-exact
        hi = (shifted >> np.uint64(32)).astype(np.float64)
        lo = (shifted & np.uint64(0xFFFFFFFF)).astype(np.float64)
        bl = np.where(
            hi > 0,
            np.floor(np.log2(np.maximum(hi, 1))) + 33,
            np.floor(np.log2(np.maximum(lo, 1))) + 1,
        )
        rank = (64 - bl + 1).astype(np.int64)  # clz + 1, <= q+1 = 59 < 64
        counts += np.bincount((idx << 6) | rank, minlength=M * 64)


def registers_from_counts(counts: np.ndarray) -> np.ndarray:
    """Each register's highest non-empty rank (max-per-register via one
    bincount pass — np.maximum.at is ~30x slower at scale)."""
    nz = counts.reshape(M, 64) > 0
    regs = np.where(nz.any(axis=1), 63 - np.argmax(nz[:, ::-1], axis=1), 0)
    return regs.astype(np.uint8)


def registers_from_hashes(hashes: np.ndarray) -> np.ndarray:
    """Fold a uint64 hash array into m=64 HLL registers."""
    counts = new_counts()
    fold_hashes(hashes, counts)
    return registers_from_counts(counts)


def _sigma(x: float) -> float:
    if x == 1.0:
        return math.inf
    y, z = 1.0, x
    while True:
        x *= x
        z_prime = z
        z += x * y
        y += y
        if z_prime == z:
            return z


def _tau(x: float) -> float:
    if x == 0.0 or x == 1.0:
        return 0.0
    y, z = 1.0, 1.0 - x
    while True:
        x = math.sqrt(x)
        z_prime = z
        y *= 0.5
        z -= (1 - x) ** 2 * y
        if z_prime == z:
            return z / 3


def estimate(registers: np.ndarray | bytes) -> float:
    """Ertl estimator (reference: HyperLogLog::estimate, HyperLogLog.cpp:41)."""
    regs = np.frombuffer(registers, dtype=np.uint8) if isinstance(registers, bytes) else registers
    c = np.bincount(regs.astype(np.int64), minlength=Q + 2)
    z = M * _tau((M - c[Q + 1]) / M)
    for k in range(Q, 0, -1):
        z += c[k]
        z *= 0.5
    z += M * _sigma(c[0] / M)
    return (M * M / (2.0 * math.log(2))) / z


def merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)
