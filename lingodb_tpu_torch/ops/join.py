"""Join kernels: equi-join candidate generation + verification.

Equivalent of the reference's hash-join lowerings
(reference: RelAlgToSubOp.cpp:1306-1588 — hashmultimap / hash_indexed_view
build+probe with semi/anti/outer/single/mark variants; runtime
LazyJoinHashtable.cpp). Pointer-bucket hash tables don't map to wide
vector hardware; instead:

  build:  hash build keys -> sort (hash, row) once
  probe:  hash probe keys -> two searchsorted calls give per-row candidate
          ranges -> CSR expansion to candidate pairs (one host sync for the
          total); key equality is then VERIFIED exactly on the pairs, so hash
          collisions never affect correctness.

All variants (inner/semi/anti/left/full/single/mark) reduce to the candidate
pair list + segment reductions over probe rows."""

from __future__ import annotations

from . import backend as be
import numpy as np

from .backend import xnp as jnp

from ..runtime.vtable import SCol
from . import hashing


def _searchsorted(sorted_arr, vals, side):
    return jnp.searchsorted(sorted_arr, vals, side=side)


def candidate_pairs(build_keys: list[SCol], probe_keys: list[SCol], n_build: int, n_probe: int,
                    null_safe: tuple = ()):
    """Return (probe_idx, build_idx) candidate pair arrays (device) and the
    pair count (host int). Rows with NULL in a key never produce pairs —
    except keys marked null_safe (IS NOT DISTINCT FROM semantics), whose NULLs
    hash to a shared sentinel and therefore match each other."""
    if n_build == 0 or n_probe == 0:
        z = jnp.zeros((0,), jnp.int64)
        return z, z, 0
    hb = hashing.hash_columns(build_keys)
    hp = hashing.hash_columns(probe_keys)
    if not null_safe:
        null_safe = (False,) * len(build_keys)
    strict_b = [c for c, ns in zip(build_keys, null_safe) if not ns]
    strict_p = [c for c, ns in zip(probe_keys, null_safe) if not ns]
    bvalid = _all_valid(strict_b, n_build)
    pvalid = _all_valid(strict_p, n_probe)
    if bvalid is not None:
        # push NULL-keyed build rows to a sentinel bucket
        hb = jnp.where(bvalid, hb, hashing.as_hash_const(hashing.NULL_BUCKET, hb))
    res = be.multi_sort([hb, be.iota(n_build, jnp.int64, hb)], num_keys=1)
    sorted_h, perm = res
    start = _searchsorted(sorted_h, hp, "left")
    end = _searchsorted(sorted_h, hp, "right")
    counts = end - start
    if pvalid is not None:
        counts = jnp.where(pvalid, counts, 0)
    total = int(jnp.sum(counts))
    if total == 0:
        z = jnp.zeros((0,), jnp.int64)
        return z, z, 0
    offs_incl = jnp.cumsum(counts)
    offs_excl = offs_incl - counts
    pos = be.iota(total, be.dt(offs_incl), offs_incl)
    probe_of = _searchsorted(offs_incl, pos, "right")
    within = pos - jnp.take(offs_excl, probe_of)
    build_slot = jnp.take(start, probe_of) + within
    build_row = jnp.take(perm, build_slot)
    return be.astype(probe_of, jnp.int64), be.astype(build_row, jnp.int64), total


def _all_valid(cols: list[SCol], n: int):
    out = None
    for c in cols:
        if c.valid is not None:
            out = c.valid if out is None else (out & c.valid)
    return out


def matched_flags(idx: jnp.ndarray, mask: jnp.ndarray, n: int) -> jnp.ndarray:
    """For each of n rows: True iff any pair with that row index passes mask."""
    if idx.shape[0] == 0:
        return be.full(n, False, jnp.bool_, mask)
    return be.segment_max(
        be.astype(mask, jnp.int32), be.astype(idx, jnp.int32), num_segments=n
    ) > 0


def first_match(idx: jnp.ndarray, mask: jnp.ndarray, n: int):
    """For each row: position (into the pair arrays) of its first passing
    pair, and a found flag. Used for single joins (scalar subqueries)."""
    if idx.shape[0] == 0:
        return be.full(n, 0, jnp.int64, mask), be.full(n, False, jnp.bool_, mask)
    big = jnp.iinfo(jnp.int64).max
    pos = be.iota(idx.shape[0], jnp.int64, idx)
    cand = jnp.where(mask, pos, big)
    first = be.segment_min(cand, be.astype(idx, jnp.int32), num_segments=n)
    found = first < big
    return jnp.where(found, first, 0), found


def match_count(idx: jnp.ndarray, mask: jnp.ndarray, n: int) -> jnp.ndarray:
    if idx.shape[0] == 0:
        return be.full(n, 0, jnp.int64, mask)
    return be.segment_sum(be.astype(mask, jnp.int64), be.astype(idx, jnp.int32), num_segments=n)
