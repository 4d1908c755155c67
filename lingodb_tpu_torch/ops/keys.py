"""Order-preserving integer key images for sorting/grouping.

Every SQL type maps to integer tensors whose ascending order equals the SQL
ordering (strings already have this property by sorted-dictionary
construction, storage/column.py). Used by sort, group-by, set ops and joins
(reference analogue: the comparator/eq/combine callback functions the
SubOpToControlFlow lowering generates per state, SubOpToControlFlow.cpp:
1685,1800; here we need total orders as data, not code)."""

from __future__ import annotations

import numpy as np

from . import backend as be
from .backend import multi_sort
from .backend import xnp as jnp

from ..runtime.vtable import SCol
from ..sql.types import K


def order_image(c: SCol) -> jnp.ndarray:
    """Signed-int image with the same ascending order as the column values.
    (NULLs are not encoded here — callers pair this with a null flag.)"""
    d = c.data
    if be.dt(d) == jnp.bool_:
        return be.astype(d, jnp.int32)
    if be.dt(d) == jnp.float64:
        bits = be.view_as(d, jnp.int64)
        return jnp.where(bits < 0, ~bits + (-0x8000000000000000), bits)
    if be.dt(d) == jnp.float32:
        bits = be.view_as(d, jnp.int32)
        return jnp.where(bits < 0, ~bits + (-0x80000000), bits)
    return d


def order_images(c: SCol) -> list:
    """One or more int images whose lexicographic order equals the column
    order. Wide (Python-int object) decimal columns decompose into three
    int64 radix limbs; every other type is a single image."""
    import numpy as np

    d = c.data
    if isinstance(d, np.ndarray) and be.dt(d) == np.object_:
        from . import decwide

        return decwide.order_images(d)
    return [order_image(c)]


def null_flag(c: SCol, nulls_first: bool) -> jnp.ndarray | None:
    if c.valid is None:
        return None
    return jnp.where(c.valid, 1, 0) if nulls_first else jnp.where(c.valid, 0, 1)


def descending(img: jnp.ndarray) -> jnp.ndarray:
    """Flip order without overflow: bitwise not."""
    if be.dt(img) == jnp.bool_:
        return ~img
    return ~img


def sort_operands(key_cols: list[tuple[SCol, bool, bool | None]]) -> list:
    """Integer operand list whose lexicographic ascending order equals the
    requested multi-key SQL order (null flags interleaved, descending keys
    bit-flipped). Shared by the local sort path and the distributed
    sample-sort's range partitioning."""
    operands = []
    for c, asc, nf in key_cols:
        if nf is None:
            nf = not asc
        f = null_flag(c, nf)
        if f is not None:
            operands.append(f)
        for img in order_images(c):
            if f is not None:
                # NULL rows carry arbitrary underlying values: zero their
                # image so they don't break ties ahead of later sort keys
                img = jnp.where(c.valid, img, jnp.zeros((), be.dt(img)))
            if not asc:
                img = descending(img)
            operands.append(img)
    return operands


def sort_permutation(key_cols: list[tuple[SCol, bool, bool | None]], n: int) -> jnp.ndarray:
    """Stable sort permutation for multi-key ORDER BY.

    key_cols: (col, ascending, nulls_first?) — nulls_first None means SQL
    default (last when ascending, first when descending)."""
    operands = sort_operands(key_cols)
    operands.append(be.iota(n, jnp.int64, next((o for o in operands if be.is_torch(o)), None)))
    operands = [jnp.broadcast_to(o, (n,)) for o in operands]
    res = multi_sort(operands, num_keys=len(operands))  # full-key: stable
    return res[-1]


def topk_priority(c: SCol, ascending: bool, nulls_first: bool | None,
                  rows_ok) -> jnp.ndarray | None:
    """int64 priority image for in-program TopK candidate selection: LARGER
    priority = EARLIER in the requested order. Tiers: padding rows (beyond
    the group count) sit at INT64_MIN; NULL rows at MIN+1 (nulls last) or
    MAX (nulls first); real values saturate into [MIN+2, MAX-1]. Saturation
    can merge adjacent extreme values — merging only creates TIES, which the
    caller's exactness check (candidate count at the cutoff) converts into a
    safe fallback, never a wrong result. Returns None when the column has no
    single-int order image (wide host decimals)."""
    if nulls_first is None:
        nulls_first = not ascending
    imgs = order_images(c)
    if len(imgs) != 1:
        return None
    img = be.astype(imgs[0], jnp.int64)
    if ascending:
        img = ~img  # order-reversing, overflow-free
    lo64 = -(1 << 63)
    hi64 = (1 << 63) - 1
    if c.valid is None:
        pr = jnp.clip(img, lo64 + 2, hi64 - 1)
    elif nulls_first:
        pr = jnp.where(c.valid, jnp.clip(img, lo64 + 2, hi64 - 1),
                       hi64)
    else:
        pr = jnp.where(c.valid, jnp.clip(img, lo64 + 2, hi64 - 1),
                       lo64 + 1)
    return jnp.where(rows_ok, pr, lo64)


def grouping_images(key_cols: list[SCol]) -> list[jnp.ndarray]:
    """Key images for grouping: NULL is a regular distinct value (SQL GROUP BY
    semantics: NULLs form one group)."""
    out = []
    for c in key_cols:
        f = null_flag(c, nulls_first=False)
        if f is not None:
            out.append(f)
        for img in order_images(c):
            if c.valid is not None:
                # neutralize NULL payloads so all NULLs compare equal
                img = jnp.where(c.valid, img, jnp.zeros_like(img))
            out.append(img)
    return out
