"""Window functions.

Equivalent of the reference's window lowering
(reference: WindowLowering RelAlgToSubOp.cpp:2193 -- buffer + sorted/continuous
views + segment-tree views for frame aggregates; runtime SegmentTreeView.cpp).
Plan: sort rows by (partition, order) once; partitions become segments;
  - ranking fns: positional arithmetic over the sorted order
  - whole-partition aggregates: segment reduce + broadcast back
  - running frames (unbounded preceding .. current row): segmented prefix
    scans (cumsum / doubling scans) -- the O(log n) parallel equivalent of
    the reference's segment trees
  - bounded ROWS frames: windowed difference of prefix sums
  - min/max over general frames: a sparse table, O(1) per row
Results scatter back to the original row order.

Written against the numpy-named facade of ops/backend.py: host-tier tables
run through numpy, device tables through torch on their own device. Every
array a function makes is made beside its inputs (be.iota / be.full), never
as a host array meeting a tensor.
"""

from __future__ import annotations

import numpy as np

from . import backend as be
from .backend import xnp as jnp

from ..plan import logical as L
from ..runtime.vtable import (SCol, VTable, dec_is_float, dec_is_wide, is_obj,
                               np_dtype)
from ..sql.types import K, Type
from . import keys as keymod


def run_window(op: L.Window, vt: VTable) -> VTable:
    n = vt.num_rows
    if n == 0:
        ref = _ref(vt)
        cols = dict(vt.cols)
        for f in op.funcs:
            cols[f.out.cid] = SCol(
                f.out.type, be.full(0, 0, np_dtype(f.out.type), ref), None)
        return VTable(cols, 0)

    part_cols = [vt.col(c) for c in op.partition_by]
    order_keys = [(vt.col(k.cid), k.ascending, k.nulls_first) for k in op.order_by]

    # one global sort: partition keys (as equality groups) then order keys,
    # then the row index, so that ties keep their input order
    operands = []
    for c in part_cols:
        operands.extend(keymod.grouping_images([c]))
    n_part_ops = len(operands)
    for c, asc, nf in order_keys:
        if nf is None:
            nf = not asc
        f = keymod.null_flag(c, nf)
        if f is not None:
            operands.append(f)
        # order_images decomposes wide (Python-int object) decimal keys into
        # int64 radix limbs; plain types yield one image
        for img in keymod.order_images(c):
            if f is not None:
                # NULL rows carry arbitrary underlying values: zero their
                # image so they don't split peer groups or break ties
                img = jnp.where(c.valid, img, jnp.zeros_like(img))
            operands.append(img if asc else keymod.descending(img))
    ref = _ref(vt)
    iota = be.iota(n, jnp.int64, ref)
    res = be.multi_sort(operands + [iota], num_keys=len(operands) + 1)
    perm = res[-1]
    sorted_part = res[:n_part_ops]
    sorted_order = res[n_part_ops:-1]
    ref = perm

    # partition boundaries in sorted space
    first = be.first_true(n, like=ref)
    pb = first
    for s in sorted_part:
        pb = pb | _starts(s, ref)
    seg = jnp.cumsum(be.astype(pb, jnp.int64)) - 1
    num_parts = int(seg[-1]) + 1
    pos = be.iota(n, jnp.int64, ref)
    part_start, part_end = _run_bounds(pb, num_parts, n)
    pos_in_part = pos - jnp.take(part_start, seg)

    # order-key run boundaries (peer groups) for rank/dense_rank
    ob = pb
    for s in sorted_order:
        ob = ob | _starts(s, ref)

    has_order = bool(op.order_by)
    # original row -> sorted pos
    inv = be.set_at(be.full(n, 0, jnp.int64, ref), perm, pos)

    # general frame bounds (inclusive sorted positions per row) for explicit
    # frame clauses, and for nth_value (which always needs frame endpoints)
    frame = None
    explicit = op.frame_start is not None or op.frame_end is not None
    if explicit or any(f.fn == "nth_value" for f in op.funcs):
        frame = _frame_bounds(op, vt, perm, seg, pos, part_start, part_end,
                              pb, ob, has_order, n)

    cols = dict(vt.cols)
    for f in op.funcs:
        out_sorted = _compute_fn(f, op, vt, perm, seg, num_parts, pos, pos_in_part,
                                 part_start, part_end, pb, ob, has_order, n,
                                 frame if explicit or f.fn == "nth_value" else None)
        # scatter back to original order
        if is_obj(out_sorted.data):  # an exact sum past int64: on the host
            cols[f.out.cid] = out_sorted.take(inv)
            continue
        data = jnp.take(out_sorted.data, inv, axis=0)
        valid = (None if out_sorted.valid is None
                 else jnp.take(out_sorted.valid, inv, axis=0))
        cols[f.out.cid] = SCol(f.out.type, data, valid, out_sorted.dictionary)
    return VTable(cols, n)


def _ref(vt: VTable):
    """A tensor of the table (None for a host-tier table): new arrays are
    made beside it."""
    for c in vt.cols.values():
        if be.is_torch(c.data):
            return c.data
    return None


def _starts(s, ref):
    """True where a sorted key differs from the row before (and at 0)."""
    return jnp.concatenate([be.full(1, True, jnp.bool_, ref), s[1:] != s[:-1]])


def _segmented_cumsum(vals, pb):
    """Prefix sums that reset at partition boundaries."""
    c = jnp.cumsum(vals, axis=0)
    # subtract the cumsum value just before each partition start
    base_idx = jnp.cumsum(be.astype(pb, jnp.int64)) - 1
    (starts_at,) = jnp.nonzero(pb, size=int(jnp.sum(pb)))
    starts = jnp.concatenate([be.full(1, 0, be.dt(c), c), c])[starts_at]
    return c - jnp.take(starts, base_idx)


def _segmented_scan_minmax(vals, pb, is_min: bool):
    return be.segmented_scan_minmax(vals, pb, is_min)


def _binsearch(vals, go_right, lo0, hi0, n):
    """Vectorized per-row binary search over a (segment-wise sorted) array.
    Returns, per row, the first index in [lo0, hi0+1] where the monotone
    predicate stops holding; `go_right(v)` True means search right of mid."""
    lo = lo0
    hi = hi0 + 1
    iters = int(np.ceil(np.log2(max(n, 2)))) + 1
    for _ in range(iters):
        active = lo < hi
        mid = jnp.floor_divide(lo + hi, 2)
        v = jnp.take(vals, jnp.clip(mid, 0, n - 1), axis=0)
        go = go_right(v)
        lo = jnp.where(active & go, mid + 1, lo)
        hi = jnp.where(active & ~go, mid, hi)
    return lo


def _frame_bounds(op: L.Window, vt: VTable, perm, seg, pos, part_start,
                  part_end, pb, ob, has_order, n):
    """Inclusive [lo, hi] sorted-position frame bounds per row for ROWS /
    RANGE / GROUPS frames (reference: rows_between in RelAlgOps.td:257-260;
    runtime SegmentTreeView.cpp answers the per-row frame aggregate queries).
    Empty frames are encoded as lo > hi."""
    ps = jnp.take(part_start, seg)
    pe = jnp.take(part_end, seg)
    fs, fe, mode = op.frame_start, op.frame_end, op.frame_mode
    if fs is None and fe is None:
        # default frame: RANGE UNBOUNDED PRECEDING .. CURRENT ROW when
        # ordered (peer-inclusive end), else the whole partition
        if has_order:
            return ps, _peer_end(ob)
        return ps, pe

    if mode == "rows" or not has_order:
        # RANGE/GROUPS without ORDER BY: all rows are peers; CURRENT ROW and
        # UNBOUNDED both span the partition (offsets are rejected by SQL)
        if mode != "rows":
            lo = ps if fs in ("unbounded", 0) else pos + int(fs)
            hi = pe if fe in ("unbounded", 0) else pos + int(fe)
        else:
            lo = ps if fs == "unbounded" else pos + int(fs)
            hi = pe if fe == "unbounded" else pos + int(fe)
        return jnp.maximum(lo, ps), jnp.minimum(hi, pe)

    if mode == "groups":
        gidx = jnp.cumsum(be.astype(ob, jnp.int64)) - 1
        run_start, run_end = _run_bounds(ob, int(gidx[-1]) + 1, n)
        first_g = jnp.take(gidx, ps)
        last_g = jnp.take(gidx, pe)
        glo = first_g if fs == "unbounded" else gidx + int(fs)
        ghi = last_g if fe == "unbounded" else gidx + int(fe)
        empty = (ghi < glo) | (ghi < first_g) | (glo > last_g)
        lo = jnp.take(run_start, jnp.minimum(jnp.maximum(glo, first_g), last_g))
        hi = jnp.take(run_end, jnp.minimum(jnp.maximum(ghi, first_g), last_g))
        lo = jnp.where(empty, jnp.ones_like(lo), lo)
        hi = jnp.where(empty, jnp.zeros_like(hi), hi)
        return lo, hi

    # RANGE with order: peer-group bounds for CURRENT ROW; value-offset
    # bounds resolved by per-row binary search over the sorted key values
    rs = _peer_start(ob)
    re_ = _peer_end(ob)
    lo = hi = None
    need_search = (isinstance(fs, int) and fs != 0) or (isinstance(fe, int) and fe != 0)
    if need_search:
        if len(op.order_by) != 1:
            raise ValueError("RANGE frame with offset requires exactly one ORDER BY key")
        k = op.order_by[0]
        key = vt.col(k.cid)
        kv = key.take(perm)
        vals = kv.data
        scale = 1
        if key.type.kind == K.DECIMAL and not dec_is_float(key.type):
            scale = 10 ** key.type.s
        asc = k.ascending
        nf = k.nulls_first if k.nulls_first is not None else (not asc)
        null_mask = None
        if kv.valid is not None:
            null_mask = ~kv.valid
            # sentinel keeps per-partition monotonicity with NULLs at their
            # sorted end; offset frames of non-NULL rows then exclude NULLs
            at_small_end = nf == asc  # nulls sort to the small-value end
            # _neutral(is_min=True) is the +extreme; invert for the sentinel
            sent = _neutral(be.dt(vals), is_min=not at_small_end)
            vals = jnp.where(null_mask, sent, vals)

        def first_ge(t):  # first idx in partition at-or-past t in sort order
            if asc:
                return _binsearch(vals, lambda v: v < t, ps, pe, n)
            return _binsearch(vals, lambda v: v > t, ps, pe, n)

        def last_le(t):  # last idx in partition at-or-before t in sort order
            if asc:
                return _binsearch(vals, lambda v: v <= t, ps, pe, n) - 1
            return _binsearch(vals, lambda v: v >= t, ps, pe, n) - 1

        if isinstance(fs, int) and fs != 0:
            t_lo = vals + fs * scale if asc else vals - fs * scale
            lo = first_ge(t_lo)
            if null_mask is not None:  # NULL current row: frame = its peers
                lo = jnp.where(null_mask, rs, lo)
        if isinstance(fe, int) and fe != 0:
            t_hi = vals + fe * scale if asc else vals - fe * scale
            hi = last_le(t_hi)
            if null_mask is not None:
                hi = jnp.where(null_mask, re_, hi)
    if lo is None:
        lo = ps if fs == "unbounded" else rs
    if hi is None:
        hi = pe if fe == "unbounded" else re_
    return jnp.maximum(lo, ps), jnp.minimum(hi, pe)


def _sparse_levels(n: int) -> int:
    """Levels of the sparse table over n rows: level j covers spans of 2^j,
    for every 2^j < n, and level 0 (ceil(log2 n) levels, at least one)."""
    levels, k = 1, 1
    while k < n:
        levels += 1
        k *= 2
    return levels


def _sparse_minmax(x, lo, hi, is_min, n):
    """O(1)-per-query range min/max via a sparse table (the parallel
    equivalent of the reference's SegmentTreeView, SegmentTreeView.cpp).
    The table holds _sparse_levels(n) x n values."""
    dt = be.dt(x)
    comb = jnp.minimum if is_min else jnp.maximum
    n_levels = _sparse_levels(n)
    # level j at [j*n, (j+1)*n): the extreme of the span of 2^j rows from
    # each row (to the end where fewer rows remain), built in place
    flat = be.full(n_levels * n, _neutral(dt, is_min), dt, x)
    flat[:n] = x
    k = 1
    for j in range(1, n_levels):
        prev, base = (j - 1) * n, j * n
        flat[base:base + n - k] = comb(flat[prev:prev + n - k],
                                       flat[prev + k:prev + n])
        flat[base + n - k:base + n] = flat[prev + n - k:prev + n]
        k *= 2
    length = jnp.maximum(hi - lo + 1, 1)
    j = jnp.clip(
        be.astype(jnp.floor(jnp.log2(be.astype(length, jnp.float64))),
                  jnp.int64),
        0, n_levels - 1)
    loc = jnp.clip(lo, 0, n - 1)
    hic = jnp.clip(hi - be.astype(1 << j, jnp.int64) + 1, 0, n - 1)
    a = jnp.take(flat, j * n + loc)
    b = jnp.take(flat, j * n + jnp.maximum(hic, loc))
    return comb(a, b)


def _finish_avg(s, cnt, t, arg_scale):
    """Produce AVG output from summed values (at the arg's representation)
    and non-null counts."""
    if t.kind == K.DECIMAL and not dec_is_float(t):
        num = be.astype(s, jnp.int64) * (10 ** max(t.s - arg_scale, 0))
        den = jnp.maximum(cnt, 1) * (10 ** max(arg_scale - t.s, 0))
        q = jnp.sign(num) * jnp.floor_divide(jnp.abs(num) + jnp.floor_divide(den, 2), den)
        return SCol(t, be.astype(q, jnp.int64), cnt > 0)
    num = be.astype(s, jnp.float64) / (10.0**arg_scale)
    return SCol(t, num / be.astype(jnp.maximum(cnt, 1), jnp.float64), cnt > 0)


def _ones(n, ref):
    return be.full(n, 1, jnp.int64, ref)


def _frame_agg(f: L.WindowFn, t: Type, arg, arg_sorted, lo, hi, n) -> SCol:
    """Aggregate / positional window functions over general [lo, hi] frames:
    sums and counts as differences of prefix sums, min/max via sparse table,
    first/last/nth_value as endpoint gathers."""
    fn = f.fn
    empty = lo > hi
    if fn == "count_star":
        return SCol(t, jnp.where(empty, 0, hi - lo + 1), None)
    vals = arg_sorted.data
    valid_rows = arg_sorted.valid
    lo_i = jnp.clip(lo, 0, n)
    hi_i = jnp.clip(hi + 1, 0, n)

    if fn in ("first_value", "last_value", "nth_value"):
        if fn == "first_value":
            idx = lo
        elif fn == "last_value":
            idx = hi
        else:
            idx = lo + _positive(f) - 1
            empty = empty | (idx > hi) | (idx < lo)
        idx_c = jnp.clip(idx, 0, n - 1)
        data = jnp.take(vals, idx_c, axis=0)
        v = (jnp.take(valid_rows, idx_c) if valid_rows is not None
             else be.full(n, True, jnp.bool_, lo))
        return SCol(t, data, v & ~empty, arg_sorted.dictionary)

    cnt_arr = _ones(n, lo) if valid_rows is None else be.astype(valid_rows, jnp.int64)
    cp = jnp.concatenate([be.full(1, 0, jnp.int64, lo), jnp.cumsum(cnt_arr)])
    cnt = jnp.take(cp, hi_i) - jnp.take(cp, lo_i)
    cnt = jnp.where(empty, 0, cnt)
    if fn == "count":
        return SCol(t, cnt, None)
    if fn in ("sum", "avg"):
        x = vals if valid_rows is None else jnp.where(valid_rows, vals, jnp.zeros_like(vals))
        if be.dt(x) == np.int32:
            x = be.astype(x, jnp.int64)

        def frame_sums(v):
            p = jnp.concatenate([be.full(1, 0, be.dt(v), lo), jnp.cumsum(v)])
            return jnp.take(p, hi_i) - jnp.take(p, lo_i)

        if fn == "sum" and _wide_sum(t, x):
            return _limb_sums(t, x, frame_sums, cnt > 0)
        s = frame_sums(x)
        if fn == "sum":
            return SCol(t, s, cnt > 0)
        arg_scale = (arg.type.s
                     if arg.type.kind == K.DECIMAL and not dec_is_float(arg.type)
                     else 0)
        return _finish_avg(s, cnt, t, arg_scale)
    if fn in ("min", "max"):
        neutral = _neutral(be.dt(vals), fn == "min")
        x = vals if valid_rows is None else jnp.where(valid_rows, vals, neutral)
        out = _sparse_minmax(x, lo, hi, fn == "min", n)
        return SCol(t, out, cnt > 0, arg_sorted.dictionary)
    raise NotImplementedError(f"window frame aggregate {fn}")


def _compute_fn(f: L.WindowFn, op: L.Window, vt: VTable, perm, seg, num_parts,
                pos, pos_in_part, part_start, part_end, pb, ob, has_order, n,
                frame=None) -> SCol:
    fn = f.fn
    t = f.out.type
    if fn == "row_number":
        return SCol(t, pos_in_part + 1, None)
    if fn == "rank":
        # position of the first row of this peer group within the partition
        run_start = _peer_start(ob)
        return SCol(t, run_start - jnp.take(part_start, seg) + 1, None)
    if fn == "dense_rank":
        new_run = be.astype(ob, jnp.int64)
        runs = _segmented_cumsum(new_run, pb)
        return SCol(t, runs, None)
    if fn == "percent_rank":
        run_start = _peer_start(ob)
        rank = be.astype(run_start - jnp.take(part_start, seg), jnp.float64)
        size = be.astype(jnp.take(part_end, seg) - jnp.take(part_start, seg),
                         jnp.float64)
        return SCol(t, jnp.where(size > 0, rank / jnp.maximum(size, 1.0), 0.0),
                    None)
    if fn == "cume_dist":
        # peers counted through the inclusive end of the peer group
        run_end = _peer_end(ob)
        size = be.astype(jnp.take(part_end, seg) - jnp.take(part_start, seg) + 1,
                         jnp.float64)
        return SCol(t, be.astype(run_end - jnp.take(part_start, seg) + 1,
                                 jnp.float64) / size, None)
    if fn == "ntile":
        # SQL's buckets: the first size mod k hold q + 1 rows, the rest q
        k = _positive(f)
        size = jnp.take(part_end, seg) - jnp.take(part_start, seg) + 1
        q = jnp.floor_divide(size, k)
        r = size - q * k
        big = r * (q + 1)  # rows in the larger buckets
        bucket = jnp.where(
            pos_in_part < big, jnp.floor_divide(pos_in_part, q + 1),
            r + jnp.floor_divide(pos_in_part - big, jnp.maximum(q, 1)))
        return SCol(t, bucket + 1, None)

    arg = vt.col(f.arg) if f.arg is not None else None
    arg_sorted = None if arg is None else arg.take(perm)

    if frame is not None and fn in (
        "sum", "avg", "count", "count_star", "min", "max",
        "first_value", "last_value", "nth_value",
    ):
        lo, hi = frame
        return _frame_agg(f, t, arg, arg_sorted, lo, hi, n)

    if fn in ("lead", "lag"):
        return _lead_lag(f, t, vt, arg_sorted, pos, seg, part_start, part_end,
                         n)
    if fn == "first_value":
        idx = jnp.take(part_start, seg)
        data = jnp.take(arg_sorted.data, idx, axis=0)
        valid = None if arg_sorted.valid is None else jnp.take(arg_sorted.valid, idx)
        return SCol(t, data, valid, arg_sorted.dictionary)
    if fn == "last_value":
        # default frame: through the current row's peer group when ordered
        # (RANGE ... CURRENT ROW), else the whole partition
        idx = _peer_end(ob) if has_order else jnp.take(part_end, seg)
        data = jnp.take(arg_sorted.data, idx, axis=0)
        valid = None if arg_sorted.valid is None else jnp.take(arg_sorted.valid, idx)
        return SCol(t, data, valid, arg_sorted.dictionary)

    # aggregates over the default frame (explicit frames took the general
    # path above): RANGE UNBOUNDED PRECEDING .. CURRENT ROW when ordered --
    # a peer-inclusive running frame -- else the whole partition
    running = has_order
    peer_end = _peer_end(ob) if running else None
    if fn == "count_star":
        vals = _ones(n, pos)
        valid_rows = None
    else:
        vals = arg_sorted.data
        valid_rows = arg_sorted.valid
    ones_or_valid = (_ones(n, pos) if valid_rows is None
                     else be.astype(valid_rows, jnp.int64))
    if fn in ("sum", "avg", "count", "count_star"):
        if fn == "count" or fn == "count_star":
            x = ones_or_valid
        else:
            x = vals if valid_rows is None else jnp.where(valid_rows, vals, jnp.zeros_like(vals))
            if be.dt(x) == np.int32:
                x = be.astype(x, jnp.int64)
        if running:
            def sums(v):
                return jnp.take(_segmented_cumsum(v, pb), peer_end, axis=0)
        else:
            s32 = be.astype(seg, jnp.int32)

            def sums(v):
                tot = be.segment_sum(v, s32, num_segments=num_parts,
                                     indices_are_sorted=True)
                return jnp.take(tot, seg, axis=0)
        cnt = sums(ones_or_valid)
        if fn == "sum" and _wide_sum(t, x):
            return _limb_sums(t, x, sums, cnt > 0)
        s = cnt if x is ones_or_valid else sums(x)
        if fn in ("count", "count_star"):
            return SCol(t, s, None)
        if fn == "sum":
            return SCol(t, s, cnt > 0)
        # avg: `s` is at the argument's representation (scaled int for exact
        # decimals); produce the output type's representation
        arg_scale = (arg.type.s
                     if arg.type.kind == K.DECIMAL and not dec_is_float(arg.type)
                     else 0)
        return _finish_avg(s, cnt, t, arg_scale)
    if fn in ("min", "max"):
        big = _neutral(be.dt(vals), fn == "min")
        x = vals if valid_rows is None else jnp.where(valid_rows, vals, big)
        if running:
            out = _segmented_scan_minmax(x, pb, fn == "min")
            out = jnp.take(out, peer_end, axis=0)
            cnt = jnp.take(_segmented_cumsum(ones_or_valid, pb), peer_end)
        else:
            s32 = be.astype(seg, jnp.int32)
            tot = (be.segment_min if fn == "min" else be.segment_max)(
                x, s32, num_segments=num_parts, indices_are_sorted=True)
            out = jnp.take(tot, seg, axis=0)
            ctot = be.segment_sum(ones_or_valid, s32, num_segments=num_parts,
                                  indices_are_sorted=True)
            cnt = jnp.take(ctot, seg)
        return SCol(t, out, cnt > 0, arg_sorted.dictionary)
    raise NotImplementedError(f"window function {fn}")


def _wide_sum(t: Type, x) -> bool:
    """A sum of int64 values whose total may pass int64 (a wide DECIMAL,
    such as a BIGINT's sum)."""
    return (t.kind == K.DECIMAL and dec_is_wide(t) and not is_obj(x)
            and jnp.issubdtype(be.dt(x), jnp.integer))


def _limb_sums(t: Type, x, sums, valid) -> SCol:
    """sums() of int64 `x` exactly: its two 32-bit limbs summed apart (the
    running and frame sums are linear) and recombined; a column on the host
    where a sum passes int64."""
    from . import decwide

    x = be.astype(x, jnp.int64)
    s = decwide.combine_limb_sums(sums(x >> 32), sums(x & 0xFFFFFFFF))
    if is_obj(s):
        return SCol(t, s, be.to_host(valid))
    return SCol(t, be.like(s, valid), valid)


def _positive(f: L.WindowFn) -> int:
    """ntile's bucket count or nth_value's position: PostgreSQL refuses
    one below 1 (a NULL one never reaches here: the binder gives NULL)."""
    k = int(f.extra)
    if k <= 0:
        from .scalar import EvalError

        raise EvalError(f"argument of {f.fn} must be greater than zero")
    return k


def _lead_lag(f: L.WindowFn, t: Type, vt: VTable, arg_sorted: SCol, pos,
              seg, part_start, part_end, n) -> SCol:
    """lag / lead by a constant offset (1 where none was given; 0 is the
    current row, a negative one looks the other way). Rows whose source
    lies outside the partition take the default, a constant of the
    argument's type (NULL where none was given); a string default joins
    the argument's dictionary."""
    off = 1 if f.extra is None else int(f.extra)
    src = pos + (off if f.fn == "lead" else -off)
    in_part = ((src >= jnp.take(part_start, seg))
               & (src <= jnp.take(part_end, seg)))
    src_c = jnp.clip(src, 0, n - 1)
    data = jnp.take(arg_sorted.data, src_c, axis=0)
    base_valid = arg_sorted.valid_mask() if arg_sorted.valid is not None else None
    v = (jnp.take(base_valid, src_c) if base_valid is not None
         else be.full(n, True, jnp.bool_, pos))
    dictionary = arg_sorted.dictionary
    if f.default is None:
        return SCol(t, data, v & in_part, dictionary)
    from .scalar import eval_expr

    d = eval_expr(f.default, {})  # a 0-dim constant on the host
    if dictionary is not None:
        from . import strings

        word = str(d.dictionary[0])
        merged, remap, _ = strings.remap_to_merged(
            dictionary, np.array([word], dtype=object))
        data = be.lut_take(be.astype(remap, np.int32), data)
        dictionary = merged
        fill = int(np.searchsorted(merged, word))
    else:
        fill = d.data.item()
    data = jnp.where(in_part, data, be.full(n, fill, be.dt(data), pos))
    return SCol(t, data, v | ~in_part, dictionary)


def _neutral(dtype, is_min: bool):
    """The identity of min (is_min) or max for a numpy dtype."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return dtype.type(np.inf if is_min else -np.inf)
    info = np.iinfo(dtype)
    return dtype.type(info.max if is_min else info.min)


def _run_bounds(flags, runs: int, n: int):
    """First and last sorted position of each run of rows, where a run
    starts at every True of `flags` (flags[0] is True): (starts, ends), one
    entry a run, ascending. The reference takes them as segment minima and
    maxima of the positions; a scatter of millions of rows into a few
    segments serializes on its atomics on the card, and the positions of
    the Trues give the same values."""
    (starts,) = jnp.nonzero(flags, size=runs)
    starts = be.astype(starts, jnp.int64)
    ends = jnp.concatenate([starts[1:] - 1, be.full(1, n - 1, jnp.int64, starts)])
    return starts, ends


def _peer_start(ob):
    """For each sorted position: the first position of its peer group (the
    largest position <= it where ob is True; the reference's cummax)."""
    gidx = jnp.cumsum(be.astype(ob, jnp.int64)) - 1
    starts, _ends = _run_bounds(ob, int(gidx[-1]) + 1, ob.shape[0])
    return jnp.take(starts, gidx)


def _peer_end(ob):
    """For each sorted position: the last position of its peer group (the
    inclusive end of the run; the reference's reverse cummin)."""
    gidx = jnp.cumsum(be.astype(ob, jnp.int64)) - 1
    _starts, ends = _run_bounds(ob, int(gidx[-1]) + 1, ob.shape[0])
    return jnp.take(ends, gidx)
