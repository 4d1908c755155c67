"""Grouped aggregation kernels.

Equivalent of the reference's aggregation path
(reference: AggregationLowering RelAlgToSubOp.cpp:2554 -> thread-local
hashmap + reduce + merge; runtime PreAggregationHashtable.cpp). Pointer-chasing
hash tables don't map to wide vector hardware, so grouping is computed as data:

  fast path  — all group keys have small dense domains (dict codes, bools):
               gid = mixed-radix code, then unsorted segment reductions
               (pure scatter-adds, no sort). This is the Q1-style path.
  general    — multi-key lexicographic stable sort + boundary detection +
               sorted segment reductions.

Both end with one host sync for the group count (the unavoidable
dynamic-shape point; everything else is static)."""

from __future__ import annotations

import numpy as np

from . import backend as be
from .backend import xnp as jnp

from ..runtime.vtable import SCol, _host_idx, dec_is_float, is_obj
from ..sql.types import K, Type
from . import keys as keymod

DENSE_DOMAIN_LIMIT = 1 << 16


def small_domain(c: SCol) -> int | None:
    """Dense-domain size if the column is cheaply dense-encodable."""
    return _domain(c.type, c.dictionary, c.valid is not None)


def _domain(t, dictionary, nullable: bool) -> int | None:
    if t.is_string and dictionary is not None:
        return len(dictionary) + (1 if nullable else 0)
    if t.kind == K.BOOL:
        return 2 + (1 if nullable else 0)
    return None


def bounded_layout(templates, bounds):
    """(total, radices, offsets) of bounded_gid's mixed-radix id for keys
    described by (type, dictionary, nullable) templates, or None when a key
    has neither a small domain nor usable bounds, or the domain exceeds
    DENSE_DOMAIN_LIMIT. An offset of None: the key's value is its code."""
    from ..sql.types import K as _K

    total = 1
    radices = []
    offsets = []
    for (t, dictionary, nullable), b in zip(templates, bounds):
        d = _domain(t, dictionary, nullable)
        if d is not None:
            radices.append(d)
            offsets.append(None)  # value IS the code
        elif b is not None and t.kind in (_K.INT, _K.BIGINT, _K.DATE):
            kmin, kmax = b
            if kmax < kmin:
                kmin, kmax = 0, 0  # no surviving rows at calibration
            d = (int(kmax) - int(kmin) + 1) + (1 if nullable else 0)
            radices.append(d)
            offsets.append(int(kmin))
        else:
            return None
        total *= d
        if total > DENSE_DOMAIN_LIMIT:
            return None
    return total, radices, offsets


def bounded_gid(key_cols: list[SCol], bounds):
    """Mixed-radix dense group id using LEARNED per-key [kmin, kmax] value
    bounds for integer/date keys (bounds: one (kmin, kmax) pair or None per
    key; None falls back to small_domain). Returns (gid, total, radices,
    offsets, oob) or (None,)*5 when a key has neither a small domain nor
    usable bounds. `oob` is a per-row bool marking keys OUTSIDE their
    learned bounds — the caller rides its sum on the program outputs and
    rebuilds if it ever fires (within one table version it cannot: bounds
    are calibrated on the same data).

    This is what turns year x nation groupings (TPC-H Q7/Q9) into the
    sort-free dense psum path: the value RANGE is tiny but not statically
    known, so the static dense_gid() below cannot see it (the reference's
    runtime hash table is naturally value-oblivious; here adaptive
    recompilation learns the domain instead)."""
    templates = [(c.type, c.dictionary, c.valid is not None) for c in key_cols]
    layout = bounded_layout(templates, bounds)
    if layout is None:
        return None, None, None, None, None
    total, radices, offsets = layout
    gid = None
    oob = None
    for c, r, off in zip(key_cols, radices, offsets):
        if off is None:
            code = be.astype(c.data, jnp.int32)
            if c.valid is not None:
                code = jnp.where(c.valid, code, r - 1)
        else:
            k = be.astype(c.data, jnp.int64)
            span = r - (1 if c.valid is not None else 0)
            bad = (k < off) | (k >= off + span)
            if c.valid is not None:
                bad = bad & c.valid
            oob = bad if oob is None else (oob | bad)
            code = be.astype(jnp.clip(k - off, 0, span - 1), jnp.int32)
            if c.valid is not None:
                code = jnp.where(c.valid, code, r - 1)
        gid = code if gid is None else gid * r + code
    if oob is None:
        oob = jnp.zeros_like(gid, dtype=jnp.bool_)
    return gid, total, radices, offsets, oob


def dense_gid(key_cols: list[SCol]):
    """Mixed-radix dense group id, or None if domains too large."""
    total = 1
    radices = []
    for c in key_cols:
        d = small_domain(c)
        if d is None:
            return None, None
        radices.append(d)
        total *= d
        if total > DENSE_DOMAIN_LIMIT:
            return None, None
    gid = None
    for c, r in zip(key_cols, radices):
        code = be.astype(c.data, jnp.int32)
        if c.type.kind == K.BOOL:
            code = be.astype(c.data, jnp.int32)
        if c.valid is not None:
            code = jnp.where(c.valid, code, r - 1)
        gid = code if gid is None else gid * r + code
    return gid, total


def group_rows(key_cols: list[SCol], n: int):
    """Compute grouping structure. Returns a dict with:
       seg:         per input row (in `order` order) segment id
       order:       permutation to apply to inputs before segment reductions
                    (None = identity / unsorted segments)
       num_groups:  G (host int)
       rep_rows:    input-row index of one representative per group
       sorted:      whether seg is sorted ascending
    """
    gid, domain = dense_gid(key_cols)
    if gid is not None:
        # compact occupied slots
        counts = be.segment_sum(jnp.ones_like(gid), gid, num_segments=domain)
        occupied = counts > 0
        num_groups = int(jnp.sum(occupied))
        (slots,) = jnp.nonzero(occupied, size=num_groups)
        remap = be.set_at(jnp.zeros((domain,), jnp.int32), slots, be.iota(num_groups, jnp.int32, slots))
        seg = remap[gid]
        # representative row per compact group
        rep = be.set_at(jnp.zeros((domain,), jnp.int64), gid, be.iota(gid.shape[0], jnp.int64, gid))
        rep_rows = rep[slots]
        return {"seg": seg, "order": None, "num_groups": num_groups,
                "rep_rows": rep_rows, "sorted": False}
    imgs = [jnp.broadcast_to(x, (n,)) for x in keymod.grouping_images(key_cols)]
    iota = be.iota(n, jnp.int64, imgs[0] if imgs else None)
    res = be.multi_sort(imgs + [iota], num_keys=len(imgs))
    perm = res[-1]
    simgs = res[:-1]
    if n == 0:
        return {"seg": be.full(0, 0, jnp.int32, perm), "order": perm, "num_groups": 0,
                "rep_rows": be.full(0, 0, jnp.int64, perm), "sorted": True}
    boundary = be.first_true(n, like=imgs[0] if imgs else None)
    for s in simgs:
        boundary = boundary | jnp.concatenate([jnp.ones((1,), jnp.bool_), s[1:] != s[:-1]])
    seg = jnp.cumsum(be.astype(boundary, jnp.int32)) - 1
    num_groups = int(seg[-1]) + 1
    (bpos,) = jnp.nonzero(boundary, size=num_groups)
    rep_rows = perm[bpos]
    return {"seg": seg, "order": perm, "num_groups": num_groups,
            "rep_rows": rep_rows, "sorted": True}


def _host_arr(x):
    """Device array -> numpy (None passes through); for mixing with
    object-dtype (wide Python-int decimal) columns on the host."""
    if x is None or isinstance(x, np.ndarray):
        return x
    return be.to_host(x)


def _segment_sum(vals, seg, g, sorted_):
    return be.segment_sum(vals, seg, num_segments=g, indices_are_sorted=sorted_)


def _segment_min(vals, seg, g, sorted_):
    return be.segment_min(vals, seg, num_segments=g, indices_are_sorted=sorted_)


def _segment_max(vals, seg, g, sorted_):
    return be.segment_max(vals, seg, num_segments=g, indices_are_sorted=sorted_)


def aggregate(fn: str, arg: SCol | None, out_t: Type, grp: dict) -> SCol:
    """Compute one aggregate over the grouping structure."""
    seg, order, g, sorted_ = grp["seg"], grp["order"], grp["num_groups"], grp["sorted"]

    def ordered(x):
        if order is None:
            return x
        if is_obj(x):  # wide (Python-int) decimals permute on the host
            return x[_host_idx(order)]
        return jnp.take(x, order, axis=0)

    if fn == "count_star":
        ones = jnp.ones_like(seg, dtype=jnp.int64)
        return SCol(out_t, _segment_sum(ones, seg, g, sorted_), None)
    assert arg is not None
    data = ordered(arg.data)
    valid = None if arg.valid is None else ordered(arg.valid)
    vcount = _segment_sum(
        jnp.ones_like(seg, dtype=jnp.int64) if valid is None else be.astype(valid, jnp.int64),
        seg, g, sorted_,
    )
    if fn == "count":
        return SCol(out_t, vcount, None)
    nonempty = vcount > 0
    if fn == "sum":
        from ..runtime.vtable import dec_is_wide, np_dtype
        from . import decwide

        if is_obj(data):
            # wide host column: exact Python-int segment sum (np.add.at
            # supports object dtype); masks/segments come to the host
            vh = _host_arr(valid)
            vals = data if vh is None else np.where(vh, data, 0)
            s = _segment_sum(vals, _host_arr(seg), g, sorted_)
            return SCol(out_t, decwide.demote_if_possible(s), nonempty)
        vals = data if valid is None else jnp.where(valid, data, jnp.zeros_like(data))
        if dec_is_wide(out_t) and jnp.issubdtype(be.dt(vals), jnp.integer):
            if not be.is_torch(vals) and not be.is_torch(seg):
                # host int64 that may overflow: go exact in Python ints
                s = _segment_sum(decwide.to_obj(vals), np.asarray(seg), g, sorted_)
                return SCol(out_t, decwide.demote_if_possible(s), nonempty)
            # device: 32-bit-split accumulators, recombined exactly on host
            v64 = be.astype(vals, jnp.int64)
            hi = _segment_sum(v64 >> 32, seg, g, sorted_)
            lo = _segment_sum(v64 & 0xFFFFFFFF, seg, g, sorted_)
            s = decwide.demote_if_possible(decwide.combine_limbs(
                be.to_host(hi), be.to_host(lo)))
            if is_obj(s):  # beyond int64: a host column, masks come along
                return SCol(out_t, s, be.to_host(nonempty))
            return SCol(out_t, be.like(s, seg), nonempty)
        vals = be.astype(vals, np_dtype(out_t))
        s = _segment_sum(vals, seg, g, sorted_)
        return SCol(out_t, s, nonempty)
    if fn in ("min", "max"):
        if is_obj(data):
            # wide host column: exact Python-int extrema (ufunc.at supports
            # object dtype); bound far outside decimal(38) range
            big = (1 if fn == "min" else -1) * 10**45
            vh = _host_arr(valid)
            vals = data if vh is None else np.where(vh, data, big)
            out = np.full(g, big, dtype=np.object_)
            (np.minimum if fn == "min" else np.maximum).at(
                out, _host_arr(seg), vals)
            return SCol(out_t, out, nonempty, arg.dictionary)
        big = _extreme(be.dt(data), maximum=(fn == "min"))
        vals = data if valid is None else jnp.where(valid, data, big)
        r = (_segment_min if fn == "min" else _segment_max)(vals, seg, g, sorted_)
        return SCol(out_t, r, nonempty, arg.dictionary)
    if fn == "any_value":
        # representative value per group
        rep = grp["rep_rows"]
        if is_obj(arg.data):
            ri = _host_idx(rep)
            return SCol(out_t, arg.data[ri],
                        None if arg.valid is None else _host_arr(arg.valid)[ri],
                        arg.dictionary)
        return SCol(out_t, jnp.take(arg.data, rep), None if arg.valid is None else jnp.take(arg.valid, rep), arg.dictionary)
    if fn in ("stddev_samp", "var_samp"):
        x = be.astype(data, jnp.float64)
        if arg.type.kind == K.DECIMAL and not dec_is_float(arg.type):
            x = be.fdiv(x, 10.0**arg.type.s)
        m = valid if valid is not None else jnp.ones_like(seg, dtype=jnp.bool_)
        xm = jnp.where(m, x, 0.0)
        s1 = _segment_sum(xm, seg, g, sorted_)
        s2 = _segment_sum(jnp.where(m, x * x, 0.0), seg, g, sorted_)
        cnt = be.astype(vcount, jnp.float64)
        var = (s2 - s1 * s1 / jnp.maximum(cnt, 1)) / jnp.maximum(cnt - 1, 1)
        var = jnp.maximum(var, 0.0)
        out = jnp.sqrt(var) if fn == "stddev_samp" else var
        return SCol(out_t, out, vcount > 1)
    if fn in ("bool_and", "bool_or"):
        x = be.astype(data, jnp.bool_)
        if fn == "bool_and":
            vals = jnp.where(valid, x, True) if valid is not None else x
            r = _segment_min(be.astype(vals, jnp.int32), seg, g, sorted_) > 0
        else:
            vals = jnp.where(valid, x, False) if valid is not None else x
            r = _segment_max(be.astype(vals, jnp.int32), seg, g, sorted_) > 0
        return SCol(out_t, r, nonempty)
    raise NotImplementedError(f"aggregate {fn}")


def _extreme(dtype, maximum: bool):
    if dtype == np.object_:
        # wide-decimal sentinel: beyond any decimal(38) scaled value
        return 10**40 if maximum else -(10**40)
    if dtype == jnp.bool_:
        return jnp.asarray(True if maximum else False)
    info = jnp.finfo(dtype) if jnp.issubdtype(dtype, jnp.floating) else jnp.iinfo(dtype)
    return jnp.asarray(info.max if maximum else info.min, dtype)


def distinct_reduce(fn: str, key_cols: list[SCol], arg: SCol, grp: dict,
                    out_t: Type, n: int) -> SCol:
    """fn(DISTINCT arg) per group for fn in count/sum: sort by (group keys,
    arg), keep only the first row of each (group, value) run, then segment-
    reduce. min/max are distinct-insensitive and handled by the normal path."""
    if n == 0:
        z = jnp.zeros((grp["num_groups"],), jnp.int64 if fn == "count" else be.dt(arg.data))
        return SCol(out_t, z, None if fn == "count" else jnp.zeros((grp["num_groups"],), jnp.bool_))
    imgs = keymod.grouping_images(key_cols) if key_cols else []
    aimg = keymod.grouping_images([arg])
    imgs = [jnp.broadcast_to(x, (n,)) for x in imgs]
    aimg = [jnp.broadcast_to(x, (n,)) for x in aimg]
    iota = be.iota(n, jnp.int64, aimg[0])
    res = be.multi_sort(imgs + aimg + [iota], num_keys=len(imgs) + len(aimg))
    perm = res[-1]
    sorted_keys = res[:len(imgs)]
    sorted_arg = res[len(imgs):-1]
    new_any = be.first_true(n, like=perm)
    for s in sorted_keys + sorted_arg:
        new_any = new_any | jnp.concatenate([jnp.ones((1,), jnp.bool_), s[1:] != s[:-1]])
    avalid = jnp.ones_like(perm, dtype=jnp.bool_) if arg.valid is None else jnp.take(arg.valid, perm)
    first = new_any & avalid
    if fn == "count":
        vals = be.astype(first, jnp.int64)
    else:  # sum of distinct values
        data = jnp.take(arg.data, perm)
        if be.dt(data) == jnp.int32:
            data = be.astype(data, jnp.int64)
        vals = jnp.where(first, data, jnp.zeros_like(data))
    wide = fn == "sum" and _wide_out(out_t, vals)
    if not key_cols:
        if wide:
            return _limb_total(out_t, vals, lambda x: jnp.sum(x)[None],
                               jnp.sum(be.astype(first, jnp.int64))[None] > 0)
        s = jnp.sum(vals)[None]
        if fn == "count":
            return SCol(out_t, s, None)
        return SCol(out_t, s, jnp.sum(be.astype(first, jnp.int64))[None] > 0)
    boundary = be.first_true(n, like=imgs[0] if imgs else None)
    for s in sorted_keys:
        boundary = boundary | jnp.concatenate([jnp.ones((1,), jnp.bool_), s[1:] != s[:-1]])
    seg = jnp.cumsum(be.astype(boundary, jnp.int32)) - 1
    g = grp["num_groups"]
    nonempty = be.segment_sum(be.astype(first, jnp.int64), seg, num_segments=g,
                                   indices_are_sorted=True) > 0
    gid_of_group = None
    if grp["order"] is None:
        # dense-gid path numbered groups differently: align via representatives
        rep_sorted_pos = be.set_at(be.full(n, 0, jnp.int32, perm), perm, seg)
        gid_of_group = rep_sorted_pos[grp["rep_rows"]]
        nonempty = nonempty[gid_of_group]

    def reduce(x):
        r = be.segment_sum(x, seg, num_segments=g, indices_are_sorted=True)
        return r if gid_of_group is None else r[gid_of_group]

    if wide:
        return _limb_total(out_t, vals, reduce, nonempty)
    return SCol(out_t, reduce(vals), None if fn == "count" else nonempty)


def _wide_out(out_t: Type, vals) -> bool:
    from ..runtime.vtable import dec_is_wide

    return (out_t.kind == K.DECIMAL and dec_is_wide(out_t)
            and not is_obj(vals) and jnp.issubdtype(be.dt(vals), jnp.integer))


def _limb_total(out_t: Type, vals, reduce, nonempty) -> SCol:
    """reduce() of int64 `vals` exactly past int64: the two 32-bit limbs
    reduced apart and recombined (a column on the host where a total
    passes int64)."""
    from . import decwide

    v64 = be.astype(vals, jnp.int64)
    s = decwide.combine_limb_sums(reduce(v64 >> 32), reduce(v64 & 0xFFFFFFFF))
    if is_obj(s):
        return SCol(out_t, s, be.to_host(nonempty))
    return SCol(out_t, be.like(s, nonempty), nonempty)
