"""Distributed keyed-shuffle execution over the device mesh.

The counterpart of lingodb_tpu/parallel/shuffle.py, LingoDB's compiler-
decided state partitioning (thread-local + merge, or partitioned
PreAggregationHashtable fragments) with the mesh axis in place of worker
threads:

  exchange      all-to-all routing each row to shard = dest (usually
                hash(key) % n). Two phases: an exact per-(src, dst) count
                picks the buffer capacity, then one collective moves the
                rows. No row is ever dropped (capacity is exact), and no
                operand is replicated.
  local join    per-shard sort/searchsorted equi-join over the exchanged
                rows (equal keys are co-located after the exchange) with a
                count pass fixing the pair capacity; payload gathers stay
                on their shard.
  local groupby per-shard grouping of exchanged rows: after a keyed
                exchange every group lives on exactly one shard, so the
                local aggregation is final.

Each shard-local program is a function of one shard's tensors, built once
per (mesh size, capacity, dtypes) and kept in `_PROGRAMS` (the reference
keeps its jitted programs there); the one Python thread runs it shard after
shard. Inputs may be `Sharded` values or global arrays (a torch tensor or a
numpy array of the global layout), which `shard_put` splits into views.
Host syncs: one per capacity decision (counts, pair totals). Every number
read to the host is the global one (mesh.to_host): on a mesh that spans
processes each process contributes its positions', and every process
reads the same array and takes the same branch (one that took another
would leave the others waiting in a collective).

Hashes are uint64 in the reference and held as int64 bit patterns here
(ops/hashing.py): `hash_dest` takes the unsigned remainder, and the local
join sorts and searches them with the top bit flipped so that the order is
the unsigned one (the dead-row sentinel 0xFFFF_FFFF_FFFF_FFFF sorts last).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import backend as be
from .mesh import (Mesh, Sharded, _as_tensor, _lead, all_to_all, gather_ragged,
                   shard_rows, to_host)

_U64_MAX = -1  # 0xFFFF_FFFF_FFFF_FFFF as an int64 bit pattern
_TOP_BIT = -(1 << 63)

# observability: how often each shuffle strategy ran (tests assert on these);
# "gathers" counts the tables that left the mesh whole for an operator
# without a sharded form (Executor._gather_input)
STATS = {"exchanges": 0, "joins": 0, "groupbys": 0, "skew_splits": 0,
         "sorts": 0, "gathers": 0}

_PROGRAMS: dict = {}


def _cached(key, builder):
    fn = _PROGRAMS.get(key)
    if fn is None:
        fn = builder()
        _PROGRAMS[key] = fn
    return fn


def _axis(mesh: Mesh) -> str:
    return mesh.axis_names[0]


def _dtype_name(a) -> str:
    if isinstance(a, Sharded):
        a = a.shards[0]
    if isinstance(a, torch.Tensor):
        return str(be.dt(a))
    return str(np.asarray(a).dtype)


def _per_shard(mesh: Mesh, fn, args: list) -> list:
    """fn on each local position's shards of `args` (Sharded); its tuple of
    tensors a shard becomes a list of Sharded values."""
    outs = [fn(*[a.shards[i] for a in args])
            for i in range(len(mesh.local_positions))]
    return [Sharded(mesh, [o[j] for o in outs], int(outs[0][j].shape[0]))
            for j in range(len(outs[0]))]


def _all_rows(dest):
    """An all-true validity for `dest`'s rows, in its layout."""
    if isinstance(dest, Sharded):
        return dest.map(lambda d: torch.ones_like(d, dtype=torch.bool))
    return torch.ones((int(dest.shape[0]),), dtype=torch.bool,
                      device=_as_tensor(dest).device)


def shard_put(mesh: Mesh, arr, n_rows=None):
    """Pad a 1-D array to a multiple of the mesh axis and row-shard it.
    Returns (Sharded, pad_count). A Sharded value passes through."""
    if isinstance(arr, Sharded):
        return arr, 0
    n = mesh.shape[_axis(mesh)]
    rows = int(arr.shape[0]) if n_rows is None else n_rows
    return shard_rows(mesh, arr), (-rows) % n


def hash_dest(mesh: Mesh, h):
    """Destination shard for a uint64 hash column (int64 bit patterns or
    numpy uint64): the unsigned remainder mod the mesh size. A Sharded
    hash gives a Sharded destination, a global one a global int32
    tensor."""
    n = mesh.shape[_axis(mesh)]
    wrap = (1 << 64) % n  # what 2^64 adds to a negative bit pattern, mod n

    def dest(x):
        r = torch.remainder(x, n)
        return torch.where(x < 0, torch.remainder(r + wrap, n), r).to(torch.int32)

    if isinstance(h, Sharded):
        return h.map(dest)
    return dest(_as_tensor(h))


# --------------------------------------------------------------- exchange
def _local_counts(n: int):
    def local(d, v):
        dd = torch.where(v, d.to(torch.int32),
                         torch.full_like(d, n, dtype=torch.int32))
        # sort + searchsorted, as the reference counts: no host sync (a
        # bincount on the card reads its maximum back first)
        bounds = torch.searchsorted(
            torch.sort(dd).values,
            torch.arange(n + 1, dtype=torch.int32, device=d.device))
        return ((bounds[1:] - bounds[:n]).to(torch.int32),)

    return local


def _local_exchange(n: int, cap: int):
    def local(d, v, *cs):
        m = d.shape[0]
        dev = d.device
        dd = torch.where(v, d.to(torch.int32),
                         torch.full_like(d, n, dtype=torch.int32))
        order = torch.sort(dd, stable=True).indices
        ds = dd[order]
        bounds = torch.searchsorted(
            ds, torch.arange(n + 1, dtype=torch.int32, device=dev))
        starts, cnt = bounds[:n], bounds[1:] - bounds[:n]
        lane = torch.arange(cap, device=dev)
        pos = starts[:, None] + lane[None, :]
        ok = lane[None, :] < cnt[:, None]
        src = order[pos.clamp(0, m - 1)]
        bufs = [ok]
        for c in cs:
            bufs.append(torch.where(ok, c[src], torch.zeros((), dtype=c.dtype,
                                                             device=dev)))
        return tuple(bufs)

    return local


def _counts(mesh: Mesh, d_s: Sharded, v_s: Sharded) -> np.ndarray:
    n = mesh.shape[_axis(mesh)]
    fn = _cached(("cnt", n), lambda: _local_counts(n))
    (counts,) = _per_shard(mesh, fn, [d_s, v_s])
    return to_host(mesh, counts.shards).reshape(-1)


def exchange(mesh: Mesh, dest, arrays: list, valid=None):
    """Route rows to shards. dest: per-row destination shard (int); valid:
    rows to keep (None = all). Returns (out_valid, out_arrays, local_len):
    Sharded values of global length n * local_len whose shard s holds the
    rows routed to shard s (padding marked invalid)."""
    n = mesh.shape[_axis(mesh)]
    valid = _all_rows(dest) if valid is None else valid
    d_s, _pad = shard_put(mesh, dest)
    v_s, _ = shard_put(mesh, valid)  # zero padding = False = dropped
    counts = _counts(mesh, d_s, v_s)
    cap = max(int(counts.max()), 1)
    dtypes = tuple(_dtype_name(a) for a in arrays)
    fn = _cached(("ex", n, cap, dtypes),
                 lambda: _local_exchange(n, cap))
    ins = [shard_put(mesh, a)[0] for a in arrays]
    bufs = [fn(*[x.shards[i] for x in [d_s, v_s] + ins])
            for i in range(len(mesh.local_positions))]
    outs = [Sharded(mesh, all_to_all(mesh, [b[j] for b in bufs]), n * cap)
            for j in range(1 + len(arrays))]
    STATS["exchanges"] += 1
    return outs[0], outs[1:], n * cap


def dest_counts(mesh: Mesh, dest, valid=None) -> np.ndarray:
    """Per-(source, destination) routed row counts as a host (n, n) matrix,
    used for skew detection before committing to an exchange."""
    n = mesh.shape[_axis(mesh)]
    valid = _all_rows(dest) if valid is None else valid
    d_s, _ = shard_put(mesh, dest)
    v_s, _ = shard_put(mesh, valid)
    return _counts(mesh, d_s, v_s).reshape(n, n)


# --------------------------------------------------------------- local join
def _unsigned_key(h: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns whose signed order is the unsigned order of h."""
    return h ^ _TOP_BIT


def _local_join_count():
    def local(bh, bv, ph, pv):
        bh2 = _unsigned_key(torch.where(bv, bh, torch.full_like(bh, _U64_MAX)))
        sb = torch.sort(bh2).values
        pk = _unsigned_key(ph)
        s = torch.searchsorted(sb, pk, side="left")
        e = torch.searchsorted(sb, pk, side="right")
        cnt = torch.where(pv, e - s, torch.zeros_like(s))
        return (cnt.sum().to(torch.int64).reshape(1),)

    return local


def _local_join_expand(cap_out: int, nb: int):
    def local(bh, bv, ph, pv, *payload):
        bcols, pcols = payload[:nb], payload[nb:]
        mb = bh.shape[0]
        dev = bh.device
        bh2 = _unsigned_key(torch.where(bv, bh, torch.full_like(bh, _U64_MAX)))
        sb, order = torch.sort(bh2, stable=True)
        pk = _unsigned_key(ph)
        s = torch.searchsorted(sb, pk, side="left")
        e = torch.searchsorted(sb, pk, side="right")
        cnt = torch.where(pv, e - s, torch.zeros_like(s))
        offs_incl = torch.cumsum(cnt, 0)
        offs_excl = offs_incl - cnt
        total = offs_incl[-1]
        pos = torch.arange(cap_out, dtype=offs_incl.dtype, device=dev)
        probe_of = torch.searchsorted(offs_incl, pos, side="right")
        probe_of = probe_of.clamp(0, cnt.shape[0] - 1)
        within = pos - offs_excl[probe_of]
        slot = s[probe_of] + within
        build_of = order[slot.clamp(0, mb - 1)]
        in_range = pos < total
        pair_valid = in_range & bv[build_of] & pv[probe_of]
        outs = [pair_valid, probe_of.to(torch.int64), build_of.to(torch.int64)]
        outs += [c[build_of] for c in bcols]
        outs += [c[probe_of] for c in pcols]
        return tuple(outs)

    return local


def join_pairs(mesh: Mesh, bh, bv, ph, pv, build_payload: list,
               probe_payload: list):
    """Per-shard equi-candidate expansion over exchanged sides. Inputs are
    the Sharded values exchange() produced; hashes already encode the
    NULL-key sentinels. Returns (pair_valid, local_probe_idx,
    local_build_idx, gathered build payload, gathered probe payload, local
    pair capacity, total candidate pairs). Every gather stays on its
    shard."""
    n = mesh.shape[_axis(mesh)]
    args = [shard_put(mesh, a)[0] for a in (bh, bv, ph, pv)]
    fn = _cached(("jc", n), _local_join_count)
    (totals,) = _per_shard(mesh, fn, args)
    totals = to_host(mesh, totals.shards).reshape(-1)
    cap_out = max(int(totals.max()), 1)
    nb = len(build_payload)
    dtypes = tuple(_dtype_name(a) for a in build_payload + probe_payload)
    fn = _cached(("jx2", n, cap_out, nb, len(probe_payload), dtypes),
                 lambda: _local_join_expand(cap_out, nb))
    payload = [shard_put(mesh, a)[0] for a in build_payload + probe_payload]
    out = _per_shard(mesh, fn, args + payload)
    STATS["joins"] += 1
    return (out[0], out[1], out[2], out[3:3 + nb], out[3 + nb:],
            cap_out, int(totals.sum()))


def _local_flags(probe_len: int):
    def local(pair_ok, probe_idx):
        return (be.segment_max(pair_ok.to(torch.int32),
                               probe_idx.to(torch.int32),
                               num_segments=probe_len) > 0,)

    return local


def probe_flags(mesh: Mesh, pair_ok, probe_idx, probe_local_len: int):
    """Per exchanged probe row: any passing pair (semi, anti, mark, left).
    probe_idx are shard-local indices, so the reduction is shard-local.
    Works symmetrically for build-side flags (pass build_idx + build
    len)."""
    n = mesh.shape[_axis(mesh)]
    fn = _cached(("fl", n, probe_local_len), lambda: _local_flags(probe_local_len))
    args = [shard_put(mesh, a)[0] for a in (pair_ok, probe_idx)]
    return _per_shard(mesh, fn, args)[0]


def _local_single_pick(probe_len: int):
    def local(pair_ok, probe_idx, *arrays):
        m = pair_ok.shape[0]
        pos = torch.arange(m, dtype=torch.int64, device=pair_ok.device)
        slot = be.segment_min(torch.where(pair_ok, pos, torch.full_like(pos, m)),
                              probe_idx.to(torch.int32), num_segments=probe_len)
        found = slot < m
        cl = slot.clamp(0, m - 1)
        return (found,) + tuple(a[cl] for a in arrays)

    return local


def single_pick(mesh: Mesh, pair_ok, probe_idx, probe_local_len: int,
                arrays: list):
    """Per exchanged probe row: the FIRST passing pair's values from the
    pair-aligned `arrays` (single joins: at most one build match survives
    per probe row; ties resolve to the lowest pair slot). Returns
    (found_flags, picked_arrays) aligned to the exchanged probe rows."""
    n = mesh.shape[_axis(mesh)]
    dtypes = tuple(_dtype_name(a) for a in arrays)
    fn = _cached(("sp", n, probe_local_len, dtypes),
                 lambda: _local_single_pick(probe_local_len))
    args = [shard_put(mesh, a)[0] for a in [pair_ok, probe_idx] + list(arrays)]
    out = _per_shard(mesh, fn, args)
    return out[0], out[1:]


# ------------------------------------------------------------ local groupby
def _changes(s: torch.Tensor) -> torch.Tensor:
    """True at row 0 and wherever s differs from the row before."""
    first = torch.ones((1,), dtype=torch.bool, device=s.device)
    return torch.cat([first, s[1:] != s[:-1]])


def _take_or_fill(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx], and where idx is out of range the fill value the reference's
    take gives there (the type's minimum for integers, NaN for floats,
    True for booleans): the rows past a shard's group count."""
    m = a.shape[0]
    out = a[idx.clamp(0, m - 1)]
    bad = (idx < 0) | (idx >= m)
    if a.dtype == torch.bool:
        fill = True
    elif a.dtype.is_floating_point:
        fill = float("nan")
    else:
        fill = torch.iinfo(a.dtype).min
    return torch.where(bad, torch.full_like(out, fill), out)


def _extreme(dtype: torch.dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _local_group(n_imgs: int, n_reps: int, agg_descr):
    """agg_descr: tuple of (kind, n_arrays, dtypes) with kind in {sum,
    count, min, max, cdist, sdist}, each consuming n_arrays value inputs
    plus one valid mask. sum/min/max take (vals,); cdist takes the
    argument's grouping images; sdist takes (*images, vals). sum/min/max/
    sdist also emit the per-group non-null(-distinct) count (for SQL's
    NULL on an empty group); cdist emits the distinct non-null count.
    Distinct kinds are exact because after a keyed exchange every group
    lives wholly on its shard."""

    def local(v, *rest):
        m = v.shape[0]
        dev = v.device
        imgs = rest[:n_imgs]
        reps = rest[n_imgs:n_imgs + n_reps]
        avs = rest[n_imgs + n_reps:]
        vkey = torch.where(v, 0, 1).to(torch.int32)

        def boundaries(res_imgs, sv):
            b = torch.zeros((m,), dtype=torch.bool, device=dev)
            b[0] = True
            for s in res_imgs:
                b = b | _changes(s)
            prev_sv = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                                 sv[:-1]])
            return (b | ~prev_sv) & sv

        # sort: invalid rows last, then the group keys, then the row (a
        # unique last key: the order is deterministic)
        keys = [vkey, *imgs, torch.arange(m, dtype=torch.int64, device=dev)]
        res = be.multi_sort(keys, num_keys=len(keys))
        sv = res[0] == 0
        simgs = res[1:1 + n_imgs]
        order = res[-1]
        boundary = boundaries(simgs, sv)
        seg = torch.cumsum(boundary.to(torch.int32), 0) - 1
        segc = seg.clamp(0, m - 1)
        num_groups = boundary.to(torch.int32).sum()
        gvalid = torch.arange(m, dtype=torch.int32, device=dev) < num_groups
        rowpos = torch.where(sv, order, torch.zeros_like(order))
        rep_row = be.segment_max(
            torch.where(boundary, rowpos, torch.zeros_like(rowpos)), segc,
            num_segments=m)
        outs = [gvalid]
        outs += [_take_or_fill(r, rep_row) for r in reps]
        ai = 0
        for kind, n_arr, _dts in agg_descr:
            arrays = avs[ai:ai + n_arr]
            avalid = avs[ai + n_arr]
            ai += n_arr + 1
            if kind in ("cdist", "sdist"):
                # a second sort that also keys on the argument's images:
                # groups come in the main sort's order (both sort by the
                # group images first), so the outputs align by position
                aimgs = arrays[:-1] if kind == "sdist" else arrays
                dvals = arrays[-1] if kind == "sdist" else None
                keys2 = ([vkey, *imgs, (~avalid).to(torch.int32)]
                         + list(aimgs))
                carried = [avalid] + ([dvals] if dvals is not None else [])
                res2 = be.multi_sort(keys2 + carried, num_keys=len(keys2))
                sv2 = res2[0] == 0
                simgs2 = res2[1:1 + n_imgs]
                saimgs = res2[2 + n_imgs:2 + n_imgs + len(aimgs)]
                sav = res2[len(keys2)]
                b2 = boundaries(simgs2, sv2)
                seg2 = (torch.cumsum(b2.to(torch.int32), 0) - 1).clamp(0, m - 1)
                uniq = b2
                for s in saimgs:
                    uniq = uniq | _changes(s)
                uniq = uniq & sv2 & sav  # distinct NON-NULL values only
                dcnt = be.segment_sum(uniq.to(torch.int64), seg2, num_segments=m)
                if kind == "cdist":
                    outs.append(dcnt)
                else:
                    sval = res2[len(keys2) + 1]
                    outs.append(be.segment_sum(
                        torch.where(uniq, sval, torch.zeros_like(sval)), seg2,
                        num_segments=m))
                    outs.append(dcnt)
                continue
            x = arrays[0][order]
            xv = avalid[order] & sv
            cnt = be.segment_sum(xv.to(torch.int64), segc, num_segments=m)
            if kind == "count":
                outs.append(cnt)
                continue
            if kind == "sum":
                outs.append(be.segment_sum(torch.where(xv, x, torch.zeros_like(x)),
                                           segc, num_segments=m))
            else:  # min / max
                xx = x.to(torch.int32) if x.dtype == torch.bool else x
                xm = torch.where(xv, xx, torch.full_like(xx, _extreme(xx.dtype, kind)))
                red = be.segment_min if kind == "min" else be.segment_max
                outs.append(red(xm, segc, num_segments=m))
            outs.append(cnt)
        return tuple(outs)

    return local


def grouped_reduce(mesh: Mesh, valid, key_imgs: list, rep_cols: list,
                   aggs: list):
    """Per-shard final grouping of exchanged rows.
    valid/key_imgs/rep_cols: Sharded values from exchange(); aggs: list of
    (kind, arrays, valid_mask) with kind in {sum, count, min, max, cdist,
    sdist}; arrays is [vals] for sum/count/min/max, the argument's
    grouping images for cdist, and [*images, vals] for sdist.
    Returns (group_valid, rep_cols_out, agg_outs), padded and Sharded;
    agg_outs entries are (value,) for count/cdist and (value,
    nonnull_count) otherwise."""
    n = mesh.shape[_axis(mesh)]
    descr = tuple((k, len(arrs), tuple(_dtype_name(a) for a in arrs))
                  for k, arrs, _m in aggs)
    img_d = tuple(_dtype_name(i) for i in key_imgs)
    rep_d = tuple(_dtype_name(r) for r in rep_cols)
    fn = _cached(("gr2", n, img_d, rep_d, descr),
                 lambda: _local_group(len(key_imgs), len(rep_cols), descr))
    flat = []
    for _k, arrs, m in aggs:
        flat.extend(arrs)
        flat.append(m)
    args = [shard_put(mesh, a)[0]
            for a in [valid, *key_imgs, *rep_cols, *flat]]
    out = _per_shard(mesh, fn, args)
    gvalid = out[0]
    reps = out[1:1 + len(rep_cols)]
    rest = out[1 + len(rep_cols):]
    aouts = []
    i = 0
    for k, _arrs, _m in aggs:
        if k in ("count", "cdist"):
            aouts.append((rest[i],))
            i += 1
        else:
            aouts.append((rest[i], rest[i + 1]))
            i += 2
    STATS["groupbys"] += 1
    return gvalid, reps, aouts


# ------------------------------------------------------------ sample sort
def _range_dest(n_ops: int, n_split: int):
    """dest[i] = number of splitter tuples lexicographically <= row i."""

    def fn(sps, ops):
        rows = ops[0].shape[0]
        dest = torch.zeros((rows,), dtype=torch.int32, device=ops[0].device)
        for j in range(n_split):
            ge = eq = None
            for o, sp in zip(ops, sps):
                v = sp[j].item()
                gt_here, eq_here = o > v, o == v
                if ge is None:
                    ge, eq = gt_here, eq_here
                else:
                    ge = ge | (eq & gt_here)
                    eq = eq & eq_here
            dest = dest + (ge | eq).to(torch.int32)
        return dest

    return fn


def _local_sort(n_keys: int):
    def local(valid, *arrs):
        pad_key = (~valid).to(torch.int32)  # padding sorts after real rows
        out = be.multi_sort([pad_key, *arrs], num_keys=1 + n_keys)
        return (out[0] == 0,) + tuple(out[1:])

    return local


def take_rows(x: Sharded, idx: np.ndarray, idx_dev=None) -> torch.Tensor:
    """The rows of Sharded `x` at the ascending global indices `idx` (a
    host array, the same on every process), on every process. `idx_dev`
    is idx already on the lead device (one upload serves several
    columns)."""
    L = x.local_len
    bounds = np.searchsorted(idx, np.arange(x.mesh.size + 1) * L)
    if idx_dev is None:
        idx_dev = torch.from_numpy(idx).to(_lead(x.mesh))
    parts = []
    for i, s in enumerate(x.mesh.local_positions):
        local = idx_dev[int(bounds[s]):int(bounds[s + 1])] - s * L
        parts.append(x.shards[i][local.to(x.shards[i].device)])
    return gather_ragged(x.mesh, parts, np.diff(bounds), parts[0].device)


def sample_sort(mesh: Mesh, operands: list, payload: list, valid=None):
    """Distributed sample sort (the C++ engine's parallel merge sort): sample
    lexicographic splitter tuples, range-partition rows over the mesh with
    the exact-capacity all-to-all, then sort each shard locally; equal keys
    colocate, so the shards in order are the global sort.

    operands: int images in lexicographic sort order (ops/keys.sort_operands),
    global arrays or Sharded values (then all of them, and `valid` marks
    the live rows: dead and padding rows are dropped by the exchange);
    payload: more row-aligned arrays permuted along.
    Returns (valid, arrays, cap): Sharded values whose shards hold
    n_shards * cap rows each (the exchange's layout, cap its per-source
    capacity), shard s's real rows first and in sorted order; arrays are
    the operands, then the payload. Duplicate-heavy splitters cost
    balance, never correctness (ties route to one shard)."""
    n = mesh.shape[_axis(mesh)]
    sharded = isinstance(operands[0], Sharded)
    ops = list(operands) if sharded else [_as_tensor(o) for o in operands]
    rows = n * ops[0].local_len if sharded else int(ops[0].shape[0])
    # deterministic splitter sample (one small host fetch per operand; of
    # Sharded operands the global rows at the same indices, read on every
    # process)
    k = int(min(rows, max(n * 32, 256)))
    idx = np.linspace(0, rows - 1, k).astype(np.int64)
    if sharded:
        idx_dev = torch.from_numpy(idx).to(_lead(mesh))
        samples = [be.to_host(take_rows(o, idx, idx_dev)) for o in ops]
    else:
        samples = [be.to_host(o[torch.from_numpy(idx).to(o.device)])
                   for o in ops]
    order = np.lexsort(tuple(reversed(samples)))
    qpos = [min((i + 1) * k // n, k - 1) for i in range(n - 1)]
    sps = [torch.from_numpy(np.ascontiguousarray(s[order][qpos])) for s in samples]
    dts = tuple(_dtype_name(o) for o in ops)
    dfn = _cached(("rdest", n, len(ops), n - 1, dts),
                  lambda: _range_dest(len(ops), n - 1))
    if sharded:
        dest = Sharded(mesh, [dfn(sps, [o.shards[i] for o in ops])
                              for i in range(len(ops[0].shards))],
                       ops[0].local_len)
    else:
        dest = dfn(sps, ops)
    valid, arrs, glen = exchange(mesh, dest, list(ops) + list(payload), valid)
    cap = glen // n
    all_d = tuple(_dtype_name(a) for a in arrs)
    sfn = _cached(("lsort", n, len(ops), all_d, cap),
                  lambda: _local_sort(len(ops)))
    out = _per_shard(mesh, sfn, [valid, *arrs])
    STATS["sorts"] += 1
    return out[0], out[1:], cap
