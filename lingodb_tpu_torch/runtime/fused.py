"""Building blocks of the fused programs of runtime/executor.py (the fused
aggregate `Executor._try_fused_agg`, the fused chain `_try_fused_chain` and
the TopK epilogue both can carry, `_try_fused_topk`): the spine walk with its
compactions, the dimension-join lookup step, the sorted-probe semi join that
compacts as it goes, the general (large-domain) grouping, the TopK candidate
selection, and the exceptions by which a run asks to be rebuilt with other
capacities.

The JAX package traces these into one jitted XLA program per query. Here
the program is a Python function on the session's tensors, which the
executor captures once per plan and learned capacities as a CUDA graph and
then replays (runtime/exestore.py). What makes that possible also makes the
program cheap on the card: static capacities size every compaction and
every group result, so nothing inside reads a value back to the host or
copies one from it (constants are fills, backend.const; host arrays go
through backend.to_device); the executor makes one packed fetch at the end.
Data movement goes through ops/pgather.py (compact_positions,
gather_sorted, gather_chunked).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import backend as be
from ..ops import keys as keymod
from ..ops import pgather
from ..ops import scalar as sc
from ..ops.backend import tdtype
from ..plan import logical as L
from ..sql.types import K
from .vtable import SCol, dec_is_wide, np_dtype

INT64_MIN = -(1 << 63)
INT32_MIN = -(1 << 31)
LOW32 = 0xFFFFFFFF


class NotDense(Exception):
    """The program cannot handle a column or an aggregate: the executor
    declines the fused path for this plan and runs the eager operators."""


class CompactOverflow(Exception):
    """The lead compaction's survivors exceeded its sample-estimated
    capacity; the caller rebuilds without lead compaction."""


class MidCompactOverflow(Exception):
    """A learned post-join survivor cap was exceeded (args: step index,
    observed count); the caller re-learns and rebuilds."""


class KBoundsOverflow(Exception):
    """Group-key values fell outside their calibrated bounds (bounded dense
    gid); the caller drops the bounded path and rebuilds."""


class CapacityOverflow(Exception):
    """The true group count (or the fused chain's survivor count) exceeded
    the learned static capacity; the caller re-learns it and rebuilds."""


class EpiOverflow(Exception):
    """The TopK epilogue cannot prove its candidate set exact (more rows tie
    at the priority cutoff than the slack holds, or a wide sum's limbs
    overflowed the combined image); the caller records the decline and
    rebuilds without the epilogue, which then runs eagerly."""


def cumsum1d(v):
    """Inclusive prefix sum keeping v's dtype: one flat torch.cumsum, which
    on an H100 beats the blocked form about threefold at 6M int64
    (tools/kbench.py)."""
    return torch.cumsum(v, dim=0, dtype=v.dtype)


def cummax1d(v, width: int = 1024):
    """Inclusive running maximum of 1-D v in the reference's hierarchical
    form: the maximum within `width`-wide rows, the row totals scanned
    recursively, then combined. One flat torch.cummax of a 1-D tensor runs
    about a hundred times slower on an H100 at 6M int64 (tools/kbench.py);
    along the rows of a 2-D tensor the scan is a parallel one."""
    n = v.shape[0]
    if n <= 4 * width:
        return torch.cummax(v, 0).values
    pad = (-n) % width
    if pad:
        v = torch.cat([v, v[-1:].expand(pad)])
    within = torch.cummax(v.view(-1, width), 1).values
    tot = cummax1d(within[:, -1].contiguous(), width)
    # the first row takes its own first value, which changes nothing
    offs = torch.cat([within[:1, 0], tot[:-1]])
    return torch.maximum(within, offs[:, None]).reshape(-1)[:n]


def on_device(x, n: int, dev):
    """A length-n tensor on `dev` from a column part that may be a 0-dim or
    broadcast host array (constants)."""
    if not isinstance(x, torch.Tensor):
        x = be.to_device(np.ascontiguousarray(x), dev)
    if x.ndim == 0:
        x = x.reshape(1)
    if x.shape[0] != n:
        x = x.expand(n)
    return x


def _gather_env(env, idx, used_cols):
    """The columns still used, gathered at the nondecreasing positions idx
    in ONE batched sorted gather; the others pass through."""
    fetch = []
    for cid, c in env.items():
        if cid in used_cols and c.data.ndim != 0:
            fetch.append(c.data)
            if c.valid is not None:
                fetch.append(c.valid)
    got = iter(pgather.take_fast_multi(fetch, idx, monotone=True)
               if fetch else [])
    newenv = {}
    for cid, c in env.items():
        if cid not in used_cols or c.data.ndim == 0:
            newenv[cid] = c
            continue
        data = next(got)
        valid = None if c.valid is None else next(got)
        newenv[cid] = SCol(c.type, data, valid, c.dictionary)
    return newenv


def compact(env, mask, capv: int, used_cols, dev):
    """Gather the rows where `mask` holds into `capv` slots: positions from
    compact_positions, every still-used column fetched in ONE batched sorted
    gather. Returns (env, mask over the slots, exact survivor count)."""
    sel_count, idx = pgather.nonzero_positions(mask, capv)
    newmask = torch.arange(capv, device=dev) < sel_count
    return _gather_env(env, idx, used_cols), newmask, sel_count


def sorted_semi_compact(prep, env, mask, n: int, capv: int, used_cols, dev):
    """Sorted-probe semi join immediately followed by a learned compaction:
    the survivors of a semi join with a SORTED probe are <= nb contiguous,
    ascending ranges of the spine, so the capv slots are filled from the
    ranges directly, with one capv-sized sorted gather and no pass over the
    n-row spine.

    Returns (env, mask, survivors, total) or None when the step does not
    qualify. `survivors` (mask over the slots summed) is what the step
    counts learn; `total` (rows in the ranges, the incoming mask ignored) may
    exceed capv and is checked against it (MidCompactOverflow). The
    reference reports max(total, survivors) as the learned count, which
    inflates it by every row the incoming mask had already dropped."""
    if (prep["kind"] != "semi" or prep.get("direct") is not None
            or not prep.get("probe_sorted") or prep["residual"]
            or prep["payloads"] or prep.get("probe_expr2") is not None
            or prep.get("maxdup", 1) > 1):
        return None
    nb = prep["nb"]
    if nb == 0 or nb > (1 << 22):
        return None
    c = sc._bcast(sc.eval_expr(prep["probe_expr"], env), n)
    if c.valid is not None:
        return None
    c = sc.checked(c, mask, n)
    pimg = on_device(c.data, n, dev).to(torch.int64).contiguous()
    skeys = prep["arrays"][0]
    lo = torch.searchsorted(pimg, skeys, side="left")
    hi = torch.searchsorted(pimg, skeys, side="right")
    lens = hi - lo
    starts = torch.cumsum(lens, 0) - lens  # exclusive prefix (nb-sized)
    total = starts[-1] + lens[-1]
    t = torch.arange(capv, dtype=torch.int64, device=dev)
    # slot t belongs to the last range whose start <= t (empty ranges share
    # their successor's start; 'right' - 1 lands on the owning one)
    r = (torch.searchsorted(starts, t, side="right") - 1).clamp(0, nb - 1)
    pos = lo[r] + (t - starts[r])
    valid = t < total.clamp(max=capv)
    posc = torch.where(valid, pos, n - 1)  # padding repeats the last row
    newmask = valid
    if mask is not None:
        newmask = valid & (mask if mask.ndim == 0
                           else pgather.take_fast(mask, posc, monotone=True))
    newenv = _gather_env(env, posc, used_cols)
    return newenv, newmask, newmask.sum(dtype=torch.int64), total


def join_step(prep, env, mask, n: int, dev):
    """One dimension-join lookup inside the program: a direct LUT probe (or
    a binary search over the sorted unique build keys), payload gathers,
    residual predicates, and the result folded into the pipeline mask."""
    args = prep["arrays"]
    kind = prep["kind"]
    if kind == "single_broadcast":
        # 1-row build relation: broadcast its values to every probe row
        i = 0
        for cid, t, has_valid, d in prep["payloads"]:
            data = args[i][:1].expand(n)
            i += 1
            if not prep["present"]:
                valid = torch.zeros((n,), dtype=torch.bool, device=dev)
            elif has_valid:
                valid = args[i][:1].expand(n)
            else:
                valid = None
            if has_valid:
                i += 1
            env[cid] = SCol(t.as_nullable() if valid is not None else t,
                            data, valid, d)
        return mask
    c = sc.checked(sc._bcast(sc.eval_expr(prep["probe_expr"], env), n),
                   mask, n)
    pimg = on_device(c.data, n, dev).to(torch.int64)
    pvalid = None if c.valid is None else on_device(c.valid, n, dev)
    if prep.get("probe_expr2") is not None:
        c2 = sc.checked(
            sc._bcast(sc.eval_expr(prep["probe_expr2"], env), n), mask, n)
        pimg = (pimg << 32) | (on_device(c2.data, n, dev).to(torch.int64) & LOW32)
        if c2.valid is not None:
            v2 = on_device(c2.valid, n, dev)
            pvalid = v2 if pvalid is None else (pvalid & v2)
    nb = prep["nb"]
    skeys = args[0]
    i = 1
    direct = prep.get("direct")
    sorted_probe = bool(prep.get("probe_sorted"))

    def fold(found):
        if kind in ("inner", "semi"):
            return found if mask is None else mask & found
        nf = ~found
        return nf if mask is None else mask & nf

    if (kind in ("semi", "anti") and nb > 0 and direct is None
            and sorted_probe and pvalid is None
            and not prep["residual"] and not prep["payloads"]):
        # sorted-probe existence check without a per-probe binary search:
        # find each build key's contiguous probe range (nb log n work),
        # range-scatter +1/-1, and one prefix sum marks every matching row
        pimg = pimg.contiguous()
        lo = torch.searchsorted(pimg, skeys, side="left")
        hi = torch.searchsorted(pimg, skeys, side="right")
        delta = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        one = torch.ones_like(lo, dtype=torch.int32)
        delta.index_add_(0, lo, one)
        delta.index_add_(0, hi, -one)
        return fold(cumsum1d(delta[:n]) > 0)
    if prep.get("maxdup", 1) > 1 and nb > 0:
        # semi/anti over duplicate keys with a residual: probe up to maxdup
        # consecutive candidates per key (direct LUTs exist only for unique
        # keys)
        pos0 = torch.searchsorted(skeys, pimg.contiguous(), side="left")
        payload_args = []
        ii = i
        for _cid, _t, has_valid, _d in prep["payloads"]:
            payload_args.append((args[ii], args[ii + 1] if has_valid else None))
            ii += 1 + (1 if has_valid else 0)
        found = torch.zeros((n,), dtype=torch.bool, device=dev)
        for j in range(prep["maxdup"]):
            idx = pos0 + j
            idxc = idx.clamp(0, nb - 1)
            cand = (skeys[idxc] == pimg) & (idx < nb)
            for (cid, t, _hv, d), (pdata, pvarr) in zip(prep["payloads"],
                                                       payload_args):
                v = cand if pvarr is None else cand & pvarr[idxc]
                env[cid] = SCol(t.as_nullable(), pdata[idxc], v, d)
            ok = cand
            for r in prep["residual"]:
                # raised on the candidates that reach it (a join filter)
                ok = ok & sc.truth_mask(sc.checked(
                    sc.eval_expr(r, env), _and_mask(ok, mask), n))
            found = found | ok
        if pvalid is not None:
            found = found & pvalid
        return fold(found)
    if nb == 0:
        found = torch.zeros((n,), dtype=torch.bool, device=dev)
        posc = torch.zeros((n,), dtype=torch.int64, device=dev)
    elif direct is not None:
        kmin, span = direct
        off = pimg - kmin
        # LUT probe through the gather kernels: a sorted probe column (TPC-H
        # lineitem is clustered by l_orderkey) reads it in order. Misses
        # read position 0 and are masked by `found`; the reference instead
        # forward-fills them with a running maximum so that its windowed
        # gather sees monotone indices, which the port's gather does not
        # need.
        p = pgather.take_fast(skeys, off.clamp(0, span - 1),
                              monotone=sorted_probe).to(torch.int64)
        found = (off >= 0) & (off < span) & (p >= 0)
        posc = p.clamp(0, max(nb - 1, 0))
    else:
        p = torch.searchsorted(skeys, pimg.contiguous(), side="left")
        posc = p.clamp(0, nb - 1)
        found = skeys[posc] == pimg
    if pvalid is not None:
        found = found & pvalid
    # payload columns (left-join semantics: NULL when not found), gathered
    # in ONE batched call per join
    gather_args = []
    for _cid, _t, has_valid, _d in prep["payloads"]:
        if nb > 0:
            gather_args.append(args[i])
            if has_valid:
                gather_args.append(args[i + 1])
        i += 1 + (1 if has_valid else 0)
    gathered = pgather.take_fast_multi(
        gather_args, posc,
        monotone=sorted_probe and direct is not None) if gather_args else []
    gi = 0
    for cid, t, has_valid, d in prep["payloads"]:
        if nb == 0:
            data = torch.zeros((n,), dtype=tdtype(np_dtype(t)), device=dev)
            valid = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            data = gathered[gi]
            gi += 1
            valid = found
            if has_valid:
                valid = valid & gathered[gi]
                gi += 1
        env[cid] = SCol(t.as_nullable(), data, valid, d)
    for r in prep["residual"]:
        found = found & sc.truth_mask(sc.checked(
            sc.eval_expr(r, env), _and_mask(found, mask), n))
    if prep["residual"]:
        for cid, _t, _hv, d in prep["payloads"]:
            old = env[cid]
            env[cid] = SCol(old.type, old.data,
                            found if old.valid is None else old.valid & found, d)
    if kind not in ("inner", "semi", "anti"):
        return mask  # left / single: payload validity carries `found`
    return fold(found)


def run_spine(steps, join_preps, base_cols, base_restrictions, n: int, dev,
              meta, *, compact_k, lead, used_after, used_from, mid_caps,
              join_sis, pad_mask=None):
    """The spine inside a fused program (aggregate or chain): the base
    restrictions, then each Select/Map/dimension-Join step in turn, with the
    lead compaction before step `lead` and a learned compaction after each
    join in `mid_caps`. Returns (env, mask, rows, out): `out` holds each
    compaction's exact survivor count ("extras", described in
    meta["extras"]) and the survivors after each narrowing join
    ("step_counts", one per meta["join_sis"]). `pad_mask` (one mesh
    position's shard of a table held on the mesh) starts the mask: its pad
    rows are no rows."""
    env = {cid: SCol(t.type, t.data, t.valid, t.dictionary)
           for cid, t in base_cols}
    mask = pad_mask
    for r in base_restrictions:
        # a row raises only in the restrictions it reaches
        m = sc.truth_mask(sc.checked(sc.eval_expr(r, env), mask, n))
        mask = m if mask is None else mask & m
    cur_n = n
    extras = []       # (descriptor, survivor count) per compaction
    step_counts = []  # survivors after each narrowing join
    for si, step in enumerate(steps):
        if (compact_k is not None and si == lead
                and mask is not None and mask.ndim != 0):
            env, mask, sel_count = compact(env, mask, compact_k, used_after,
                                           dev)
            cur_n = compact_k
            extras.append((("lead", compact_k), sel_count))
        if step[0] == "sm" and isinstance(step[1], L.Select):
            m = sc.truth_mask(sc.checked(
                sc.eval_expr(step[1].predicate, env), mask, cur_n))
            mask = m if mask is None else mask & m
        elif step[0] == "sm":
            for info, e in step[1].computed:
                env[info.cid] = sc.eval_expr(e, env)
            sc.checked_all(env, [info.cid for info, _e in step[1].computed],
                           mask, cur_n)
        else:
            prep = join_preps[si]
            rsc = None
            if si in mid_caps:
                rsc = sorted_semi_compact(prep, env, mask, cur_n, mid_caps[si],
                                          used_from[si + 1], dev)
            if rsc is not None:
                env, mask, survivors, total = rsc
                if si in join_sis:
                    step_counts.append(survivors)
                cur_n = mid_caps[si]
                extras.append((("mid", si, mid_caps[si]), total))
                continue
            mask = join_step(prep, env, mask, cur_n, dev)
            if si in join_sis:
                # survivors after every narrowing join: the engine LEARNS
                # where to compact from them
                if mask is None:
                    step_counts.append(be.const(cur_n, dev))
                elif mask.ndim == 0:
                    step_counts.append(
                        torch.where(on_device(mask, 1, dev)[0], cur_n, 0))
                else:
                    step_counts.append(mask.sum(dtype=torch.int64))
            if si in mid_caps and mask is not None and mask.ndim != 0:
                capv = mid_caps[si]
                env, mask, sel_count = compact(env, mask, capv,
                                               used_from[si + 1], dev)
                cur_n = capv
                extras.append((("mid", si, capv), sel_count))
    meta["extras"] = tuple(d for d, _c in extras)
    meta["join_sis"] = tuple(join_sis)
    out = {"extras": [c for _d, c in extras], "step_counts": step_counts}
    return env, mask, cur_n, out


def _and_mask(m, mask):
    return m if mask is None else m & mask


def dev_lane(x, n: int, dev):
    """A column part as a length-n tensor on `dev` for an output lane; a
    host-only (object) part cannot ride the program."""
    if isinstance(x, np.ndarray) and x.dtype == object:
        raise NotDense("fused output: host-only (object) column")
    return on_device(x, n, dev)


def topk_candidates(prio, kk: int, keep):
    """The kk rows of largest priority, in an explicit order: priority
    descending, then row ascending (the order of the reference's top_k;
    torch.topk leaves equal values in no order, on the card or on the CPU).
    Returns (candidate rows, the kept rows whose priority reaches the
    cutoff, the kk-th priority). When that count is at most kk, every row
    reaching the cutoff is a candidate, so the candidate set holds the true
    top k under any finer order; otherwise the caller declines."""
    vals, cand = torch.topk(prio, kk, sorted=True)
    tie_cnt = ((prio >= vals[kk - 1]) & keep).sum(dtype=torch.int64)
    cand = torch.sort(cand).values
    cand = cand[torch.sort(prio[cand], descending=True, stable=True).indices]
    return cand, tie_cnt


def take_candidates(env, cids, cand, n: int, dev):
    """The output lanes of columns `cids` at the candidate rows (plain
    indexing, clamped, as the reference's take with mode="clip") and their
    templates (cid, type, dictionary, has validity)."""
    cand = cand.clamp(0, n - 1)
    lanes, templates = [], []
    for cid in cids:
        c = sc._bcast(env[cid], n)
        lanes.append(dev_lane(c.data, n, dev)[cand])
        if c.valid is not None:
            lanes.append(dev_lane(c.valid, n, dev)[cand])
        templates.append((cid, c.type, c.dictionary, c.valid is not None))
    return lanes, templates


def apply_topk_epi(op, epi, grp, meta, dev):
    """Fold a TopK epilogue into the general grouping: build the group-space
    environment from the kg-slot reduction lanes, evaluate the Map steps
    between the Aggregate and the TopK, rank the groups by the primary sort
    key's priority image (keys.topk_priority) and keep the top kk candidate
    rows of every output column. Returns the group count, the tie count at
    the cutoff, the wide-limb flag and the candidate lanes; the host re-sorts
    the candidates under the full key order (Executor._try_fused_topk)."""
    kg = meta["kg"]
    g = grp["g"]
    lanes = grp["lanes"]
    env = {}
    i = 0
    for pos, cid in enumerate(op.group_by):
        ktype, kdict, knull = meta["key_templates"][pos]
        env[cid] = SCol(ktype, lanes[i], lanes[i + 1] if knull else None, kdict)
        i += 2 if knull else 1
    rows_ok = torch.arange(kg, device=dev) < g
    limbflag = torch.zeros((), dtype=torch.bool, device=dev)
    for spec in op.aggs:
        cid = spec.out.cid
        if cid in meta["agg_limbs"]:
            hi, lo, cnt = lanes[i], lanes[i + 1], lanes[i + 2]
            i += 3
            limbflag = limbflag | (((hi.abs() >> 30) > 0) & rows_ok).any()
            env[cid] = SCol(spec.out.type, (hi << 32) + lo, cnt > 0,
                            meta["agg_dicts"].get(cid))
        elif spec.fn in ("count", "count_star"):
            env[cid] = SCol(spec.out.type, lanes[i], None)
            i += 2
        else:
            env[cid] = SCol(spec.out.type, lanes[i], lanes[i + 1] > 0,
                            meta["agg_dicts"].get(cid))
            i += 2
    for m in epi["maps"]:
        for info, e in m.computed:
            env[info.cid] = sc._bcast(sc.eval_expr(e, env), kg)
        sc.checked_all(env, [info.cid for info, _e in m.computed], rows_ok,
                       kg)
    k0 = epi["node"].keys[0]
    prio = keymod.topk_priority(env[k0.cid], k0.ascending, k0.nulls_first,
                                rows_ok)
    if prio is None:
        raise NotDense("topk epilogue: the primary key has no order image")
    kk = min(epi["kk"], kg)
    cand, tie_cnt = topk_candidates(dev_lane(prio, kg, dev), kk, rows_ok)
    out_lanes, templates = take_candidates(env, epi["out_cids"], cand, kg, dev)
    meta["epi"] = {"kk": kk, "k": epi["k"], "templates": templates}
    return {"g": g, "tie": tie_cnt, "limbflag": limbflag, "lanes": out_lanes}


def _sort_words(key_cols, in_mask, n: int, dev):
    """The lexicographic sort key (masked rows last, then the grouping
    images of grouping_images) packed into as few int64 words as the
    images' widths allow, most significant word first. Each piece is an
    unsigned field: the mask and NULL flags 1 bit, a dictionary code as many
    bits as its dictionary needs, a 32-bit image biased by 2^31; a 64-bit
    image is a word of its own in signed order."""
    pieces = [((~in_mask).to(torch.int64), 1)]
    for c in key_cols:
        valid = None if c.valid is None else on_device(c.valid, n, dev)
        if valid is not None:
            pieces.append(((~valid).to(torch.int64), 1))
        img = on_device(keymod.order_image(c), n, dev)
        if valid is not None:
            img = torch.where(valid, img, 0)
        if c.type.is_string and c.dictionary is not None:
            pieces.append((img.to(torch.int64),
                           max(1, (len(c.dictionary) - 1).bit_length())))
        elif c.type.kind == K.BOOL:
            pieces.append((img.to(torch.int64), 1))
        elif img.dtype == torch.int64:
            pieces.append((img, 64))
        else:
            pieces.append((img.to(torch.int64) - INT32_MIN, 32))
    words, cur, cur_bits = [], None, 0
    for val, bits in pieces:
        if cur is not None and (bits == 64 or cur_bits + bits > 63):
            words.append(cur)
            cur, cur_bits = None, 0
        if bits == 64:
            words.append(val)
            continue
        cur = val if cur is None else (cur << bits) | val
        cur_bits += bits
    if cur is not None:
        words.append(cur)
    return words


def _lexsort(words):
    """Permutation that sorts rows by `words` (most significant first),
    stable: one stable radix sort per word, least significant first."""
    perm = None
    for w in reversed(words):
        kk = w if perm is None else w[perm]
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def general_group(op, key_cols, env, mask, n: int, meta, dev, presorted=False,
                  kg=None):
    """General (large-domain) grouping inside the program. Rows are sorted
    by (masked last, key images) with one stable sort per packed key word;
    the payloads every aggregate needs are fetched once by the permutation;
    group starts come from compact_positions over the boundary flags; each
    aggregate reduces by a prefix sum or a packed running maximum read at
    the group boundaries. Emits kg-slot lanes and the group count; the
    executor slices the first `count` slots.

    presorted=True (caller-proven: one integer-image key riding a clustered
    base column through an order-preserving spine) skips the sort: masked
    rows stay in place with their contributions zeroed, and a boundary opens
    where an unmasked row's key exceeds the running maximum of the unmasked
    keys before it.

    kg is the static group capacity. None calibrates: the program returns
    the group count alone and the executor learns the capacity from it.
    The boundary gathers are monotone (group starts ascend; the padding
    past the group count is the sentinel), so at every capacity they take
    the sorted-gather kernel through pgather.take_fast_multi."""
    meta["calibrating"] = kg is None
    kg = n if kg is None else min(kg, n)
    meta["kg"] = kg
    meta["n"] = n

    def bgather(arrs, idx):
        return pgather.take_fast_multi(arrs, idx, monotone=True)

    in_mask = (torch.ones((n,), dtype=torch.bool, device=dev)
               if mask is None else mask)
    payload: list = []
    slot_of: dict = {}

    def ride(a):
        s_ = slot_of.get(id(a))
        if s_ is None:
            s_ = len(payload)
            payload.append(on_device(a, n, dev))
            slot_of[id(a)] = s_
        return s_

    key_slots = []
    for c in key_cols:
        key_slots.append((ride(c.data),
                          None if c.valid is None else ride(c.valid)))
    agg_args = []
    for spec in op.aggs:
        if spec.fn == "count_star":
            agg_args.append(None)
            continue
        arg = sc._bcast(env[spec.arg], n)
        dslot = ride(arg.data) if spec.fn != "count" else None
        vslot = None if arg.valid is None else ride(arg.valid)
        agg_args.append((arg, dslot, vslot))

    if presorted:
        inm_s = in_mask
        pay_s = payload
        img = on_device(keymod.grouping_images(key_cols)[-1], n, dev)
        lo = torch.iinfo(img.dtype).min
        # previous unmasked key via running max (img is nondecreasing on
        # unmasked rows); a masked row never opens a boundary
        pm = cummax1d(torch.where(in_mask, img, lo))
        prev = torch.cat([torch.full((1,), lo, dtype=img.dtype, device=dev),
                          pm[:-1]])
        # the first unmasked row always opens a group (img > prev fails only
        # where img is the dtype's minimum)
        first_un = in_mask & (cumsum1d(in_mask.to(torch.int32)) == 1)
        boundary = in_mask & ((img > prev) | first_un)
    else:
        words = _sort_words(key_cols, in_mask, n, dev)
        perm = _lexsort(words)
        got = pgather.take_fast_multi(payload + [in_mask] + words, perm)
        pay_s = got[:len(payload)]
        inm_s = got[len(payload)]
        boundary = torch.zeros((n,), dtype=torch.bool, device=dev)
        boundary[:1].fill_(True)  # a fill: no host scalar is copied
        for w in got[len(payload) + 1:]:
            boundary[1:] |= w[1:] != w[:-1]
        boundary &= inm_s
    num_groups = boundary.sum(dtype=torch.int64)
    if meta["calibrating"]:
        return {"g": num_groups}
    cnt32 = num_groups.to(torch.int32)
    # group-start positions, compacted and sentinel-padded (monotone).
    # Masked rows sit after the last group start (sorted) or inside groups
    # (presorted) and every reduction zeroes them, so extents stay right.
    _, bpos = pgather.nonzero_positions(boundary, kg)
    ar = torch.arange(kg, dtype=torch.int32, device=dev)
    nxt = torch.cat([bpos[1:], torch.full((1,), n, dtype=torch.int32,
                                          device=dev)])
    lpos = torch.where(ar < cnt32 - 1, nxt - 1, n - 1).to(torch.int32)

    # every boundary gather is deferred into three batched calls (at bpos,
    # lpos and bpos - 1)
    g_bpos: list = []
    g_lpos: list = []
    g_bm1: list = []

    def defer(lst, arr):
        lst.append(arr)
        return len(lst) - 1

    def gsum(v):
        """Per-group sum of a sorted, already-masked column: prefix sums
        differenced at the boundaries (groups are contiguous, non-empty)."""
        cs = cumsum1d(v)
        return ("sum", defer(g_lpos, cs), defer(g_bm1, cs))

    # segmented extrema as ONE running max over (group id << 32) | image:
    # group ids are nondecreasing, so at a group's last row the low 32 bits
    # of the running max are that group's best image
    gid64 = (cumsum1d(boundary.to(torch.int64)) - 1).clamp(min=0)
    pos64 = torch.arange(n, dtype=torch.int64, device=dev)

    def packed_cummax_low32(tr):
        return cummax1d((gid64 << 32) | tr) & LOW32

    def gminmax(v, fn, keep):
        """Per-group min/max. 32-bit values take one packed running max;
        64-bit values (int64, f64, scaled decimals) two: the high limb
        first, then the low limb among the rows that reach their group's
        best high limb. Floats go through the sign-flip bit image, so
        unsigned integer order is float order."""
        dt = v.dtype
        if dt in (torch.int32, torch.bool, torch.int16, torch.int8,
                  torch.float32):
            if dt == torch.float32:
                b = v.view(torch.int32)
                u = b ^ ((b >> 31) | INT32_MIN)
                img = u.to(torch.int64) & LOW32
            else:
                img = v.to(torch.int64) - INT32_MIN
            if fn == "min":
                img = LOW32 - img
            img = torch.where(keep, img, 0)
            return ("minmax32", defer(g_lpos, packed_cummax_low32(img)), fn, dt)
        if dt not in (torch.int64, torch.float64):
            raise NotDense(f"general fused {fn}: unsupported dtype {dt}")
        if dt == torch.float64:
            b = v.view(torch.int64)
            u = b ^ ((b >> 63) | INT64_MIN)
        else:
            u = v ^ INT64_MIN  # unsigned-order image
        if fn == "min":
            u = ~u
        uhi = (u >> 32) & LOW32
        ulo = u & LOW32
        hi_best = packed_cummax_low32(torch.where(keep, uhi, 0))
        return ("minmax64", defer(g_lpos, hi_best), fn, dt, uhi, ulo, keep)

    def gfirst_valid(dslot, vslot):
        """any_value: the FIRST row of the group whose argument is valid;
        only the row position is packed, so any width works."""
        keep = inm_s if vslot is None else (inm_s & pay_s[vslot])
        tr = torch.where(keep, LOW32 - pos64, 0)
        return ("firstpos", defer(g_lpos, packed_cummax_low32(tr)), dslot)

    outs = []
    for dslot, vslot in key_slots:
        outs.append(("at_b", defer(g_bpos, pay_s[dslot])))
        if vslot is not None:
            outs.append(("at_b", defer(g_bpos, pay_s[vslot])))

    ones = inm_s.to(torch.int64)
    meta["agg_dicts"] = {}
    meta["agg_limbs"] = set()
    for spec, slots in zip(op.aggs, agg_args):
        if spec.fn == "count_star":
            cnt = gsum(ones)
            outs.append(cnt)
            outs.append(cnt)
            continue
        arg, dslot, vslot = slots
        avalid_s = None if vslot is None else pay_s[vslot]
        vm = ones if avalid_s is None else torch.where(avalid_s, ones, 0)
        cnt = gsum(vm)
        if spec.fn == "count":
            outs.append(cnt)
            outs.append(cnt)
            continue
        data_s = pay_s[dslot].to(tdtype(np_dtype(spec.out.type)))
        if spec.fn == "sum":
            data_s = torch.where(vm > 0, data_s, torch.zeros_like(data_s))
            if (spec.out.type.kind == K.DECIMAL and dec_is_wide(spec.out.type)
                    and data_s.dtype == torch.int64):
                # exact wide sum: 32-bit-split accumulators (lo in [0, 2^32),
                # hi signed), recombined exactly on the host (ops/decwide.py)
                meta["agg_limbs"].add(spec.out.cid)
                outs.append(gsum(data_s >> 32))
                outs.append(gsum(data_s & LOW32))
                outs.append(cnt)
                continue
            outs.append(gsum(data_s))
            outs.append(cnt)
            continue
        if spec.fn == "any_value":
            outs.append(gfirst_valid(dslot, vslot))
            outs.append(cnt)
            meta["agg_dicts"][spec.out.cid] = arg.dictionary
            continue
        keep = inm_s if avalid_s is None else (inm_s & avalid_s)
        outs.append(gminmax(data_s, spec.fn, keep))
        outs.append(cnt)
        meta["agg_dicts"][spec.out.cid] = arg.dictionary

    got_b = bgather(g_bpos, bpos)
    got_l = bgather(g_lpos, lpos)
    got_m1 = bgather(g_bm1, (bpos - 1).clamp(min=0))

    # second wave of 64-bit extrema: among rows reaching their group's best
    # HIGH limb (broadcast back by a monotone gather at the group id), the
    # best LOW limb
    g_lpos2: list = []
    mm64_slot: dict = {}
    gid32 = gid64.to(torch.int32)
    for o in outs:
        if isinstance(o, tuple) and o[0] == "minmax64" and id(o) not in mm64_slot:
            _tag, slot_hi, _fn, _dt, uhi, ulo, keep64 = o
            hi_row = pgather.take_fast(got_l[slot_hi], gid32, monotone=True)
            tr = torch.where(keep64 & (uhi == hi_row), ulo, 0)
            mm64_slot[id(o)] = len(g_lpos2)
            g_lpos2.append(packed_cummax_low32(tr))
    got_l2 = bgather(g_lpos2, lpos)

    def resolve(o):
        if o[0] == "at_b":
            return got_b[o[1]]
        if o[0] == "minmax32":
            low = got_l[o[1]]
            if o[2] == "min":
                low = LOW32 - low
            if o[3] == torch.float32:
                # undo the unsigned image; low is in [0, 2^32)
                u32 = torch.where(low >= 1 << 31, low - (1 << 32), low)
                u32 = u32.to(torch.int32)
                return (u32 ^ (~(u32 >> 31) | INT32_MIN)).view(torch.float32)
            return (low + INT32_MIN).to(o[3])
        if o[0] == "minmax64":
            u = (got_l[o[1]] << 32) | got_l2[mm64_slot[id(o)]]
            if o[2] == "min":
                u = ~u
            if o[3] == torch.float64:
                return (u ^ (~(u >> 63) | INT64_MIN)).view(torch.float64)
            return u ^ INT64_MIN
        if o[0] == "firstpos":
            low = got_l[o[1]]
            fpos = (LOW32 - low).to(torch.int32)
            # groups with no valid row read their start row (kept monotone);
            # their count of 0 makes them NULL
            fpos = torch.where(low == 0, bpos, fpos)
            return bgather([pay_s[o[2]]], fpos)[0]
        hi, lo = got_l[o[1]], got_m1[o[2]]
        return hi - torch.where(bpos == 0, torch.zeros_like(lo), lo)

    return {"g": num_groups, "lanes": [resolve(o) for o in outs]}
