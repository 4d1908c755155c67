"""Plan executor: walks the logical plan and runs vectorized operators.

Equivalent of the reference's generated query code + runtime
(reference: SubOpToControlFlow.cpp emits imperative code per pipeline that the
LLVM JIT runs tuple-at-a-time; here each operator is a set of whole-column
tensor ops). Dynamic result sizes surface as exactly one host sync per
size-changing operator (filter compaction, join expansion, group count).

This is the EAGER executor: one operator at a time, each materializing its
result. The JAX package also has fused single-program pipelines
(`_try_fused_agg`, `_try_fused_chain`, `_try_fused_topk`), sharded mesh
operators and an out-of-core streaming aggregate; every one of those may
decline there, and the eager operators below are what then runs. Here they
exist as methods that always decline (return None) until they are ported —
see ROADMAP.md, queue A.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops import backend as be
from ..ops.backend import xnp as jnp

from ..ops import groupby as gb
from ..ops import join as joinops
from ..ops import keys as keymod
from ..ops import pgather
from ..ops import scalar as sc
from ..ops import strings as strmod
from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import Call, ColRef
from ..sql.types import Type
from ..utils import tracer
from .result import ResultTable
from .vtable import SCol, VTable, is_obj, np_dtype


class ExecError(Exception):
    pass


class Executor:
    """Executes logical plans against a session's storage."""

    track_tuples: dict | None = None

    def __init__(self, session):
        self.session = session
        # shared-subtree results, valid for one plan execution
        # (reference: the materialized relalg.tmp buffer, RelAlgOps.td:499)
        self._tmp_results: dict[int, VTable] = {}
        self._mode = "DEFAULT"

    # ------------------------------------------------------------- dispatch
    def execute(self, plan: L.Materialize) -> ResultTable:
        from . import device as dv
        from ..utils.settings import EXECUTION_MODE

        self._tmp_results.clear()
        # execution modes (reference: ExecutionMode + CPULLVMDebugBackend,
        # src/execution/LLVMBackends.cpp:939-1010):
        #   DEFAULT  fast path
        #   DEBUG    verify every operator's output invariants
        # (the reference's PERF per-operator profile is not ported yet)
        self._mode = str(EXECUTION_MODE.get()).upper()
        with tracer.Trace("execution", "run_plan"):
            vt = self.run(plan.child).dense()
        # ONE packed device->host transfer for the whole result
        needed = VTable({cid: vt.col(cid) for cid in set(plan.cids)}, vt.num_rows)
        host = dv.fetch_vtable_np(needed) if vt.num_rows else {}
        names, types, cols, valids, dicts = [], [], [], [], []
        for cid, name in zip(plan.cids, plan.names):
            c = vt.col(cid)
            names.append(name)
            types.append(c.type)
            if vt.num_rows:
                cols.append(host[("d", cid)])
                valids.append(host.get(("v", cid)))
            else:
                cols.append(np.zeros(0, dtype=be.dt(c.data)))
                valids.append(None)
            dicts.append(c.dictionary)
        return ResultTable(names, types, cols, valids, dicts, vt.num_rows)

    def run(self, op: L.LogicalOp) -> VTable:
        method = getattr(self, "_run_" + type(op).__name__.lower(), None)
        if method is None:
            raise ExecError(f"no executor for {type(op).__name__}")
        vt = method(op)
        if self._mode == "DEBUG":
            self._debug_verify(op, vt)
        if self.track_tuples is not None:
            # per-operator output cardinalities (reference: relalg.track_tuples
            # / subop.set_tracked_count, RelAlgOps.td:530, ExecutionContext.h:63)
            self.track_tuples[id(op)] = (
                vt.num_rows if vt.row_valid is None
                else int(jnp.sum(vt.row_valid)))
        # small results migrate to the host numpy tier (runtime/device.py)
        if type(op).__name__ in ("Aggregate", "Select", "Join", "TopK", "Limit",
                                 "Distinct", "SetOp"):
            from . import device as dv

            vt = dv.demote_small(vt)
        return vt

    def _debug_verify(self, op: L.LogicalOp, vt: VTable) -> None:
        """DEBUG execution mode: operator-output invariant checks (the
        analogue of the reference's CPULLVMDebugBackend, which runs the
        generated program with verification enabled)."""
        n = vt.num_rows
        if not isinstance(n, int) or n < 0:
            raise ExecError(f"DEBUG {type(op).__name__}: bad num_rows {n!r}")
        for cid, c in vt.cols.items():
            shape = getattr(c.data, "shape", None)
            if shape is not None and tuple(shape) != () and shape[0] != n:
                raise ExecError(
                    f"DEBUG {type(op).__name__}: column {cid} has "
                    f"{shape[0]} rows, table has {n}")
            if c.valid is not None and tuple(getattr(c.valid, "shape", (n,)))[0] != n:
                raise ExecError(
                    f"DEBUG {type(op).__name__}: column {cid} validity "
                    f"length mismatch")
            d = c.dictionary
            if d is not None and len(d) > 1:
                if not all(d[i] <= d[i + 1] for i in range(len(d) - 1)):
                    raise ExecError(
                        f"DEBUG {type(op).__name__}: column {cid} dictionary "
                        f"not sorted (order-preserving code invariant broken)")
        if any(be.is_torch(c.data) for c in vt.cols.values()):
            # one tier per table: beside tensors only wide-decimal object
            # columns may be host arrays (a numpy column meeting a CUDA
            # tensor in an infix operation raises only on the card)
            for cid, c in vt.cols.items():
                for part in (c.data, c.valid):
                    if (isinstance(part, np.ndarray) and part.ndim
                            and not is_obj(c.data)):
                        raise ExecError(
                            f"DEBUG {type(op).__name__}: column {cid} is a "
                            f"host array in a device table")
        produced = {c.cid for c in op.output_cols()}
        missing = produced - set(vt.cols)
        if missing:
            raise ExecError(
                f"DEBUG {type(op).__name__}: output columns {missing} "
                f"missing from result")

    # ------------------------------------------ paths that are not ported yet
    # Each declines, as the reference's own versions may, and the eager
    # operator then runs (ROADMAP.md queue A7, A8, A11).
    def _try_fused_agg(self, op, epi=None) -> Optional[VTable]:
        return None

    def _try_fused_chain(self, op, epi=None) -> Optional[VTable]:
        return None

    def _try_fused_topk(self, op) -> Optional[VTable]:
        return None

    def _try_chunked_agg(self, op) -> Optional[VTable]:
        return None

    def _try_sharded_agg(self, op, vt) -> Optional[VTable]:
        return None

    def _try_sharded_join(self, op, kind, lvt, rvt, lk, rk,
                          null_safe) -> Optional[VTable]:
        return None

    def _try_distributed_sort(self, op, vt) -> Optional[VTable]:
        return None

    def _run_window(self, op) -> VTable:
        raise ExecError("not yet ported: window functions (ROADMAP queue A8)")

    def _run_iterate(self, op) -> VTable:
        raise ExecError("not yet ported: Iterate / WITH RECURSIVE "
                        "(ROADMAP queue A8)")

    def _run_iterref(self, op) -> VTable:
        raise ExecError("not yet ported: Iterate / WITH RECURSIVE "
                        "(ROADMAP queue A8)")

    def _chunked_nonequi_join(self, op, kind, lvt, rvt) -> VTable:
        raise ExecError("not yet ported: non-equi join beyond 2^26 candidate "
                        "pairs (ROADMAP queue A8)")

    # ------------------------------------------------------------- leaves
    def _run_scan(self, op: L.Scan) -> VTable:
        dev = self.session.device_table(op.table)
        cols = {}
        n = dev["__num_rows__"]
        for c in op.cols:
            cols[c.cid] = dev[c.name]
        vt = VTable(cols, n)
        # ONE combined compaction for every pushed restriction: each
        # select_mask costs a count sync + a gather over all columns —
        # evaluating restrictions on the full columns first is safe
        # (excluded rows' predicate garbage is masked by the conjunction)
        mask = None
        for r in op.restrictions:
            m = jnp.broadcast_to(
                sc.truth_mask(sc.eval_expr(r, vt.cols)), (n,))
            mask = m if mask is None else mask & m
        if mask is not None:
            vt = vt.select_mask(mask)
        return vt

    def _run_constrel(self, op: L.ConstRel) -> VTable:
        n = len(op.rows)
        cols = {}
        for i, info in enumerate(op.cols):
            vals = [r[i] for r in op.rows]
            cols[info.cid] = _scol_from_values(vals, info.type)
        return VTable(cols, n)

    # ------------------------------------------------------------- unary ops
    def _run_select(self, op: L.Select) -> VTable:
        fused = self._try_fused_chain(op)
        if fused is not None:
            return fused
        vt = self.run(op.child)
        if vt.num_rows == 0:
            return vt
        mask = sc.truth_mask(sc.eval_expr(op.predicate, vt.cols))
        mask = jnp.broadcast_to(mask, (vt.num_rows,))
        if vt.row_valid is not None:
            # dead rows' predicate garbage is masked by the conjunction
            return VTable(vt.cols, vt.num_rows, row_valid=vt.row_valid & mask)
        return vt.select_mask(mask)

    def _run_map(self, op: L.Map) -> VTable:
        vt = self.run(op.child)
        cols = dict(vt.cols)
        for info, expr in op.computed:
            c = sc._bcast(sc.eval_expr(expr, cols), vt.num_rows)
            cols[info.cid] = c
        return VTable(cols, vt.num_rows, row_valid=vt.row_valid)

    def _run_limit(self, op: L.Limit) -> VTable:
        vt = self.run(op.child).dense()
        lo = min(op.offset, vt.num_rows)
        hi = min(op.offset + op.n, vt.num_rows)
        idx = jnp.arange(lo, hi, dtype=jnp.int64)
        return vt.take(idx, hi - lo)

    def _run_sort(self, op: L.Sort) -> VTable:
        vt = self.run(op.child).dense()
        if vt.num_rows == 0:
            return vt
        dist = self._try_distributed_sort(op, vt)
        if dist is not None:
            return dist
        perm = keymod.sort_permutation(
            [(vt.col(k.cid), k.ascending, k.nulls_first) for k in op.keys],
            vt.num_rows,
        )
        return vt.take(perm, vt.num_rows)

    def _run_topk(self, op: L.TopK) -> VTable:
        fused = self._try_fused_topk(op)
        if fused is not None:
            return fused
        vt = self.run(op.child).dense()
        if vt.num_rows == 0:
            return vt
        perm = keymod.sort_permutation(
            [(vt.col(k.cid), k.ascending, k.nulls_first) for k in op.keys],
            vt.num_rows,
        )
        lo = min(op.offset, vt.num_rows)
        hi = min(op.offset + op.n, vt.num_rows)
        return vt.take(perm[lo:hi], hi - lo)

    def _run_distinct(self, op: L.Distinct) -> VTable:
        vt = self.run(op.child).dense()
        if vt.num_rows == 0:
            return vt
        grp = gb.group_rows([vt.col(c) for c in op.cids], vt.num_rows)
        rep = grp["rep_rows"]
        return vt.take(rep, grp["num_groups"])

    def _run_materialize(self, op: L.Materialize) -> VTable:
        return self.run(op.child).dense()

    def _run_tmp(self, op: L.Tmp) -> VTable:
        """Materialize the shared subtree ONCE per execution; every Tmp
        reference renames the holder's columns to its own cids (reference:
        relalg.tmp / GetLocal lowering, RelAlgToSubOp.cpp)."""
        vt = self._tmp_results.get(id(op.holder))
        if vt is None:
            vt = self.run(op.holder.plan).dense()
            self._tmp_results[id(op.holder)] = vt
        cols = {c.cid: vt.col(s) for s, c in op.mapping}
        return VTable(cols, vt.num_rows)

    # ------------------------------------------------------------- aggregate
    def _run_aggregate(self, op: L.Aggregate) -> VTable:
        fused = self._try_fused_agg(op)
        if fused is not None:
            return fused
        vt = self.run(op.child)
        sharded = self._try_sharded_agg(op, vt)
        if sharded is not None:
            return sharded
        vt = vt.dense()
        n = vt.num_rows
        key_cols = [vt.col(c) for c in op.group_by]
        if op.group_by:
            if n == 0:
                return VTable({c.cid: _empty_scol(c.type, _first_tensor(vt))
                               for c in op.output_cols()}, 0)
            grp = gb.group_rows(key_cols, n)
        else:
            ref = _first_tensor(vt)
            grp = {
                "seg": be.full(n, 0, jnp.int32, ref),
                "order": None,
                "num_groups": 1,
                "rep_rows": be.full(1, 0, jnp.int64, ref),
                "sorted": True,
            }
        cols: dict[int, SCol] = {}
        for info in op.group_cols:
            cols[info.cid] = vt.col(info.cid).take(grp["rep_rows"])
        for spec in op.aggs:
            arg = None if spec.arg is None else vt.col(spec.arg)
            if spec.distinct and spec.fn in ("count", "sum"):
                cols[spec.out.cid] = gb.distinct_reduce(spec.fn, key_cols, arg, grp, spec.out.type, n)
                continue
            # distinct is a no-op for min/max; avg distinct was decomposed by
            # the binder into sum distinct / count distinct
            cols[spec.out.cid] = gb.aggregate(spec.fn, arg, spec.out.type, grp)
        return VTable(cols, grp["num_groups"])

    # ------------------------------------------------------------- joins
    def _run_join(self, op: L.Join) -> VTable:
        fused = self._try_fused_chain(op)
        if fused is not None:
            return fused
        from . import device as dv

        lvt = self.run(op.left)
        rvt = self.run(op.right)
        lvt, rvt = dv.align_devices(lvt, rvt)
        kind = op.kind
        nl, nr = lvt.num_rows, rvt.num_rows

        if kind == "cross" and op.predicate is None:
            return self._cross(lvt.dense(), rvt.dense())

        # empty-side early outs (also avoid gathers from empty arrays);
        # selection vectors are materialized first so that no filtered-out
        # row can come back through a side that is passed on as it is
        if nl == 0 or nr == 0:
            lvt, rvt = lvt.dense(), rvt.dense()
            nl, nr = lvt.num_rows, rvt.num_rows
        if nl == 0 or nr == 0:
            ref = _first_tensor(lvt, rvt)
            if kind in ("inner", "cross", "semi"):
                cols = {cid: _empty_like(c) for cid, c in lvt.cols.items()}
                if kind in ("inner", "cross"):
                    for c in op.right.output_cols():
                        cols[c.cid] = _empty_like(rvt.col(c.cid)) if nr else _empty_scol(c.type, ref)
                return VTable(cols, 0)
            if kind == "anti":
                return lvt
            if kind == "mark":
                cols = dict(lvt.cols)
                cols[op.mark_col.cid] = SCol(
                    op.mark_col.type, be.full(nl, False, jnp.bool_, ref), None)
                return VTable(cols, nl)
            if kind in ("left", "single"):
                if nl == 0:
                    cols = {cid: _empty_like(c) for cid, c in lvt.cols.items()}
                    for c in op.right.output_cols():
                        cols[c.cid] = _empty_scol(c.type, ref)
                    return VTable(cols, 0)
                cols = dict(lvt.cols)
                for c in op.right.output_cols():
                    cols[c.cid] = _null_scol_typed(c.type, nl, ref)
                return VTable(cols, nl)
            if kind == "full":
                if nl == 0 and nr == 0:
                    cols = {c.cid: _empty_scol(c.type, ref) for c in op.output_cols()}
                    return VTable(cols, 0)
                if nr == 0:
                    cols = dict(lvt.cols)
                    for c in op.right.output_cols():
                        cols[c.cid] = _null_scol_typed(c.type, nl, ref)
                    return VTable(cols, nl)
                cols = {cid: _null_scol_typed(lvt.col(cid).type, nr, ref)
                        for cid in lvt.cols}
                for c in op.right.output_cols():
                    cols[c.cid] = rvt.col(c.cid)
                return VTable(cols, nr)

        lcids = {c.cid for c in op.left.output_cols()}
        rcids = {c.cid for c in op.right.output_cols()}
        lkeys, rkeys, null_safe = extract_equi_keys(op.predicate, lcids, rcids)

        if not lkeys:
            lvt, rvt = lvt.dense(), rvt.dense()
            nl, nr = lvt.num_rows, rvt.num_rows
            # no equi keys: nested loop via cross-product pairs; the pair
            # buffers are bounded by 2^26 (larger inputs need the blockwise
            # nested loop, which is not ported yet)
            if nl * nr > (1 << 26):
                return self._chunked_nonequi_join(op, kind, lvt, rvt)
            pidx, bidx, total = _all_pairs(nl, nr, _first_tensor(lvt, rvt))
        else:
            def _eval_keys():
                lk, rk = [], []
                for le, re_ in zip(lkeys, rkeys):
                    a = sc.eval_expr(le, lvt.cols)
                    b = sc.eval_expr(re_, rvt.cols)
                    a, b = _unify_string_keys(a, b)
                    lk.append(sc._bcast(a, nl))
                    rk.append(sc._bcast(b, nr))
                return lk, rk

            lk, rk = _eval_keys()
            if (kind in ("inner", "semi", "anti", "left", "mark", "single",
                         "full")
                    and op.null_aware is None):
                sharded = self._try_sharded_join(op, kind, lvt, rvt, lk, rk,
                                                 null_safe)
                if sharded is not None:
                    return sharded
            if lvt.row_valid is not None or rvt.row_valid is not None:
                # non-sharded strategies index dense layouts
                lvt, rvt = lvt.dense(), rvt.dense()
                nl, nr = lvt.num_rows, rvt.num_rows
                lk, rk = _eval_keys()
            fast = self._try_unique_key_join(op, kind, lvt, rvt, lk, rk,
                                             null_safe)
            if fast is None and kind == "inner":
                # inner joins are symmetric: when the right build side has
                # duplicate keys (the FK side) but the LEFT side is unique
                # (the PK side — Q3's customer x orders on custkey), probe
                # with the right side over a LEFT-side LUT instead of
                # falling to the hash-sort pairs path (reference analogue:
                # hash-join side selection, OptimizeImplementations.cpp
                # chooses build side by cardinality/uniqueness)
                fast = self._try_unique_key_join(op, kind, rvt, lvt, rk, lk,
                                                 null_safe, flipped=True)
            if fast is not None:
                return fast
            # probe with the left side, build on the right
            pidx, bidx, total = joinops.candidate_pairs(rk, lk, nr, nl, tuple(null_safe))

        return self._finish_pairs_join(op, kind, lvt, rvt, pidx, bidx, total)

    def _try_unique_key_join(self, op, kind, lvt, rvt, lk, rk,
                             null_safe, flipped: bool = False) -> Optional[VTable]:
        """Direct-LUT eager join for single-int-key joins whose build side
        (right) has unique, densely-spanned keys — the common FK shape.
        Probes are ONE gather (through the kernels of ops/pgather.py)
        instead of candidate_pairs' hash-sort + searchsorted rounds, and
        sorted probe columns (TPC-H lineitem.l_orderkey) hit the monotone
        gather kernel. Returns None when the shape doesn't apply
        (duplicates, sparse span, composite keys, residual predicate).
        Reference analogue: indexNestedLoop selection on key-FD joins,
        OptimizeImplementations.cpp:580-660."""
        if (len(lk) != 1 or any(null_safe)
                or getattr(op, "null_aware", None) is not None
                or kind not in ("inner", "semi", "anti", "left", "mark",
                                "single")
                or len(E.conjuncts(op.predicate)) != 1):
            return None
        pk, bk = lk[0], rk[0]
        if (is_obj(pk.data) or is_obj(bk.data)
                or not jnp.issubdtype(be.dt(pk.data), jnp.integer)
                or not jnp.issubdtype(be.dt(bk.data), jnp.integer)):
            return None
        nl, nr = lvt.num_rows, rvt.num_rows
        # persisted hash-index payload: when the build side is an unfiltered
        # base-table scan with a declared index on this key, the direct LUT
        # comes from the catalog (loaded from `<index>.idx` on reopen, never
        # rebuilt — reference: LingoDBHashIndex.cpp file-backed index)
        payload = self._persisted_dense_lut(op, flipped)
        if payload is not None and payload["rows"] == nr:
            from ..storage import hashindex as hx

            bmin = payload["kmin"]
            span = payload["span"]
            n_valid = payload["n_valid"]
            if n_valid == 0:
                return None
            lut = (hx.device_lut(payload, pk.data.device)
                   if be.is_torch(pk.data) else payload["lut"])
            return self._finish_unique_key_join(
                op, kind, lvt, rvt, pk, lut, bmin, span, nl, flipped)
        if nr > (1 << 25):
            return None  # LUT build cost outgrows the probe win
        bkd = be.astype(bk.data, jnp.int64)
        if bk.valid is not None:
            big = 1 << 62
            bmin = int(jnp.min(jnp.where(bk.valid, bkd, big)))
            bmax = int(jnp.max(jnp.where(bk.valid, bkd, -big)))
            n_valid = int(jnp.sum(bk.valid))
        else:
            bmin, bmax = int(jnp.min(bkd)), int(jnp.max(bkd))
            n_valid = nr
        if n_valid == 0:
            return None
        span = bmax - bmin + 1
        if span > (1 << 26) or (span > 8 * nr and n_valid < (span >> 7)):
            return None
        tgt = bkd - bmin
        if bk.valid is not None:
            tgt = jnp.where(bk.valid, tgt, span)
        # slot `span` collects NULL keys and is cut off; with duplicate keys
        # some write wins, and the filled-slot count below exposes them
        lut = be.set_at(be.full(span + 1, -1, jnp.int32, tgt), tgt,
                        be.iota(nr, jnp.int32, tgt))[:span]
        if int(jnp.sum(lut >= 0)) != n_valid:
            return None  # duplicate build keys: not a unique-key join
        return self._finish_unique_key_join(
            op, kind, lvt, rvt, pk, lut, bmin, span, nl, flipped)

    def _persisted_dense_lut(self, op, flipped: bool = False) -> Optional[dict]:
        """The dense LUT payload of a declared hash index covering this
        join's single equi key, when the build side is a base-table scan.
        Scan restrictions are allowed: filtering preserves order, so the
        caller's `payload rows == build rows` check proves no row was dropped
        and payload row ids equal build-side positions (inferred
        `IS NOT NULL` restrictions on indexed keys are the common case)."""
        r = op.left if flipped else op.right
        if not isinstance(r, L.Scan):
            return None
        cat = self.session.catalog
        entry = cat.get_table(r.table)
        if entry is None or not entry.indexes:
            return None
        cj = E.conjuncts(op.predicate)
        if len(cj) != 1:
            return None
        c = cj[0]
        if not (isinstance(c, Call) and c.op == "eq"):
            return None
        cid_to_name = {cc.cid: cc.name for cc in r.cols}
        name = next((cid_to_name[a.cid] for a in c.args
                     if isinstance(a, ColRef) and a.cid in cid_to_name), None)
        if name is None:
            return None
        iname = entry.index_on([name])
        if iname is None:
            return None
        p = entry.index_payload(iname, cat.db_dir, cat.persist)
        return p if p.get("kind") == "dense" else None

    def _finish_unique_key_join(self, op, kind, lvt, rvt, pk, lut, bmin,
                                span, nl, flipped: bool = False) -> VTable:
        """Probe a unique-key direct LUT (built in-session or loaded from a
        persisted index payload) and assemble the join result. With
        flipped=True (inner only) lvt is the original RIGHT side probing a
        LEFT-side LUT; output columns are identical either way (VTables are
        cid-keyed)."""
        build_cols = (op.left if flipped else op.right).output_cols()
        nr = rvt.num_rows
        pkd = be.astype(pk.data, jnp.int64)
        lut = be.like(lut, pkd)
        p_sorted = bool(jnp.all(pkd[1:] >= pkd[:-1]))
        off = pkd - bmin
        offc = be.astype(jnp.clip(off, 0, span - 1), jnp.int32)
        pos = pgather.take_fast(lut, offc, monotone=p_sorted)
        found = (off >= 0) & (off < span) & (pos >= 0)
        if pk.valid is not None:
            found = found & pk.valid
        # misses gather build row 0 and are masked by `found`. (The reference
        # forward-fills them with a running maximum over the positions so
        # that its windowed gather sees monotone indices; that also raises
        # every HIT below the running maximum whenever the build rows are
        # not stored in key order, and returns the wrong build row. The CUDA
        # gather serves any order, so no fill is made here.)
        pos = jnp.where(found, pos, 0)
        if kind == "semi":
            return lvt.select_mask(found)
        if kind == "anti":
            return lvt.select_mask(~found)
        if kind == "mark":
            cols = dict(lvt.cols)
            cols[op.mark_col.cid] = SCol(op.mark_col.type, found, None)
            return VTable(cols, nl)
        if kind in ("left", "single"):
            cols = dict(lvt.cols)
            for c in build_cols:
                cols[c.cid] = rvt.col(c.cid).take_with_invalid(
                    pos, ~found, monotone=p_sorted)
            return VTable(cols, nl)
        # inner: compact matching probe rows once, gather both sides
        keep = int(jnp.sum(found))
        if keep == 0:
            cols = {cid: _empty_like(c) for cid, c in lvt.cols.items()}
            for c in build_cols:
                cols[c.cid] = _empty_like(rvt.col(c.cid))
            return VTable(cols, 0)
        _, li = pgather.nonzero_positions(found, keep)
        ri = pgather.take_fast(pos, li, monotone=True)
        out = lvt.take(li, keep, monotone=True)
        rcols = VTable({c.cid: rvt.col(c.cid)
                        for c in build_cols
                        if c.cid in rvt.cols}, nr).take(ri, keep,
                                                        monotone=p_sorted)
        return out.merge(rcols)

    def _finish_pairs_join(self, op, kind, lvt, rvt, pidx, bidx, total) -> VTable:
        """Evaluate the full predicate on candidate pairs and assemble the
        join result for every join kind."""
        nl, nr = lvt.num_rows, rvt.num_rows
        ref = _first_tensor(lvt, rvt)
        if total > 0 and op.predicate is not None:
            env = _pair_env(lvt, rvt, pidx, bidx, op.predicate)
            mask = sc.truth_mask(sc.eval_expr(op.predicate, env))
            mask = jnp.broadcast_to(mask, (total,))
        else:
            mask = be.full(total, True, jnp.bool_, ref)

        null_aware = getattr(op, "null_aware", None)

        def no_match(n):
            return be.full(n, False, jnp.bool_, ref)

        def kept_pairs():
            keep = int(jnp.sum(mask)) if total else 0
            if not keep:
                z = be.full(0, 0, jnp.int64, ref)
                return z, z, 0
            (sel,) = jnp.nonzero(mask, size=keep)
            return jnp.take(pidx, sel), jnp.take(bidx, sel), keep

        if kind in ("inner", "cross"):
            li, ri, keep = kept_pairs()
            return _combine(lvt, rvt, li, ri, keep)
        if kind in ("semi", "anti", "mark"):
            matched = joinops.matched_flags(pidx, mask, nl) if total else no_match(nl)
            if kind == "semi":
                return lvt.select_mask(matched)
            if kind == "anti":
                keep_mask = ~matched
                if null_aware is not None:
                    keep_mask = self._null_aware_fix(null_aware, lvt, rvt, keep_mask)
                return lvt.select_mask(keep_mask)
            cols = dict(lvt.cols)
            cols[op.mark_col.cid] = SCol(op.mark_col.type, matched, None)
            return VTable(cols, nl)
        if kind == "single":
            first, found = joinops.first_match(pidx, mask, nl) if total else (
                be.full(nl, 0, jnp.int64, ref), no_match(nl))
            ri = jnp.where(found, jnp.take(bidx, first), 0) if total else first
            cols = dict(lvt.cols)
            for c in op.right.output_cols():
                cols[c.cid] = rvt.col(c.cid).take_with_invalid(ri, ~found)
            return VTable(cols, nl)
        if kind == "left":
            matched = joinops.matched_flags(pidx, mask, nl) if total else no_match(nl)
            li, ri, keep = kept_pairs()
            inner = _combine(lvt, rvt, li, ri, keep)
            n_unmatched = int(jnp.sum(~matched))
            if n_unmatched == 0:
                return inner
            (ui,) = jnp.nonzero(~matched, size=n_unmatched)
            outer_cols = {}
            for cid, c in lvt.cols.items():
                outer_cols[cid] = c.take(ui)
            for c in op.right.output_cols():
                outer_cols[c.cid] = _null_scol(rvt.col(c.cid), n_unmatched)
            return _vconcat(inner, VTable(outer_cols, n_unmatched), op.output_cols())
        if kind == "full":
            matched_l = joinops.matched_flags(pidx, mask, nl) if total else no_match(nl)
            matched_r = joinops.matched_flags(bidx, mask, nr) if total else no_match(nr)
            li, ri, keep = kept_pairs()
            parts = [_combine(lvt, rvt, li, ri, keep)]
            n_ul = int(jnp.sum(~matched_l))
            if n_ul:
                (ui,) = jnp.nonzero(~matched_l, size=n_ul)
                cols = {cid: c.take(ui) for cid, c in lvt.cols.items()}
                for c in op.right.output_cols():
                    cols[c.cid] = _null_scol(rvt.col(c.cid), n_ul)
                parts.append(VTable(cols, n_ul))
            n_ur = int(jnp.sum(~matched_r))
            if n_ur:
                (ui,) = jnp.nonzero(~matched_r, size=n_ur)
                cols = {cid: _null_scol(lvt.col(cid), n_ur) for cid in lvt.cols}
                for c in op.right.output_cols():
                    cols[c.cid] = rvt.col(c.cid).take(ui)
                parts.append(VTable(cols, n_ur))
            out = parts[0]
            for p in parts[1:]:
                out = _vconcat(out, p, op.output_cols())
            return out
        raise ExecError(f"unsupported join kind {kind}")

    def _null_aware_fix(self, null_aware, lvt, rvt, keep_mask):
        """NOT IN semantics: with a non-empty inner set, outer NULL -> drop row
        and any inner NULL -> drop all rows; NOT IN (empty set) is TRUE for
        every outer row, NULL included (reference handles this through nullable
        comparison semantics in the generated join predicate)."""
        if not rvt.num_rows:
            return keep_mask
        outer_e, inner_ref = null_aware
        outer_c = sc.eval_expr(outer_e, lvt.cols)
        if outer_c.valid is not None:
            keep_mask = keep_mask & outer_c.valid
        inner_c = rvt.cols.get(inner_ref.cid)
        if inner_c is not None and inner_c.valid is not None:
            if bool(jnp.any(~inner_c.valid)):
                keep_mask = keep_mask & False
        return keep_mask

    def _cross(self, lvt: VTable, rvt: VTable) -> VTable:
        nl, nr = lvt.num_rows, rvt.num_rows
        if nl == 0 or nr == 0:
            cols = {cid: _empty_like(c) for cid, c in {**lvt.cols, **rvt.cols}.items()}
            return VTable(cols, 0)
        li, ri, total = _all_pairs(nl, nr, _first_tensor(lvt, rvt))
        return _combine(lvt, rvt, li, ri, total)

    # ------------------------------------------------------------- set ops
    def _run_setop(self, op: L.SetOp) -> VTable:
        from . import device as dv

        lvt = self.run(op.left).dense()
        rvt = self.run(op.right).dense()
        lvt, rvt = dv.align_devices(lvt, rvt)
        lcols = {c.cid: lvt.col(lc) for c, lc in zip(op.cols, op.lmap)}
        rcols = {c.cid: rvt.col(rc) for c, rc in zip(op.cols, op.rmap)}
        lt = VTable(lcols, lvt.num_rows)
        rt = VTable(rcols, rvt.num_rows)
        if op.kind == "union" and op.all:
            return _vconcat(lt, rt, op.cols)
        both = _vconcat(lt, rt, op.cols)
        n = both.num_rows
        if n == 0:
            return both
        ref = _first_tensor(both)
        tag = jnp.concatenate([
            be.full(lt.num_rows, 0, jnp.int64, ref),
            be.full(rt.num_rows, 1, jnp.int64, ref),
        ])
        grp = gb.group_rows([both.col(c.cid) for c in op.cols], n)
        seg, g, order = grp["seg"], grp["num_groups"], grp["order"]
        t = tag if order is None else jnp.take(tag, order)
        r_count = be.segment_sum(t, seg, num_segments=g, indices_are_sorted=grp["sorted"])
        tot = be.segment_sum(jnp.ones_like(t), seg, num_segments=g, indices_are_sorted=grp["sorted"])
        l_count = tot - r_count
        if op.kind == "union":
            reps = jnp.ones_like(tot)
        elif op.kind == "intersect":
            reps = jnp.minimum(l_count, r_count) if op.all else be.astype((l_count > 0) & (r_count > 0), jnp.int64)
        else:  # except
            reps = jnp.maximum(l_count - r_count, 0) if op.all else be.astype((l_count > 0) & (r_count == 0), jnp.int64)
        idx = np.repeat(be.to_host(grp["rep_rows"]), be.to_host(reps))
        return both.take(be.like(idx, ref), len(idx))


# ---------------------------------------------------------------- helpers
def _first_tensor(*vts: VTable):
    """A tensor of the given tables (None for host-numpy tables): new
    columns are made beside it, on its device."""
    for vt in vts:
        for c in vt.cols.values():
            if be.is_torch(c.data):
                return c.data
    return None


def extract_equi_keys(pred, lcids: set[int], rcids: set[int]):
    """Find hashable equi-key expression pairs in a join predicate.
    Handles top-level conjuncts (eq and null-safe nseq) and, for OR
    predicates like TPC-H Q19, equality conjuncts common to every disjunct
    (reference: HashJoinUtils.cpp:21-278 equi-key extraction)."""
    lkeys, rkeys, null_safe = [], [], []
    if pred is None:
        return lkeys, rkeys, null_safe

    def try_add(c):
        if isinstance(c, Call) and c.op in ("eq", "nseq"):
            a, b = c.args
            ua, ub = E.used_cols(a), E.used_cols(b)
            if ua and ub:
                if ua <= lcids and ub <= rcids:
                    lkeys.append(a)
                    rkeys.append(b)
                    null_safe.append(c.op == "nseq")
                    return True
                if ua <= rcids and ub <= lcids:
                    lkeys.append(b)
                    rkeys.append(a)
                    null_safe.append(c.op == "nseq")
                    return True
        return False

    for c in E.conjuncts(pred):
        if try_add(c):
            continue
        if isinstance(c, Call) and c.op == "or":
            # common equality across all branches (Q19 pattern)
            branch_sets = []
            for b in E.disjuncts(c):
                branch_sets.append({repr(x): x for x in E.conjuncts(b)})
            common = set(branch_sets[0])
            for bs in branch_sets[1:]:
                common &= set(bs)
            for key in common:
                try_add(branch_sets[0][key])
    return lkeys, rkeys, null_safe


def _unify_string_keys(a: SCol, b: SCol):
    if a.type.is_string and b.type.is_string and a.dictionary is not None and b.dictionary is not None:
        if a.dictionary is b.dictionary:
            return a, b
        merged, ra, rb = strmod.remap_to_merged(a.dictionary, b.dictionary)
        a = SCol(a.type, be.lut_take(ra, a.data), a.valid, merged)
        b = SCol(b.type, be.lut_take(rb, b.data), b.valid, merged)
    return a, b


def _pair_env(lvt: VTable, rvt: VTable, li, ri, pred):
    env = {}
    used = E.used_cols(pred)
    for cid in used:
        if cid in lvt.cols:
            env[cid] = lvt.col(cid).take(li)
        elif cid in rvt.cols:
            env[cid] = rvt.col(cid).take(ri)
        else:
            raise ExecError(f"join predicate references unknown column {cid}")
    return env


def _combine(lvt: VTable, rvt: VTable, li, ri, n: int) -> VTable:
    cols = {}
    for cid, c in lvt.cols.items():
        cols[cid] = c.take(li)
    for cid, c in rvt.cols.items():
        cols[cid] = c.take(ri)
    return VTable(cols, n)


def _all_pairs(nl: int, nr: int, ref=None):
    if nl == 0 or nr == 0:
        z = be.full(0, 0, jnp.int64, ref)
        return z, z, 0
    li = jnp.repeat(be.iota(nl, jnp.int64, ref), nr)
    ri = jnp.tile(be.iota(nr, jnp.int64, ref), nl)
    return li, ri, nl * nr


def _null_scol(template: SCol, n: int) -> SCol:
    ref = template.data if be.is_torch(template.data) else None
    dtype = np_dtype(template.type) if is_obj(template.data) else be.dt(template.data)
    return SCol(template.type.as_nullable(), be.full(n, 0, dtype, ref),
                be.full(n, False, jnp.bool_, ref), template.dictionary)


def _null_scol_typed(t: Type, n: int, ref=None) -> SCol:
    return SCol(
        t.as_nullable(), be.full(n, 0, np_dtype(t), ref),
        be.full(n, False, jnp.bool_, ref),
        np.array([""], dtype=object) if t.is_string else None,
    )


def _empty_like(c: SCol) -> SCol:
    ref = c.data if be.is_torch(c.data) else None
    dtype = np_dtype(c.type) if is_obj(c.data) else be.dt(c.data)
    return SCol(c.type, be.full(0, 0, dtype, ref),
                None if c.valid is None else be.full(0, False, jnp.bool_, ref),
                c.dictionary)


def _empty_scol(t: Type, ref=None) -> SCol:
    return SCol(t, be.full(0, 0, np_dtype(t), ref), None,
                np.zeros(0, dtype=object) if t.is_string else None)


def _vconcat(a: VTable, b: VTable, out_cols) -> VTable:
    cols = {}
    for info in out_cols:
        ca, cb = a.col(info.cid), b.col(info.cid)
        if ca.dictionary is not None or cb.dictionary is not None:
            ca2, cb2 = _unify_string_keys(ca, cb)
            data = jnp.concatenate([ca2.data, cb2.data])
            dictionary = ca2.dictionary
        elif is_obj(ca.data) or is_obj(cb.data):
            from ..ops import decwide

            data = np.concatenate([decwide.to_obj(ca.data),
                                   decwide.to_obj(cb.data)])
            dictionary = None
        else:
            dt = jnp.promote_types(be.dt(ca.data), be.dt(cb.data))
            data = jnp.concatenate([be.astype(ca.data, dt), be.astype(cb.data, dt)])
            dictionary = None
        if ca.valid is None and cb.valid is None:
            valid = None
        else:
            valid = jnp.concatenate([ca.valid_mask(), cb.valid_mask()])
            if is_obj(data):
                valid = be.to_host(valid)
        cols[info.cid] = SCol(info.type, data, valid, dictionary)
    return VTable(cols, a.num_rows + b.num_rows)


def _scol_from_values(vals: list, t: Type) -> SCol:
    n = len(vals)
    valid_np = np.array([v is not None for v in vals], dtype=np.bool_)
    all_valid = bool(valid_np.all())
    if t.is_string:
        strs = ["" if v is None else str(v) for v in vals]
        dictionary, codes = strmod.encode_strings(strs)
        return SCol(t, np.asarray(codes), None if all_valid else valid_np, dictionary)
    dtype = np.dtype(np_dtype(t))
    arr = np.zeros(n, dtype=dtype)
    try:
        for i, v in enumerate(vals):
            if v is not None:
                arr[i] = v
    except OverflowError:
        # wide-decimal values beyond int64: exact host object column
        arr = np.array([0 if v is None else int(v) for v in vals],
                       dtype=np.object_)
        return SCol(t, arr, None if all_valid else valid_np)
    return SCol(t, arr, None if all_valid else valid_np)
