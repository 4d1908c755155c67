"""Plan executor: walks the logical plan and runs vectorized operators.

Equivalent of the reference's generated query code + runtime
(reference: SubOpToControlFlow.cpp emits imperative code per pipeline that the
LLVM JIT runs tuple-at-a-time; here each operator is a set of whole-column
tensor ops). Dynamic result sizes surface as exactly one host sync per
size-changing operator (filter compaction, join expansion, group count).

An Aggregate over a Scan -> Select/Map -> dimension-Join spine first goes to
the fused aggregate program (`_try_fused_agg`, building blocks in
runtime/fused.py): the whole spine and the grouping run as one function on
the session's tensors, sized by static capacities, with one packed fetch at
the end. The same spine with no aggregate on top (a Select or Join at the
top of a chain of dimension joins) goes to the fused chain
(`_try_fused_chain`), which emits the surviving rows compacted into a
learned capacity. A TopK over either folds into that program as an epilogue
(`_try_fused_topk`): the program emits the top candidates and the host
re-sorts only those. On the card each fused program is captured once per
plan and learned capacities as a CUDA graph and replayed after that
(`_run_program`, runtime/exestore.py); its capacities are learned by an
uncaptured calibration run and kept in session.stage_cache and, with
system.capstore_dir set, across processes (utils/capstore.py). Where a
program declines, the EAGER operators below run: one operator at a time,
each materializing its result. An aggregate over a scan larger than
system.device_byte_budget streams the table through the card in chunks
(`_try_chunked_agg`, runtime/chunked.py). The sharded mesh operators
(`_try_sharded_join`, `_try_sharded_agg`, `_try_distributed_sort`, over
parallel/shuffle.py) take the large joins, groupings and sorts when
runtime/device.get_mesh() gives a mesh. There base tables are held sharded
from their upload (session.py), scans, Select and Map keep them on the
mesh under a selection vector (VTable.row_valid), the fused aggregate of
dense keys runs position by position and reduces its lanes across the
mesh, the fused chain and the large-domain fused aggregate decline, and
every other operator takes its input whole from one gather (run,
_gather_input).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import backend as be
from ..ops import bounds
from ..ops.backend import xnp as jnp

from ..ops import decwide
from ..ops import groupby as gb
from ..ops import join as joinops
from ..ops import keys as keymod
from ..ops import pgather
from ..ops import scalar as sc
from ..ops import strings as strmod
from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import Call, Cast, ColRef
from ..sql.types import K, Type
from ..utils import tracer
from .result import ResultTable
from .vtable import SCol, VTable, dec_is_wide, is_obj, np_dtype


class ExecError(Exception):
    pass


def _base_keys_dense(group_by, base_cols):
    """Whether group keys that are all base columns give a dense id by their
    own domains (groupby.dense_gid's test, made on the host from their
    templates); None when a key comes from a join or a Map."""
    base = dict(base_cols)
    if not all(cid in base for cid in group_by):
        return None
    templates = [(base[c].type, base[c].dictionary, base[c].valid is not None)
                 for c in group_by]
    return gb.bounded_layout(templates, [None] * len(group_by)) is not None


def _vtable_bytes(vt: VTable) -> int:
    """Bytes of a table's columns: rows x itemsize each (+1 a row for a
    validity mask; wide-decimal object columns count 16 bytes a row)."""
    from ..parallel.mesh import Sharded

    total = 0
    for c in vt.cols.values():
        data = c.data.shards[0] if isinstance(c.data, Sharded) else c.data
        itemsize = 16 if is_obj(data) else be.dt(data).itemsize
        total += vt.num_rows * itemsize
        if c.valid is not None:
            total += vt.num_rows
    return total


# The fused aggregate's lead compaction capacity: the estimated survivor
# count times 2, plus COMPACT_SLACK rows, rounded up to a multiple of
# COMPACT_QUANTUM rows (the reference quantizes for its jit cache; the port
# keeps the sizes so that both engines compact at the same points).
COMPACT_SLACK = 8192
COMPACT_QUANTUM = 65536


class Executor:
    """Executes logical plans against a session's storage."""

    track_tuples: dict | None = None

    def __init__(self, session):
        self.session = session
        # shared-subtree results, valid for one plan execution
        # (reference: the materialized relalg.tmp buffer, RelAlgOps.td:499)
        self._tmp_results: dict[int, VTable] = {}
        self._mode = "DEFAULT"
        # spine bases that _try_fused_agg materialized before it declined:
        # the eager operators consume them instead of running the subtree
        # again (id(node) -> VTable)
        self._materialized_bases: dict[int, VTable] = {}
        # set while _try_fused_chain builds its dimension sides eagerly: a
        # chain among them runs the eager operators
        self._in_fused_chain = False
        # the working table of each executing Iterate (holder seq -> VTable)
        self._iter_tables: dict[int, VTable] = {}
        # the out-of-core aggregate's last engage decision (chunked_plan's
        # dict plus what the stream moved), None until one engaged
        self.last_chunked: Optional[dict] = None
        # rounds of the last Iterate, left chunks of the last chunked
        # non-equi join
        self.last_iterate_rounds: Optional[int] = None
        self.last_nonequi_chunks: Optional[int] = None
        # the times the last statement ran again for the exact path
        self.last_exact_reruns = 0
        # PERF mode: (operator, self ms, rows, inclusive ms, bytes, sol) per
        # operator of the last statement, None in the other modes
        self.last_op_profile: list | None = None
        self._prof_children: list = [0.0]
        self._prof_child_bytes: list = [0]
        self._prof_seen_ids: set = set()

    # ------------------------------------------------------------- dispatch
    def execute(self, plan: L.Materialize) -> ResultTable:
        """Run `plan`. A checked operator whose result passed int64 on a live
        row (ops/scalar.py, NeedsExact) makes the statement run again with
        that expression on the exact host path; the plan keeps the decision
        in session.stage_cache, so a later run goes there at once."""
        from ..opt.optimizer import fold_constants
        from ..plan.serial import plan_key

        # each constant expression computed once, on the host, before any
        # operator runs (its data error raised here)
        with sc.error_scope():
            fold_constants(plan)
        key = ("exact_arith", plan_key(plan))
        cache = self.session.stage_cache
        self.last_exact_reruns = 0
        while True:
            exact = cache.get(key, frozenset())
            try:
                # the sources of the data errors' messages, the expressions
                # that go exact, the bounds that prove the rest
                with sc.error_scope(), sc.exact_exprs(exact), \
                        bounds.scope(self._plan_bounds(plan)):
                    return self._execute(plan)
            except sc.NeedsExact as ne:
                more = exact | {ne.key}
                if more == exact:  # nothing learned: every operator exact
                    if None in exact:
                        raise ExecError("the exact path marked a row") from ne
                    more = exact | {None}
                cache[key] = more
                self.last_exact_reruns += 1

    def _plan_bounds(self, plan) -> "bounds.PlanBounds":
        session = self.session

        def rows_of(table):
            e = session.catalog.get_table(table)
            return None if e is None else e.storage.num_rows

        return bounds.PlanBounds(plan, session.column_bounds, rows_of,
                                 session.catalog)

    def _execute(self, plan: L.Materialize) -> ResultTable:
        from . import device as dv
        from ..utils.settings import EXECUTION_MODE

        self._tmp_results.clear()
        self._materialized_bases.clear()
        # execution modes (reference: ExecutionMode + CPULLVMDebugBackend /
        # perf backend, src/execution/LLVMBackends.cpp:939-1010):
        #   DEFAULT  fast path
        #   DEBUG    verify every operator's output invariants
        #   PERF     per-operator wall time, rows, bytes and speed of light
        #            in last_op_profile, printed to stderr with the
        #            statement's captures, replays, builds and calibrations
        self._mode = str(EXECUTION_MODE.get()).upper()
        self.last_op_profile = [] if self._mode == "PERF" else None
        self._prof_children = [0.0]
        self._prof_child_bytes = [0]
        self._prof_seen_ids = set()
        if self.last_op_profile is not None:
            from ..utils import compilestats

            cs0 = compilestats.snapshot()
        with tracer.Trace("execution", "run_plan"):
            vt = self.run(plan.child).dense()
        if self.last_op_profile is not None:
            import sys

            for name, ms, rows, incl, nbytes, sol in self.last_op_profile:
                print(f"# perf {name}: self={ms:.3f}ms incl={incl:.3f}ms "
                      f"rows={rows} bytes={nbytes} sol={sol}", file=sys.stderr)
            cs = compilestats.delta(cs0)
            print(f"# perf captures={cs['captures']} "
                  f"capture_secs={cs['capture_secs']:.3f} "
                  f"replays={cs['replays']} builds={cs['builds']} "
                  f"build_secs={cs['build_secs']:.1f} "
                  f"calibrations={cs['calibrations']}", file=sys.stderr)
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

    # the operators whose result may hold Sharded columns (a table held on
    # the mesh, parallel/mesh.py): the scan and the row-wise Select and Map
    # over it. Every other operator takes its input from run(), which
    # gathers such a table first (_gather_input); the sharded join,
    # aggregate and sort and the fused aggregate take it from run_sharded()
    _SHARDED_OUT = ("Scan", "Select", "Map")

    def run(self, op: L.LogicalOp) -> VTable:
        """`op`'s result as whole columns (a table held on the mesh leaves
        it here, counted as a gather)."""
        return self._gather_input(self.run_sharded(op))

    def run_sharded(self, op: L.LogicalOp) -> VTable:
        """`op`'s result, Sharded where a scan of a table held on the mesh
        (or a Select / Map over one) gives it: for the operators that have
        a sharded form."""
        from . import device as dv

        stashed = self._materialized_bases.pop(id(op), None)
        if stashed is not None:
            return stashed
        method = getattr(self, "_run_" + type(op).__name__.lower(), None)
        if method is None:
            raise ExecError(f"no executor for {type(op).__name__}")
        if self.last_op_profile is not None:
            vt = self._profiled(op, method)
        else:
            vt = method(op)
        if dv.is_sharded(vt) and type(op).__name__ not in self._SHARDED_OUT:
            # only the scan, Select and Map keep a table on the mesh; any
            # other operator computing on its per-position lists would be
            # wrong, so a missed gather stops here
            raise ExecError(f"{type(op).__name__} returned Sharded columns")
        if self._mode == "DEBUG":
            self._debug_verify(op, vt)
        if self.track_tuples is not None:
            # per-operator output cardinalities (reference: relalg.track_tuples
            # / subop.set_tracked_count, RelAlgOps.td:530, ExecutionContext.h:63)
            self.track_tuples[id(op)] = (
                vt.num_rows if vt.row_valid is None
                else _live_rows(vt.row_valid))
        # small results migrate to the host numpy tier (runtime/device.py)
        if type(op).__name__ in ("Aggregate", "Select", "Join", "TopK", "Limit",
                                 "Distinct", "SetOp"):
            vt = dv.demote_small(vt)
        return vt

    def _gather_input(self, vt: VTable) -> VTable:
        """A table held on the mesh as whole columns on the session's device,
        for an operator without a sharded form: ONE gather for the operator
        (shuffle.STATS["gathers"]). Under a selection vector each position
        first compacts its own rows (K3, then the gathers of its
        survivors) and only the survivors move. Every process gets the
        whole table."""
        from . import device as dv
        from ..parallel import mesh as msh
        from ..parallel import shuffle as sh

        if not dv.is_sharded(vt):
            return vt
        sh.STATS["gathers"] += 1
        mesh = _mesh_of(vt)
        dev = self.session.device
        views = _views(vt)
        if vt.row_valid is not None:
            # every position's live count in one read, then each compacts
            # its rows without reading its count again
            counts = msh.to_host(mesh, [
                v.row_valid.sum(dtype=torch.int64).reshape(1)
                for v in views]).reshape(-1)
            views = [VTable(v.cols, v.num_rows).select_mask(
                v.row_valid, count=int(counts[s]))
                for s, v in zip(mesh.local_positions, views)]
        else:
            counts = np.full(mesh.size, views[0].num_rows, np.int64)
        total = int(counts.sum())
        host_live = None
        cols = {}
        for cid, c in vt.cols.items():
            if is_obj(c.data):
                # host columns: the whole (padded) array is on every process
                # (the views hold only this process's positions' rows)
                if vt.row_valid is None:
                    data, valid = c.data, c.valid
                elif mesh.spans_processes():
                    if host_live is None:
                        host_live = be.to_host(msh.gather(vt.row_valid, dev))
                    data = c.data[host_live]
                    valid = None if c.valid is None else \
                        np.asarray(c.valid)[host_live]
                else:
                    data = np.concatenate([v.col(cid).data for v in views])
                    valid = None if c.valid is None else np.concatenate(
                        [np.asarray(v.col(cid).valid) for v in views])
                cols[cid] = SCol(c.type, data, valid, c.dictionary)
                continue
            data = msh.gather_ragged(mesh, [v.col(cid).data for v in views],
                                     counts, dev)
            valid = None
            if c.valid is not None:
                valid = msh.gather_ragged(
                    mesh, [v.col(cid).valid for v in views], counts, dev)
            cols[cid] = SCol(c.type, data, valid, c.dictionary)
        return VTable(cols, total)

    def _on_mesh(self, mesh, vt: VTable) -> VTable:
        """A whole table as a table held on the mesh (the rows of position s
        are rows [s * L, (s + 1) * L)): a sharded operator's input in one
        layout whether it came from a table held on the mesh or not. Pad
        rows are dead under the selection vector; wide-decimal columns stay
        host arrays, padded."""
        from . import device as dv
        from ..parallel.mesh import shard_rows

        if dv.is_sharded(vt):
            return vt
        n = vt.num_rows
        total = n + (-n) % mesh.size
        dev = self.session.device
        cols = {}
        for cid, c in vt.cols.items():
            if is_obj(c.data):
                data = np.concatenate([c.data, np.zeros(total - n, object)])
                valid = None if c.valid is None else np.concatenate(
                    [be.to_host(c.valid), np.zeros(total - n, np.bool_)])
            else:
                data = shard_rows(mesh, _on(c.data, dev, n))
                valid = (None if c.valid is None
                         else shard_rows(mesh, _on(c.valid, dev, n)))
            cols[cid] = SCol(c.type, data, valid, c.dictionary)
        rv = vt.row_valid
        if rv is None and total != n:
            rv = torch.ones((n,), dtype=torch.bool, device=dev)
        if rv is not None:
            rv = shard_rows(mesh, _on(rv, dev, n))  # padding: False
        return VTable(cols, total, row_valid=rv)

    def _profiled(self, op, method) -> VTable:
        """PERF mode: run one operator, timing it to the card's completion
        (a sync before and after, so that its device work lands on it and
        not on the operator that syncs next), and record (name, self ms,
        rows, inclusive ms, bytes, sol). Bytes: its children's outputs read,
        its own output written, and the base-table bytes of the scans its
        fused program read without running them as operators; sol is the
        self time over those bytes at system.hbm_gbps ("unknown" while the
        setting is unset: no bandwidth is assumed)."""
        from ..utils.settings import HBM_GBPS

        t0 = self._perf_sync()
        self._prof_children.append(0.0)
        self._prof_child_bytes.append(0)
        vt = method(op)
        dt = self._perf_sync() - t0
        child = self._prof_children.pop()
        in_bytes = self._prof_child_bytes.pop()
        out_bytes = _vtable_bytes(vt)
        self._prof_children[-1] += dt
        self._prof_child_bytes[-1] += out_bytes
        nbytes = in_bytes + out_bytes + self._unprofiled_scan_bytes(op)
        self._prof_seen_ids.add(id(op))
        self_ms = (dt - child) * 1e3
        gbps = HBM_GBPS.get()
        sol = "unknown"
        if gbps and nbytes:
            sol = round(self_ms / (nbytes / (gbps * 1e9) * 1e3), 1)
        self.last_op_profile.append(
            (type(op).__name__, self_ms, vt.num_rows, dt * 1e3, nbytes, sol))
        return vt

    def _unprofiled_scan_bytes(self, op) -> int:
        """Base-table bytes of the Scans under `op` that never ran as an
        operator (a fused program or a cached join prep read them). Each
        is charged once, to the first operator that covers it."""
        total = 0
        for node in L.walk_plan(op):
            if (isinstance(node, L.Scan)
                    and id(node) not in self._prof_seen_ids):
                self._prof_seen_ids.add(id(node))
                e = self.session.catalog.get_table(node.table)
                rows = e.storage.num_rows if e is not None else 0
                for c in node.cols:
                    total += rows * np.dtype(np_dtype(c.type)).itemsize
        return total

    def _perf_note(self, msg: str) -> None:
        """PERF mode: a detail line (the path a fused program took, a
        capture, a rebuild) on stderr."""
        if self.last_op_profile is not None:
            import sys

            print(f"# perf {msg}", file=sys.stderr)

    def _perf_sync(self) -> float:
        """A timestamp; in PERF mode taken after the card has finished what
        was queued, so that a span times the device work inside it."""
        import time

        if (self.last_op_profile is not None
                and self.session.device.type == "cuda"):
            torch.cuda.synchronize(self.session.device)
        return time.perf_counter()

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
            if c.err is not None:
                # the consumer of an expression raises its errors and drops
                # them (ops/scalar.py, "data errors")
                raise ExecError(f"DEBUG {type(op).__name__}: column {cid} "
                                f"carries unraised data errors")
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

    # ------------------------------------------------ out-of-core aggregate
    def chunked_plan(self, table: str, scan_cols) -> Optional[dict]:
        """The chunk layout when a scan of `scan_cols` of `table` exceeds
        the device byte budget and its columns can stream (no wide-decimal
        object column), else None: rows, bytes a row (the scanned columns'
        data and validity), chunk rows `m` (a power of two, at least 2^18,
        a third of the budget's rows) and the chunk count."""
        from ..utils.settings import get_setting

        entry = self.session.catalog.get_table(table)
        if entry is None or entry.storage.num_rows == 0:
            return None
        rows = entry.storage.num_rows
        width = 0
        for c in scan_cols:
            col = entry.storage.column(c.name)
            if np.asarray(col.data).dtype == np.object_:
                return None  # wide host decimals: no device image
            width += col.data.dtype.itemsize + (1 if col.valid is not None else 0)
        budget = int(get_setting("system.device_byte_budget"))
        if rows * width <= budget:
            return None
        m = max(1 << 18, (budget // 3) // max(width, 1))
        m = 1 << (m.bit_length() - 1)  # pow2 floor
        return {"table": table, "rows": rows, "width": width, "budget": budget,
                "chunk_rows": m, "chunks": -(-rows // m)}

    def _chunk_program(self, op, steps, scan, templates, m, domain, arrs,
                       nvalid) -> tuple[dict, dict]:
        """The out-of-core aggregate's program for one chunk: the scan's
        restrictions, the Select/Map steps and the dense lanes of the
        aggregate over `arrs` (one staging slot's buffers, `m` rows each),
        masked to the first `nvalid` rows (a (1,) int64 tensor, so that a
        captured graph reads it from its static input). Returns the lanes
        by position and the meta the finish reads (held with the graph and
        handed back at every replay): nothing is read to the host, unless
        an aggregate's argument is a wide decimal that only the host
        computes (a host object array): its lanes are exact host lanes,
        their positions in meta["host_lanes"], and such a program runs
        uncaptured."""
        meta = {"agg_dicts": {}, "agg_limbs": set(), "host_lanes": set()}
        env = {}
        i = 0
        for cid, t, d, hv in templates:
            data = arrs[i]
            i += 1
            valid = None
            if hv:
                valid = arrs[i]
                i += 1
            env[cid] = SCol(t, data, valid, d)
        ref = arrs[0]
        mask = be.iota(m, jnp.int64, ref) < nvalid
        # the chunk's data errors ride its lanes (lane "err")
        with sc.deferred_errors() as errs:
            for r in scan.restrictions:
                mask = mask & sc.truth_mask(sc.checked(
                    sc.eval_expr(r, env), mask, m))
            for st in steps:
                node = st[1]
                if isinstance(node, L.Select):
                    mask = mask & sc.truth_mask(sc.checked(
                        sc.eval_expr(node.predicate, env), mask, m))
                else:
                    for info, e in node.computed:
                        env[info.cid] = sc.eval_expr(e, env)
                    sc.checked_all(
                        env, [info.cid for info, _e in node.computed], mask, m)
        if op.group_by:
            key_cols = [sc._bcast(env[c], m) for c in op.group_by]
            gid, _dom2 = gb.dense_gid(key_cols)
        else:
            gid = be.full(m, 0, jnp.int32, ref)

        def msum(w):
            wm = jnp.where(mask, w, jnp.zeros_like(w))
            return be.segment_sum(wm, gid, num_segments=domain)

        ones = be.full(m, 1, jnp.int64, ref)
        outs = [msum(ones)]
        for spec in op.aggs:
            if spec.fn == "count_star":
                outs.append(outs[0])
                outs.append(outs[0])
                continue
            arg = sc._bcast(env[spec.arg], m)
            # a host column's validity is on the host: its count is not
            avalid = None if arg.valid is None else be.like(arg.valid, ref)
            vm = ones if avalid is None else be.astype(avalid, jnp.int64)
            cnt = msum(vm)
            if spec.fn == "count":
                outs.append(cnt)
                outs.append(cnt)
                continue
            wide = (spec.fn == "sum" and spec.out.type.kind == K.DECIMAL
                    and dec_is_wide(spec.out.type))
            if is_obj(arg.data):
                # a wide decimal only the host computes (a quotient, a
                # product past 18 digits): exact Python-int lanes, as the
                # eager grouping takes them (ops/groupby.py aggregate)
                keep = gb._host_arr(mask)
                if arg.valid is not None:
                    keep = keep & gb._host_arr(arg.valid)
                seg = gb._host_arr(gid)
                meta["host_lanes"].add(len(outs))
                if spec.fn == "sum":
                    outs.append(be.segment_sum(np.where(keep, arg.data, 0),
                                               seg, num_segments=domain))
                    if wide:  # the limb layout's second lane: a placeholder
                        outs.append(be.full(domain, 0, jnp.int64, ref))
                    outs.append(cnt)
                    continue
                red = np.full(domain, (1 if spec.fn == "min" else -1) * 10**45,
                              dtype=np.object_)
                (np.minimum if spec.fn == "min" else np.maximum).at(
                    red, seg[keep], arg.data[keep])
                outs.append(red)
                outs.append(cnt)
                continue
            if spec.fn == "sum":
                data = be.astype(arg.data, np_dtype(spec.out.type))
                if avalid is not None:
                    data = jnp.where(avalid, data, jnp.zeros_like(data))
                if wide and be.dt(data) == np.int64:
                    meta["agg_limbs"].add(spec.out.cid)
                    outs.append(msum(data >> 32))
                    outs.append(msum(data & 0xFFFFFFFF))
                    outs.append(cnt)
                    continue
                outs.append(msum(data))
                outs.append(cnt)
                continue
            sentinel = gb._extreme(be.dt(arg.data),
                                   maximum=(spec.fn == "min"))
            keep = mask if avalid is None else (mask & avalid)
            data = jnp.where(keep, arg.data, sentinel)
            red = (be.segment_min if spec.fn == "min"
                   else be.segment_max)(data, gid, num_segments=domain)
            meta["agg_dicts"][spec.out.cid] = arg.dictionary
            outs.append(red)
            outs.append(cnt)
        meta["err_sources"] = errs.sources
        return _with_err_out({i: o for i, o in enumerate(outs)}, errs), meta

    def _try_chunked_agg(self, op, steps, scan) -> Optional[VTable]:
        """Out-of-core streaming scan+aggregate: when the scan columns
        exceed the device byte budget, stream the base table in fixed-size
        chunks through device memory (the copy of chunk i+1 on a side stream
        overlapping chunk i's compute, runtime/chunked.py) and combine
        per-chunk dense aggregates on the host. One function of static
        shapes serves every chunk. The streamed table is never uploaded
        whole (session.device_table is not asked for it).

        Scope: Scan -> Select/Map* -> dense/global Aggregate (the q1/q6
        shape) -- exactly where beyond-memory tables first bite. Reference
        analogue: morsel-driven scans are size-oblivious by construction
        (src/runtime/storage/LingoDBTable.cpp:360-470); here the morsel is
        a device-sized chunk and the merge is the host-side combine (the
        ThreadLocal::merge role). The engage decision is kept in
        `self.last_chunked`."""
        import time

        from ..ops import decwide
        from ..plan.serial import plan_key
        from . import device as dv
        from . import exestore
        from . import fused as F
        from .chunked import ChunkStream

        if dv.get_mesh() is not None:
            return None
        plan = self.chunked_plan(scan.table, scan.cols)
        if plan is None:
            return None
        entry = self.session.catalog.get_table(scan.table)
        cols = [entry.storage.column(c.name) for c in scan.cols]
        if any(a.distinct for a in op.aggs):
            return None
        if any(a.fn not in ("sum", "count", "count_star", "min", "max",
                            "any_value") for a in op.aggs):
            return None
        radices = []
        domain = 1
        key_templates = []
        col_of = {c.cid: i for i, c in enumerate(scan.cols)}
        for cid in op.group_by:
            i = col_of.get(cid)
            if i is None:
                return None  # map-computed group key: not streamed
            col = cols[i]
            d = gb.small_domain(SCol(col.type, col.data, col.valid,
                                     col.dictionary))
            if d is None:
                return None
            radices.append(d)
            domain *= d
            key_templates.append((col.type, col.dictionary,
                                  col.valid is not None))
        if domain > gb.DENSE_DOMAIN_LIMIT:
            return None

        rows, m, n_chunks = plan["rows"], plan["chunk_rows"], plan["chunks"]

        templates = [(info.cid, col.type, col.dictionary,
                      col.valid is not None)
                     for info, col in zip(scan.cols, cols)]
        kinds = ["sum"]  # the `present` lane
        exact = set()  # wide sums: ONE exact total a group after the combine
        for spec in op.aggs:
            if spec.fn in ("count_star", "count"):
                kinds += ["sum", "sum"]
            elif spec.fn == "sum":
                if (spec.out.type.kind == K.DECIMAL
                        and dec_is_wide(spec.out.type)):
                    kinds += ["limb", "lo", "sum"]
                    exact.add(spec.out.cid)
                else:
                    kinds += ["sum", "sum"]
            elif spec.fn == "min":
                kinds += ["min", "sum"]
            else:  # max / any_value
                kinds += ["max", "sum"]

        parts = []
        for (_cid, _t, _d, hv), col in zip(templates, cols):
            parts.append(col.data)
            if hv:
                parts.append(col.valid)
        basekey = ("chunked_agg", plan_key(op),
                   tuple(sorted(self._subtree_versions(op))))
        cache = self.session.stage_cache
        # ONE stream a session (its two staging slots: about two thirds of
        # the budget on the device, as much pinned on the host), kept for
        # the next run of any plan of the same layout, whose graphs replay
        # over its slots; a plan of another layout replaces it, and the
        # graphs captured over the old slots go with it
        stream = cache.get(("chunk_stream",))
        if stream is not None and stream.layout == ChunkStream.layout_of(
                parts, m):
            stream.restart(parts, rows)
        else:
            if stream is not None:
                for store in self.session.graph_stores():
                    for key in stream.plans:
                        store.drop(key)
            stream = ChunkStream(parts, rows, m, self.session.device)
            cache[("chunk_stream",)] = stream
        stream.plans.add(basekey)
        # a chunk program that cannot be captured streams uncaptured
        eager = bool(cache.get(("chunked_eager", basekey)))

        def _norm(host, host_lanes):
            """Chunk lanes -> accumulable form: a wide sum becomes ONE exact
            object lane (a limb pair combines; a host lane already is one,
            whatever this chunk's representation of the argument), and the
            placeholder keeps indices aligned."""
            out = list(host)
            for i, k in enumerate(kinds):
                if k == "limb" and i not in host_lanes:
                    out[i] = decwide.combine_limbs(out[i], out[i + 1])
                    out[i + 1] = np.zeros_like(host[i + 1])
            return out

        def program_of(arrs):
            def program(static):
                with be.no_host_reads():
                    return self._chunk_program(op, steps, scan, templates, m,
                                               domain, arrs, static[0])
            return program

        acc = None
        uncaptured_s = 0.0  # the chunk programs run as they are called
        with tracer.Trace("execution", f"chunked_agg:{scan.table}"):
            stream.stage(0)
            try:
                for ci in range(n_chunks):
                    nv, arrs = stream.take(ci)
                    # the valid count, written on the compute stream after
                    # the wait on the slot's copy: the graph's one input
                    nvt = be.full(1, nv, jnp.int64, arrs[0])
                    if not eager:
                        try:
                            res, meta = self._run_program(
                                basekey, "chunk",
                                (m, exestore.signature(arrs)),
                                program_of(arrs), [nvt])
                        except (F.NotDense, be.HostRead, NotImplementedError):
                            # an expression only the host computes (wide
                            # decimals, a cast to a string): this plan
                            # streams uncaptured from here on, as it is
                            # called, host reads and all
                            cache[("chunked_eager", basekey)] = eager = True
                    if eager:
                        t0 = time.perf_counter()
                        res, meta = self._chunk_program(
                            op, steps, scan, templates, m, domain, arrs, nvt)
                        uncaptured_s += time.perf_counter() - t0
                    stream.release(ci)
                    if ci + 1 < n_chunks:
                        stream.stage(ci + 1)  # its copy rides this compute
                    # read before the next replay: a graph's outputs hold
                    # until then
                    got = dv.fetch_arrays_np(res)
                    # the statement raises at the first chunk whose live
                    # rows raise
                    sc.raise_data_error(got.pop("err", [0])[0],
                                        meta["err_sources"])
                    host = _norm([got[i] for i in range(len(got))],
                                 meta["host_lanes"])
                    del arrs, res
                    if acc is None:
                        acc = host
                        continue
                    for i, k in enumerate(kinds):
                        if k in ("sum", "limb"):
                            acc[i] = acc[i] + host[i]
                        elif k in ("min", "max"):
                            # a group with no value in a chunk holds that
                            # chunk's sentinel (the dtype's extreme, or
                            # 10^45 in a host lane): the counts (lane i + 1,
                            # not yet added in) pick the side with values
                            f = np.minimum if k == "min" else np.maximum
                            acc[i] = np.where(
                                host[i + 1] == 0, acc[i],
                                np.where(acc[i + 1] == 0, host[i],
                                         f(acc[i], host[i])))
                        # "lo": placeholder, stays zero
            finally:
                stream.finish()
        self.last_chunked = plan
        meta = {"mode": "dense", "domain": domain, "radices": radices,
                "key_templates": key_templates, "key_offsets": None,
                "join_sis": (), "agg_dicts": meta["agg_dicts"],
                "agg_limbs": set(), "agg_exact": exact}
        plan["bytes_copied"] = stream.bytes_copied
        plan["host_fill_ms"] = stream.fill_s * 1e3
        plan["uncaptured_program_ms"] = uncaptured_s * 1e3
        plan["allocated_after_chunk"] = stream.allocated_after_chunk
        res = {"lanes": acc, "extras": (), "step_counts": (), "oob": None}
        return self._finish_fused_dense(op, res, meta)

    # ------------------------------------------------- distributed shuffle
    # The sharded operators (parallel/shuffle.py) over the device mesh
    # (runtime/device.get_mesh). An operator takes a side held on the mesh
    # as it is and a whole one cut into the same layout (_on_mesh), and
    # leaves the mesh as a VTable on the session's device (on every
    # process), in the padded exchanged layout, with a selection vector
    # where the reference keeps its result lazy (_lazy_ok).
    def _lazy_ok(self, n: int) -> bool:
        """Whether a selection-vector (deferred-compaction) result is
        worthwhile: only on an active mesh at exchange-scale row counts."""
        from . import device as dv
        from ..utils.settings import get_setting

        if self._mode == "DEBUG":
            return False
        return (dv.get_mesh() is not None
                and n >= int(get_setting("system.shuffle_min_rows")))

    def _leave_mesh(self, arrays: list) -> list:
        """Sharded values as global tensors on the session's device; on a
        mesh that spans processes every process gets them whole."""
        from ..parallel import mesh as msh

        return [msh.gather(a, self.session.device) for a in arrays]

    def _try_distributed_sort(self, op: L.Sort, vt: VTable) -> Optional[VTable]:
        """Distributed sample sort over the mesh: range-partition by sampled
        lexicographic splitters, sort locally per shard (parallel/shuffle.py
        sample_sort; the reference engine's parallel merge sort), in place
        of the whole-table sort for large inputs. `vt` is dense, or held on
        the mesh (its selection vector's dead rows are dropped by the
        exchange; the decision counts its live rows, as the reference
        counts them after its global compaction)."""
        from . import device as dv
        from ..parallel import shuffle as sh
        from ..parallel.mesh import Sharded
        from ..utils.settings import get_setting

        mesh = dv.get_mesh()
        if mesh is None:
            return None
        n = (vt.num_rows if vt.row_valid is None
             else _live_rows(vt.row_valid))
        if n < int(get_setting("system.shuffle_min_rows")):
            return None
        if any(is_obj(vt.col(k.cid).data) for k in op.keys):
            return None  # wide-decimal SORT KEYS have no device order image
            # (object payload columns ship as int64 limbs)
        sv = self._on_mesh(mesh, vt)
        L = _local_len(sv)
        views = _views(sv)
        try:
            per = []
            for i, v in enumerate(views):
                ref = _view_ref(v, mesh, i)
                s0 = mesh.local_positions[i] * L
                operands = [_shard_of(o, ref, L) for o in keymod.sort_operands(
                    [(v.col(k.cid), k.ascending, k.nulls_first)
                     for k in op.keys])]
                # the original row index: the stability tiebreak, and it
                # makes splitter tuples unique, which keeps duplicate-heavy
                # key ranges balanced
                operands.append(torch.arange(s0, s0 + L, dtype=torch.int64,
                                             device=ref.device))
                nops = len(operands)
                layout, arrays = _flatten_vt(v)
                per.append(operands + [_shard_of(a, ref, L) for a in arrays])
        except _WideShip:
            return None
        cols = [Sharded(mesh, [p[j] for p in per], L)
                for j in range(len(per[0]))]
        valid, out, _cap = sh.sample_sort(mesh, cols[:nops], cols[nops:],
                                          sv.row_valid)
        valid = self._leave_mesh([valid])[0]
        total = int(valid.sum())
        if total != n:
            raise ExecError(
                f"distributed sort row mismatch: {total} of {n} rows routed")
        glen = int(valid.shape[0])
        sorted_vt = _rebuild_vt(views[0], layout,
                                self._leave_mesh(out[nops:]), glen)
        return VTable(sorted_vt.cols, glen, row_valid=valid).dense()

    def _try_sharded_join(self, op, kind, lvt, rvt, lkeys, rkeys, null_safe):
        """Shuffle join over the device mesh: hash-partition BOTH sides by
        the join key (all-to-all with exact capacities), then join locally
        per shard; no side is replicated (LingoDB's parallel hash-join state
        partitioning, ParallelizePass.cpp:34-97). Returns None when no mesh
        is active or either side is below system.shuffle_min_rows. A side
        comes held on the mesh or whole (then cut into the same layout,
        _on_mesh); the keys (`lkeys`, `rkeys`: expressions), hashes and
        payloads are computed position by position (they are row-wise)."""
        from . import device as dv
        from ..ops import hashing
        from ..parallel import mesh as msh
        from ..parallel import shuffle as sh
        from ..utils.settings import get_setting

        mesh = dv.get_mesh()
        if mesh is None:
            return None
        nl, nr = lvt.num_rows, rvt.num_rows
        if min(nl, nr) < int(get_setting("system.shuffle_min_rows")):
            return None
        if not null_safe:
            null_safe = (False,) * len(lkeys)
        lsv, rsv = self._on_mesh(mesh, lvt), self._on_mesh(mesh, rvt)
        lp_len, lb_len = _local_len(lsv), _local_len(rsv)
        lviews, rviews = _views(lsv), _views(rsv)
        # per position: probe = left, build = right; NULL keys as in
        # join.candidate_pairs (strict keys never match; null-safe keys
        # share the NULL hash)
        side_p = {"h": [], "ko": [], "arrs": [], "valid": []}
        side_b = {"h": [], "arrs": [], "valid": []}
        codes = []  # the keys' data errors, by position
        try:
            for i, (lv, rv) in enumerate(zip(lviews, rviews)):
                pref = _view_ref(lv, mesh, i)
                bref = _view_ref(rv, mesh, i)
                lk, rk = [], []
                for le, re_ in zip(lkeys, rkeys):
                    a = sc._bcast(sc.eval_expr(le, lv.cols), lp_len)
                    b = sc._bcast(sc.eval_expr(re_, rv.cols), lb_len)
                    for c, v, ln, ref in ((a, lv, lp_len, pref),
                                          (b, rv, lb_len, bref)):
                        if c.err is not None:
                            codes.append(_shard_of(
                                sc.first_error(c.err, v.row_valid, ln), ref, 1))
                    a, b = _unify_string_keys(a, b)
                    lk.append(sc._bcast(a, lp_len))
                    rk.append(sc._bcast(b, lb_len))
                hp = _shard_of(hashing.hash_columns(lk), pref, lp_len)
                hb = _shard_of(hashing.hash_columns(rk), bref, lb_len)
                pko = joinops._all_valid(
                    [c for c, ns in zip(lk, null_safe) if not ns], lp_len)
                bko = joinops._all_valid(
                    [c for c, ns in zip(rk, null_safe) if not ns], lb_len)
                if bko is not None:
                    hb = torch.where(_shard_of(bko, bref, lb_len), hb,
                                     torch.full_like(hb, sh._U64_MAX))
                side_p["ko"].append(
                    torch.ones((lp_len,), dtype=torch.bool, device=pref.device)
                    if pko is None else _shard_of(pko, pref, lp_len))
                playout, parrs = _flatten_vt(lv)
                blayout, barrs = _flatten_vt(rv)
                side_p["h"].append(hp)
                side_b["h"].append(hb)
                side_p["arrs"].append([_shard_of(a, pref, lp_len)
                                       for a in parrs])
                side_b["arrs"].append([_shard_of(a, bref, lb_len)
                                       for a in barrs])
                # selection vectors ride straight into the exchange: dead
                # (and pad) rows are dropped while packing
                side_p["valid"].append(lv.row_valid)
                side_b["valid"].append(rv.row_valid)
        except _WideShip:
            return None
        _raise_mesh_errors(mesh, codes)
        n_ax = mesh.size
        lt, rt = lviews[0], rviews[0]  # column templates of each side

        def _sharded(side, key, ln):
            return msh.Sharded(mesh, side[key], ln)

        def _dest(side, ln):
            return sh.hash_dest(mesh, _sharded(side, "h", ln)).shards

        side_p["dest"], side_b["dest"] = _dest(side_p, lp_len), _dest(side_b, lb_len)
        # sampled heavy-hitter split: when one shard would receive far more
        # probe rows than the mean, keys sampled as hot keep their probe
        # rows local and have their build rows replicated to every shard
        # (LingoDB's morsel work stealing rebalances such skew). Not for
        # FULL joins: replicated build rows would emit their unmatched
        # NULL-extended row once a shard. The sample reads live rows only
        # (the reference's also reads dead rows' hashes).
        skewf = float(get_setting("system.shuffle_skew_factor"))
        probe_split = False

        def _valid(side, ln):
            if all(v is None for v in side["valid"]):
                return None
            return msh.Sharded(mesh, [
                torch.ones_like(h, dtype=torch.bool) if v is None else v
                for v, h in zip(side["valid"], side["h"])], ln)

        def _recv(side, ln):
            return sh.dest_counts(
                mesh, msh.Sharded(mesh, side["dest"], ln),
                _valid(side, ln)).sum(axis=0)

        recv = _recv(side_p, lp_len)
        if kind != "full" and recv.max() > skewf * max(float(recv.mean()), 1.0):
            heavy = _heavy_hitters_sharded(
                _sharded(side_p, "h", lp_len), _valid(side_p, lp_len), n_ax)
            if heavy.numel():
                sh.STATS["skew_splits"] += 1
                probe_split = True
                _stay_local(mesh, side_p, heavy)
                lb_len = _replicate_hot(mesh, side_b, heavy, lb_len)
        # build-side heavy hitters (inner only): one hot build key would land
        # all its rows on one shard. The probe split with roles swapped: hot
        # build rows stay spread by position and the probe rows of those
        # keys replicate to every shard, so each (probe, build) pair still
        # forms on exactly one shard. Kinds that emit one row per probe row
        # cannot replicate probe rows, and the probe split above already
        # covers keys hot on both sides.
        if kind == "inner" and not probe_split:
            recv_b = _recv(side_b, lb_len)
            if recv_b.max() > skewf * max(float(recv_b.mean()), 1.0):
                heavy = _heavy_hitters_sharded(
                    _sharded(side_b, "h", lb_len), _valid(side_b, lb_len), n_ax)
                heavy = heavy[heavy != sh._U64_MAX]
                if heavy.numel():
                    sh.STATS["skew_splits"] += 1
                    _stay_local(mesh, side_b, heavy)
                    lp_len = _replicate_hot(mesh, side_p, heavy, lp_len)
        hp, hb = _sharded(side_p, "h", lp_len), _sharded(side_b, "h", lb_len)
        pko = _sharded(side_p, "ko", lp_len)
        dest_p = msh.Sharded(mesh, side_p["dest"], lp_len)
        dest_b = msh.Sharded(mesh, side_b["dest"], lb_len)
        valid_p, valid_b = _valid(side_p, lp_len), _valid(side_b, lb_len)
        parrs = [msh.Sharded(mesh, [a[j] for a in side_p["arrs"]], lp_len)
                 for j in range(len(side_p["arrs"][0]))]
        barrs = [msh.Sharded(mesh, [a[j] for a in side_b["arrs"]], lb_len)
                 for j in range(len(side_b["arrs"][0]))]
        lvt, rvt = lt, rt  # from here on: column templates of each side
        pv_ex, pouts, lp = sh.exchange(mesh, dest_p, [hp, pko] + parrs, valid_p)
        bv_ex, bouts, lb = sh.exchange(mesh, dest_b, [hb] + barrs, valid_b)
        pair_valid, probe_idx, build_idx, bpair, ppair, cap_out, total = \
            sh.join_pairs(mesh, bouts[0], bv_ex, pouts[0], pv_ex & pouts[1],
                          bouts[1:], pouts[2:])
        glen = n_ax * cap_out
        build_pair = _rebuild_vt(rvt, blayout, self._leave_mesh(bpair), glen)
        probe_pair = _rebuild_vt(lvt, playout, self._leave_mesh(ppair), glen)
        pair_valid = self._leave_mesh([pair_valid])[0]
        # the full predicate over the (padded) pairs is elementwise
        if op.predicate is not None and total > 0:
            env = {**build_pair.cols, **probe_pair.cols}
            # raised on the pairs (a join filter)
            m = sc.truth_mask(sc.checked(sc.eval_expr(op.predicate, env),
                                         pair_valid, glen))
            pair_ok = pair_valid & be.like(jnp.broadcast_to(m, (glen,)),
                                           pair_valid)
        else:
            pair_ok = pair_valid
        if kind == "inner":
            out = VTable({**probe_pair.cols, **build_pair.cols}, glen,
                         row_valid=pair_ok)
            return out if self._lazy_ok(glen) else out.dense()
        plen = n_ax * lp
        probe_ex = _rebuild_vt(lvt, playout, self._leave_mesh(pouts[2:]), plen)
        pv_g = self._leave_mesh([pv_ex])[0]
        flags = self._leave_mesh(
            [sh.probe_flags(mesh, pair_ok, probe_idx, lp)])[0]
        if kind in ("semi", "anti"):
            keep = (flags if kind == "semi" else ~flags) & pv_g
            out = VTable(probe_ex.cols, plen, row_valid=keep)
            return out if self._lazy_ok(plen) else out.dense()
        if kind == "mark":
            cols = dict(probe_ex.cols)
            cols[op.mark_col.cid] = SCol(op.mark_col.type, flags, None)
            out = VTable(cols, plen, row_valid=pv_g)
            return out if self._lazy_ok(plen) else out.dense()
        if kind == "single":
            # at most one build match per probe row (a scalar subquery):
            # the first passing pair's build payload per exchanged probe
            # row, NULL where there is none (one output row per left row)
            found, picked = sh.single_pick(mesh, pair_ok, probe_idx, lp, bpair)
            found = self._leave_mesh([found])[0]
            right_vt = _rebuild_vt(rvt, blayout, self._leave_mesh(picked), plen)
            cols = dict(probe_ex.cols)
            for c in op.right.output_cols():
                scol = right_vt.col(c.cid)
                f = be.to_host(found) if is_obj(scol.data) else found
                v = f if scol.valid is None else (scol.valid & f)
                cols[c.cid] = SCol(scol.type.as_nullable(), scol.data, v,
                                   scol.dictionary)
            return VTable(cols, plen).select_mask(pv_g)
        # left/full join: matched pairs + unmatched probe rows with NULL right
        # cols (+ for full: unmatched build rows with NULL left cols)
        inner = VTable({**probe_pair.cols, **build_pair.cols},
                       glen).select_mask(pair_ok)
        unmatched = probe_ex.select_mask(~flags & pv_g)
        parts = [inner]
        if unmatched.num_rows:
            cols = dict(unmatched.cols)
            for c in op.right.output_cols():
                cols[c.cid] = _null_scol(rvt.col(c.cid), unmatched.num_rows)
            parts.append(VTable(cols, unmatched.num_rows))
        if kind == "full":
            blen = n_ax * lb
            bflags = self._leave_mesh(
                [sh.probe_flags(mesh, pair_ok, build_idx, lb)])[0]
            build_ex = _rebuild_vt(rvt, blayout, self._leave_mesh(bouts[1:]),
                                   blen)
            bv_g = self._leave_mesh([bv_ex])[0]
            un_b = build_ex.select_mask(~bflags & bv_g)
            if un_b.num_rows:
                cols = {cid: _null_scol(lvt.col(cid), un_b.num_rows)
                        for cid in lvt.cols}
                for c in op.right.output_cols():
                    cols[c.cid] = un_b.col(c.cid)
                parts.append(VTable(cols, un_b.num_rows))
        out = parts[0]
        for p in parts[1:]:
            out = _vconcat(out, p, op.output_cols())
        return out

    _SHARDED_AGG_FNS = {"sum", "count", "count_star", "min", "max"}

    def _try_sharded_agg(self, op: L.Aggregate, vt: VTable) -> Optional[VTable]:
        """Large-domain distributed aggregation: repartition rows by group-
        key hash and group locally per shard. Every group lands on exactly
        one shard, so the local result is final (LingoDB's partitioned
        PreAggregationHashtable merge). Dense small domains decline (the
        single-device grouping serves them). `vt` is held on the mesh or
        whole (then cut into the same layout); the key images, hashes and
        arguments are computed position by position."""
        from . import device as dv
        from ..ops import hashing
        from ..parallel import shuffle as sh
        from ..parallel.mesh import Sharded
        from ..utils.settings import get_setting

        mesh = dv.get_mesh()
        if mesh is None or not op.group_by:
            return None
        n = vt.num_rows
        if n < int(get_setting("system.shuffle_min_rows")):
            return None
        has_distinct = False
        for spec in op.aggs:
            if spec.fn not in self._SHARDED_AGG_FNS:
                return None
            arg = None if spec.arg is None else vt.col(spec.arg)
            if arg is not None and is_obj(arg.data):
                return None  # wide-decimal arguments stay on the local path
            if spec.distinct:
                if spec.fn == "count_star":
                    return None
                has_distinct = True
        domains = [gb.small_domain(vt.col(c)) for c in op.group_by]
        if (all(d is not None for d in domains)
                and int(np.prod(domains)) <= gb.DENSE_DOMAIN_LIMIT):
            return None  # a small dense domain: the local grouping is cheaper
        sv = self._on_mesh(mesh, vt)
        L = _local_len(sv)
        per = []  # per position: imgs, [h], rep arrays, agg arrays + masks
        try:
            for i, v in enumerate(_views(sv)):
                ref = _view_ref(v, mesh, i)
                key_cols = [v.col(c) for c in op.group_by]
                imgs = [_shard_of(x, ref, L)
                        for x in keymod.grouping_images(key_cols)]
                h = _shard_of(hashing.hash_columns(key_cols), ref, L)
                rep_layout, reps = _flatten_vt(
                    VTable({c.cid: v.col(c.cid) for c in op.group_cols}, L))
                reps = [_shard_of(a, ref, L) for a in reps]
                ones = torch.ones((L,), dtype=torch.bool, device=ref.device)
                aggs = []  # (kind, [arrays], valid)
                for spec in op.aggs:
                    arg = None if spec.arg is None else v.col(spec.arg)
                    av = (ones if arg is None or arg.valid is None
                          else _shard_of(arg.valid, ref, L))
                    out_dt = np_dtype(spec.out.type)
                    if spec.distinct and spec.fn in ("count", "sum"):
                        aimgs = [_shard_of(x, ref, L)
                                 for x in keymod.grouping_images([arg])]
                        if spec.fn == "count":
                            aggs.append(("cdist", aimgs, av))
                        elif _wide_sum(spec):  # its limbs, as below
                            vals = be.astype(_shard_of(arg.data, ref, L),
                                             np.int64)
                            aggs.append(("sdist", aimgs + [vals >> 32], av))
                            aggs.append(("sdist", aimgs + [vals & 0xFFFFFFFF],
                                         av))
                        else:
                            vals = be.astype(_shard_of(arg.data, ref, L), out_dt)
                            aggs.append(("sdist", aimgs + [vals], av))
                    elif spec.fn in ("count", "count_star"):
                        aggs.append(("count", [torch.ones(
                            (L,), dtype=torch.int64, device=ref.device)], av))
                    elif spec.fn == "sum" and _wide_sum(spec):
                        # exact past int64: the 32-bit limbs summed apart
                        # through both rounds, recombined on the host
                        vals = be.astype(_shard_of(arg.data, ref, L), np.int64)
                        aggs.append(("sum", [vals >> 32], av))
                        aggs.append(("sum", [vals & 0xFFFFFFFF], av))
                    elif spec.fn == "sum":
                        vals = be.astype(_shard_of(arg.data, ref, L), out_dt)
                        aggs.append(("sum", [vals], av))
                    else:  # min / max (DISTINCT is a no-op for them)
                        aggs.append((spec.fn, [_shard_of(arg.data, ref, L)],
                                     av))
                per.append((imgs, h, reps, aggs,
                            ones if v.row_valid is None else v.row_valid))
        except _WideShip:
            return None

        def sharded(get):
            return Sharded(mesh, [get(p) for p in per], L)

        imgs = [sharded(lambda p, j=j: p[0][j]) for j in range(len(per[0][0]))]
        h = sharded(lambda p: p[1])
        rep_arrays = [sharded(lambda p, j=j: p[2][j])
                      for j in range(len(per[0][2]))]
        aggs_in = [(k, [sharded(lambda p, a=a, j=j: p[3][a][1][j])
                        for j in range(len(arrs))],
                    sharded(lambda p, a=a: p[3][a][2]))
                   for a, (k, arrs, _m) in enumerate(per[0][3])]
        row_valid = None if sv.row_valid is None else sharded(lambda p: p[4])
        ones = sharded(lambda p: torch.ones_like(p[1], dtype=torch.bool))
        ni, nr_ = len(imgs), len(rep_arrays)
        if has_distinct:
            # distinct aggregates cannot pre-combine: ship the raw rows keyed
            # by group hash; after the exchange every group lives wholly on
            # one shard and the local distinct grouping is exact
            flat_in = []
            for _k, arrs, m in aggs_in:
                flat_in.extend(arrs)
                flat_in.append(m)
            ex_valid, outs, _lp = sh.exchange(
                mesh, sh.hash_dest(mesh, h), imgs + rep_arrays + flat_in,
                row_valid)
            pos = ni + nr_
            flat_ex = []
            for k, arrs, _m in aggs_in:
                na = len(arrs)
                flat_ex.append((k, list(outs[pos:pos + na]), outs[pos + na]))
                pos += na + 1
            gvalid, reps_out, agg_out = sh.grouped_reduce(
                mesh, ex_valid, outs[:ni], outs[ni:ni + nr_], flat_ex)
            final = [(agg_out[i][0],
                      None if aggs_in[i][0] in ("count", "cdist")
                      else agg_out[i][1])
                     for i in range(len(aggs_in))]
        else:
            # round 1: local pre-aggregation on the rows' own sharding (the
            # thread-local combiner): the exchange then moves local groups,
            # not rows, which also makes it skew-proof
            v1 = ones if row_valid is None else row_valid
            gv1, reps_o1, agg_o1 = sh.grouped_reduce(
                mesh, v1, imgs, [h] + imgs + rep_arrays, aggs_in)
            h1 = reps_o1[0]
            imgs_p = reps_o1[1:1 + ni]
            reps_p = reps_o1[1 + ni:]
            # round 2: exchange the partial groups by key hash, group again
            aggs2 = []  # parallel to op.aggs: (main_idx, cnt_idx or None)
            flat2 = []
            for (k, _arrs, _m), res in zip(aggs_in, agg_o1):
                if k == "count":
                    aggs2.append((len(flat2), None))
                    flat2.append(("sum", [res[0]], gv1))
                else:
                    val, cnt = res
                    aggs2.append((len(flat2), len(flat2) + 1))
                    flat2.append((k, [val], gv1 & (cnt > 0)))
                    flat2.append(("sum", [cnt], gv1))
            arrays2 = list(imgs_p) + list(reps_p) + [
                a for _k, arrs, m in flat2 for a in (arrs[0], m)]
            ex_valid, outs, _lp = sh.exchange(mesh, sh.hash_dest(mesh, h1),
                                              arrays2, gv1)
            flat2_ex = [(k, [outs[ni + nr_ + 2 * i]], outs[ni + nr_ + 2 * i + 1])
                        for i, (k, _arrs, _m) in enumerate(flat2)]
            gvalid, reps_out, agg_out = sh.grouped_reduce(
                mesh, ex_valid, outs[:ni], outs[ni:ni + nr_], flat2_ex)
            final = [(agg_out[mi][0], None if ci is None else agg_out[ci][0])
                     for mi, ci in aggs2]
        gvalid = self._leave_mesh([gvalid])[0]
        glen = int(gvalid.shape[0])
        cols = dict(_rebuild_vt(vt, rep_layout, self._leave_mesh(reps_out),
                                glen).cols)
        final = iter(final)
        for spec in op.aggs:
            val, cnt = next(final)
            val = self._leave_mesh([val])[0]
            if _wide_sum(spec):
                lo, _cnt = next(final)
                total = decwide.combine_limb_sums(
                    val, self._leave_mesh([lo])[0])
                cnt = self._leave_mesh([cnt])[0]
                cols[spec.out.cid] = (
                    SCol(spec.out.type, total, be.to_host(cnt > 0))
                    if is_obj(total) else
                    SCol(spec.out.type, be.like(total, cnt), cnt > 0))
                continue
            if cnt is None:  # count / count distinct: 0 on empty, never NULL
                cols[spec.out.cid] = SCol(spec.out.type, val, None)
                continue
            cnt = self._leave_mesh([cnt])[0]
            if np_dtype(spec.out.type) == np.bool_:
                val = val > 0
            arg = None if spec.arg is None else vt.col(spec.arg)
            dic = arg.dictionary if spec.fn in ("min", "max") else None
            cols[spec.out.cid] = SCol(spec.out.type, val, cnt > 0, dic)
        out = VTable(cols, glen, row_valid=gvalid)
        return out if self._lazy_ok(glen) else out.dense()

    # ------------------------------------------------------------- leaves
    def _run_scan(self, op: L.Scan) -> VTable:
        dev = self.session.device_table(op.table)
        cols = {}
        n = dev["__num_rows__"]
        for c in op.cols:
            cols[c.cid] = dev[c.name]
        pad = dev["__pad_mask__"]
        vt = VTable(cols, n, row_valid=pad)
        from . import device as dv

        if dv.is_sharded(vt):
            return self._scan_on_mesh(op, vt)
        # ONE combined compaction for every pushed restriction: each
        # select_mask costs a count sync + a gather over all columns —
        # evaluating restrictions on the full columns first is safe
        # (excluded rows' predicate garbage is masked by the conjunction)
        mask = None
        for r in op.restrictions:
            # a row raises only in the restrictions it reaches
            m = jnp.broadcast_to(sc.truth_mask(sc.checked(
                sc.eval_expr(r, vt.cols), mask, n)), (n,))
            mask = m if mask is None else mask & m
        if mask is not None:
            # on a mesh, compaction is deferred to a selection vector: the
            # next keyed exchange drops dead rows for free (VTable.row_valid)
            if self._lazy_ok(n):
                return VTable(cols, n, row_valid=mask)
            vt = vt.select_mask(mask)
        return vt

    def _scan_on_mesh(self, op: L.Scan, vt: VTable) -> VTable:
        """The scan of a table held on the mesh (the port of the reference's
        scan over its sharded columns): each position evaluates the
        restrictions over its own rows (they are row-wise), their truth
        mask is anded with the pad mask, and the result stays on the mesh
        under that selection vector where _lazy_ok; otherwise each
        position compacts its rows and the survivors leave the mesh. Pad
        rows hold zeros: what a restriction computes on them is masked by
        the conjunction."""
        if op.restrictions:
            vt = self._mask_on_mesh(vt, op.restrictions)
        if vt.row_valid is None or self._lazy_ok(vt.num_rows):
            return vt
        return self._gather_input(vt)

    def _mask_on_mesh(self, vt: VTable, preds) -> VTable:
        """`vt` (held on the mesh) under its selection vector anded with
        the truth of every predicate, evaluated position by position."""
        from ..parallel.mesh import Sharded

        mesh = _mesh_of(vt)
        L = _local_len(vt)
        masks, codes = [], []
        for i, v in enumerate(_views(vt)):
            ref = _view_ref(v, mesh, i)
            m = v.row_valid
            for r in preds:
                c = sc._bcast(sc.eval_expr(r, v.cols), L)
                if c.err is not None:
                    codes.append(_shard_of(
                        sc.first_error(c.err, m, L), ref, 1))
                t = _shard_of(sc.truth_mask(c), ref, L)
                m = t if m is None else m & t
            masks.append(m)
        _raise_mesh_errors(mesh, codes)
        return VTable(vt.cols, vt.num_rows, row_valid=Sharded(mesh, masks, L))

    def _run_constrel(self, op: L.ConstRel) -> VTable:
        n = len(op.rows)
        cols = {}
        for i, info in enumerate(op.cols):
            vals = [r[i] for r in op.rows]
            cols[info.cid] = _scol_from_values(vals, info.type)
        return VTable(cols, n)

    # ------------------------------------------------------------- unary ops
    def _run_select(self, op: L.Select) -> VTable:
        from . import device as dv

        fused = self._try_fused_chain(op)
        if fused is not None:
            return fused
        vt = self.run_sharded(op.child)
        if dv.is_sharded(vt):
            out = self._mask_on_mesh(vt, [op.predicate])
            return out if self._lazy_ok(out.num_rows) else \
                self._gather_input(out)
        if vt.num_rows == 0:
            return vt
        mask = sc.truth_mask(sc.checked(sc.eval_expr(op.predicate, vt.cols),
                                        vt.row_valid, vt.num_rows))
        mask = jnp.broadcast_to(mask, (vt.num_rows,))
        if vt.row_valid is not None:
            # dead rows' predicate garbage is masked by the conjunction
            return VTable(vt.cols, vt.num_rows, row_valid=vt.row_valid & mask)
        return vt.select_mask(mask)

    def _run_map(self, op: L.Map) -> VTable:
        from . import device as dv

        vt = self.run_sharded(op.child)
        if dv.is_sharded(vt):
            out = self._map_on_mesh(op, vt)
            if out is not None:
                return out
            vt = self._gather_input(vt)
        cols = dict(vt.cols)
        for info, expr in op.computed:
            c = sc._bcast(sc.eval_expr(expr, cols), vt.num_rows)
            cols[info.cid] = c
        sc.checked_all(cols, [info.cid for info, _e in op.computed],
                       vt.row_valid, vt.num_rows)
        return VTable(cols, vt.num_rows, row_valid=vt.row_valid)

    def _map_on_mesh(self, op: L.Map, vt: VTable) -> Optional[VTable]:
        """A Map over a table held on the mesh, position by position (its
        expressions are row-wise); None where one yields a host (wide
        decimal) column, which the caller computes over the gathered
        table."""
        from ..parallel.mesh import Sharded

        mesh = _mesh_of(vt)
        L = _local_len(vt)
        outs, codes = [], []
        for i, v in enumerate(_views(vt)):
            ref = _view_ref(v, mesh, i)
            cols = dict(v.cols)
            made = {}
            for info, expr in op.computed:
                c = sc._bcast(sc.eval_expr(expr, cols), L)
                if is_obj(c.data):
                    return None
                if c.err is not None:
                    codes.append(_shard_of(
                        sc.first_error(c.err, v.row_valid, L), ref, 1))
                c = SCol(c.type, _shard_of(c.data, ref, L),
                         None if c.valid is None
                         else _shard_of(c.valid, ref, L), c.dictionary)
                cols[info.cid] = made[info.cid] = c
            outs.append(made)
        _raise_mesh_errors(mesh, codes)
        cols = dict(vt.cols)
        for info, _expr in op.computed:
            cs = [o[info.cid] for o in outs]
            d0 = cs[0].dictionary
            if any(c.dictionary is not d0 and not (
                    c.dictionary is not None and d0 is not None
                    and np.array_equal(c.dictionary, d0)) for c in cs):
                return None  # a dictionary made from one position's rows
            valid = None
            if any(c.valid is not None for c in cs):
                valid = Sharded(mesh, [
                    c.valid if c.valid is not None
                    else torch.ones_like(c.data, dtype=torch.bool)
                    for c in cs], L)
            cols[info.cid] = SCol(cs[0].type,
                                  Sharded(mesh, [c.data for c in cs], L),
                                  valid, cs[0].dictionary)
        return VTable(cols, vt.num_rows, row_valid=vt.row_valid)

    def _run_limit(self, op: L.Limit) -> VTable:
        vt = self.run(op.child).dense()
        lo = min(op.offset, vt.num_rows)
        hi = min(op.offset + op.n, vt.num_rows)
        idx = jnp.arange(lo, hi, dtype=jnp.int64)
        return vt.take(idx, hi - lo)

    def _run_sort(self, op: L.Sort) -> VTable:
        from . import device as dv

        vt = self.run_sharded(op.child)
        if dv.is_sharded(vt):
            dist = self._try_distributed_sort(op, vt)
            if dist is not None:
                return dist
            vt = self._gather_input(vt)
        vt = vt.dense()
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
        return _topk_rows(op, self.run(op.child).dense())

    def _try_fused_topk(self, op: L.TopK) -> Optional[VTable]:
        """Fold a TopK over Map*(Aggregate) or over a fused chain into that
        program as an epilogue: the program emits only the top kk candidate
        rows by the primary sort key (slack and an exact tie check, see
        fused.topk_candidates); here the small candidate set is re-sorted
        under the FULL key order and sliced. This replaces the eager
        epilogue's operators, and their syncs, with none."""
        from . import device as dv

        node = op.child
        maps = []
        while isinstance(node, L.Map):
            maps.append(node)
            node = node.children()[0]
        is_agg = isinstance(node, L.Aggregate) and node.group_by
        if not (is_agg or isinstance(node, (L.Select, L.Join))):
            return None
        k = op.offset + op.n
        if k <= 0 or k > (1 << 13):
            return None
        # pow2 slack: secondary keys resolve among the candidates on the
        # host; ties at the cutoff beyond the slack decline (EpiOverflow)
        kk = 1 << (max(2 * k, k + 32) - 1).bit_length()
        epi = {"node": op, "maps": list(reversed(maps)), "k": k, "kk": kk,
               "out_cids": [c.cid for c in op.child.output_cols()]}
        res = (self._try_fused_agg(node, epi=epi) if is_agg
               else self._try_fused_chain(node, epi=epi))
        if res is None:
            return None
        vt, applied = res
        if not applied:
            # dense mode or a declined epilogue: the whole result came back;
            # the Map steps run here (a dense result is host numpy already)
            for m in reversed(maps):
                cols = dict(vt.cols)
                for info, expr in m.computed:
                    cols[info.cid] = sc._bcast(
                        sc.eval_expr(expr, cols), vt.num_rows)
                sc.checked_all(cols, [info.cid for info, _e in m.computed],
                               None, vt.num_rows)
                vt = VTable(cols, vt.num_rows)
        return _topk_rows(op, dv.demote_small(vt))

    def _run_distinct(self, op: L.Distinct) -> VTable:
        vt = self.run(op.child).dense()
        if vt.num_rows == 0:
            return vt
        grp = gb.group_rows([vt.col(c) for c in op.cids], vt.num_rows)
        rep = grp["rep_rows"]
        return vt.take(rep, grp["num_groups"])

    def _run_materialize(self, op: L.Materialize) -> VTable:
        return self.run(op.child).dense()

    def _run_iterref(self, op: L.IterRef) -> VTable:
        vt = self._iter_tables.get(op.holder.seq)
        if vt is None:
            raise ExecError("IterRef outside an executing Iterate")
        # positional rename: working cols -> this reference's cids
        work = list(vt.cols.values())
        return VTable({c.cid: s for c, s in zip(op.cols, work)}, vt.num_rows)

    def _run_iterate(self, op: L.Iterate) -> VTable:
        """Iterate-until-fixpoint (reference: subop.loop lowering in
        SubOpToControlFlow.cpp; SQL WITH RECURSIVE lowers here).

        Each round runs the step plan with the working table rebound; the
        only extra host sync per round is the row-count check that decides
        termination -- the same one-sync-per-size-changing-op contract as
        the rest of the executor. Semi-naive for UNION: the working table
        holds only never-seen-before rows. The rounds run are kept in
        `self.last_iterate_rounds`."""
        from . import device as dv

        base = self.run(op.base).dense()
        cur = VTable({c.cid: base.col(s) for c, s in zip(op.cols, op.lmap)},
                     base.num_rows)
        if op.distinct and cur.num_rows:
            grp = gb.group_rows([cur.col(c.cid) for c in op.cols], cur.num_rows)
            cur = cur.take(grp["rep_rows"], grp["num_groups"])
        acc = cur
        it = 0
        while cur.num_rows:
            it += 1
            if it > op.max_iters:
                raise ExecError(
                    f"Iterate exceeded max_iters={op.max_iters} (possible "
                    f"non-terminating recursion)")
            prev = self._iter_tables.get(op.holder.seq)
            self._iter_tables[op.holder.seq] = cur
            try:
                out = self.run(op.step).dense()
            finally:
                if prev is None:
                    self._iter_tables.pop(op.holder.seq, None)
                else:
                    self._iter_tables[op.holder.seq] = prev
            nxt = VTable({c.cid: out.col(s) for c, s in zip(op.cols, op.smap)},
                         out.num_rows)
            if op.distinct:
                nxt = self._iter_new_rows(nxt, acc, op.cols)
            if nxt.num_rows == 0:
                break
            a, b = dv.align_devices(acc, nxt)
            acc = _vconcat(a, b, op.cols)
            cur = b
        self.last_iterate_rounds = it
        return acc if op.emit == "all" else cur

    def _iter_new_rows(self, nxt: VTable, acc: VTable, cols) -> VTable:
        """Semi-naive delta: distinct rows of `nxt` not present in `acc`."""
        from . import device as dv

        if nxt.num_rows == 0:
            return nxt
        acc_a, nxt_a = dv.align_devices(acc, nxt)
        both = _vconcat(acc_a, nxt_a, cols)
        ref = _first_tensor(both)
        grp = gb.group_rows([both.col(c.cid) for c in cols], both.num_rows)
        seg, g, order = grp["seg"], grp["num_groups"], grp["order"]
        tag = jnp.concatenate([
            be.full(acc_a.num_rows, 0, jnp.int64, ref),
            be.full(nxt_a.num_rows, 1, jnp.int64, ref),
        ])
        t = tag if order is None else jnp.take(tag, order)
        seen = be.segment_sum(1 - t, seg, num_segments=g,
                              indices_are_sorted=grp["sorted"])
        keep = (seen == 0)
        rep = grp["rep_rows"]
        keep_np = be.to_host(keep)
        rep_np = be.to_host(rep)
        idx = rep_np[keep_np]
        return both.take(be.like(idx, ref), len(idx))

    # ------------------------------------------------------------- window
    def _run_window(self, op: L.Window) -> VTable:
        from ..ops import window as winmod

        vt = self.run(op.child).dense()
        return winmod.run_window(op, vt)
    def _run_tmp(self, op: L.Tmp) -> VTable:
        """Materialize the shared subtree ONCE per execution; every Tmp
        reference renames the holder's columns to its own cids (reference:
        relalg.tmp / GetLocal lowering, RelAlgToSubOp.cpp)."""
        vt = self._tmp_results.get(id(op.holder))
        if vt is None:
            vt = self.run(op.holder.plan).dense()
            if not _has_iterref(op.holder.plan):
                # over an Iterate's working table the result holds for
                # one round only
                self._tmp_results[id(op.holder)] = vt
        cols = {c.cid: vt.col(s) for s, c in op.mapping}
        return VTable(cols, vt.num_rows)

    # ---------------------------------------------------- fused agg pipeline
    # Scan -> Select/Map/dimension-Join chain -> Aggregate runs as ONE
    # program (masked aggregation, compaction only at static capacities),
    # the counterpart of the reference's fused per-morsel pipeline
    # (SubOpToControlFlow emits one loop doing scan+filter+join+aggregate).
    _FUSABLE_KEY_KINDS = (K.INT, K.BIGINT, K.DATE, K.TIMESTAMP, K.BOOL)

    def _subtree_versions(self, node) -> list:
        out = []

        def walk(x):
            if isinstance(x, L.Scan):
                e = self.session.catalog.get_table(x.table)
                if e is not None:
                    out.append((x.table, e.storage.version))
            if isinstance(x, L.Tmp):
                walk(x.holder.plan)
            for c in x.children():
                walk(c)

        walk(node)
        return out

    def _has_hash_index(self, build_plan, key_pair, key_pair2):
        """True when the build side is a base-table scan carrying a declared
        hash index whose key set equals the join key columns."""
        node = build_plan
        while isinstance(node, (L.Select, L.Map)):
            node = node.children()[0]
        if not isinstance(node, L.Scan):
            return False
        entry = self.session.catalog.get_table(node.table)
        if entry is None or not entry.indexes:
            return False
        cid_to_name = {c.cid: c.name for c in node.cols}
        names = []
        for kp in (key_pair, key_pair2):
            if kp is None:
                continue
            bexpr = kp[1]
            if not isinstance(bexpr, ColRef) or bexpr.cid not in cid_to_name:
                return False
            names.append(cid_to_name[bexpr.cid])
        return bool(names) and entry.index_on(names) is not None

    def _prep_fused_join(self, jop, build_plan, build_is_right, needed_cids,
                         sorted_cids=frozenset()):
        """Validate + materialize one dimension join for the fused program.
        Returns None when the join can't be a static-shape unique-key lookup.
        sorted_cids: spine columns known to be physically nondecreasing
        (clustered base-table order); probes on them read the LUT in order.
        The build side runs eagerly (it is small); its arrays are uploaded
        once and cached with the prep."""
        from . import device as dv

        dev = self.session.device
        lcids = {c.cid for c in jop.left.output_cols()}
        rcids = {c.cid for c in jop.right.output_cols()}
        probe_cids = lcids if build_is_right else rcids
        build_cids = rcids if build_is_right else lcids

        def to_np(a):
            return np.asarray(be.to_host(a))

        if jop.predicate is None:
            if jop.kind != "single":
                return None
            # scalar-subquery broadcast: the build side is a 1-row relation
            # (global aggregate) whose values broadcast to every probe row
            # (reference: GetScalarOp lowering via a single join)
            bvt = self.run(build_plan).dense()
            if bvt.num_rows > 1:
                return None
            payloads, arrays = [], []
            present = bvt.num_rows == 1
            for cid in sorted(needed_cids & build_cids):
                c = bvt.col(cid)
                if is_obj(c.data):
                    return None  # wide-decimal scalar: host-only value
                data = to_np(c.data).reshape(-1)[:1]
                if not present:
                    data = np.zeros((1,), data.dtype)
                valid = None
                if c.valid is not None:
                    valid = (to_np(c.valid).reshape(-1)[:1] if present
                             else np.zeros((1,), bool))
                arrays.append(data)
                if valid is not None:
                    arrays.append(valid)
                payloads.append((cid, c.type, valid is not None, c.dictionary))
            return {"kind": "single_broadcast", "present": present,
                    "payloads": payloads,
                    "arrays": [be.to_device(a, dev) for a in arrays]}
        conjs = E.conjuncts(jop.predicate)
        pairs = []
        residual = []
        for c in conjs:
            if isinstance(c, Call) and c.op == "eq" and len(pairs) < 2:
                a, b = c.args
                ua, ub = E.used_cols(a), E.used_cols(b)
                if ua and ub:
                    if ua <= probe_cids and ub <= build_cids:
                        pairs.append((a, b))
                        continue
                    if ua <= build_cids and ub <= probe_cids:
                        pairs.append((b, a))
                        continue
            residual.append(c)
        key_pair = pairs[0] if pairs else None
        key_pair2 = None
        if len(pairs) == 2:
            # composite key: pack two 32-bit images into one int64
            w32 = (K.INT, K.DATE, K.BOOL)
            if all(p.type.kind in w32 and b.type.kind in w32 for p, b in pairs):
                key_pair2 = pairs[1]
            else:
                residual.append(Call("eq", list(pairs[1]), Type.bool_(True)))
        if key_pair is None:
            # Q19 pattern: equality common to all OR branches is the lookup
            # key, the entire predicate is re-checked as residual
            lk, rk, ns = extract_equi_keys(jop.predicate, lcids, rcids)
            if lk and not any(ns):
                lexpr, rexpr = lk[0], rk[0]
                key_pair = (lexpr, rexpr) if build_is_right else (rexpr, lexpr)
                residual = [jop.predicate]
            else:
                return None
        probe_expr, build_expr = key_pair
        pt, bt = probe_expr.type, build_expr.type
        ik = self._FUSABLE_KEY_KINDS
        ok_int = pt.kind in ik and bt.kind in ik
        ok_dec = pt.kind == K.DECIMAL and bt.kind == K.DECIMAL and pt.s == bt.s
        if not (ok_int or ok_dec):
            return None
        probe_expr2 = build_expr2 = None
        if key_pair2 is not None:
            probe_expr2, build_expr2 = key_pair2

        bvt = self.run(build_plan).dense()
        bk = sc._bcast(sc.eval_expr(build_expr, bvt.cols), bvt.num_rows)
        bk2 = (None if build_expr2 is None else sc._bcast(
            sc.eval_expr(build_expr2, bvt.cols), bvt.num_rows))
        # the build keys are consumed here, on every build row
        sc.raise_data_errors([bk.err, None if bk2 is None else bk2.err],
                             None, bvt.num_rows)
        if is_obj(bk.data):
            return None
        kdata = to_np(bk.data).astype(np.int64)
        kvalid = None if bk.valid is None else to_np(bk.valid)
        if build_expr2 is not None:
            kd1, kv1 = kdata, kvalid
            kdata = (kd1 << 32) | (to_np(bk2.data).astype(np.int64) & 0xFFFFFFFF)
            if bk2.valid is not None:
                v2 = to_np(bk2.valid)
                kvalid = v2 if kvalid is None else (kvalid & v2)
            k1 = kd1 if kv1 is None else kd1[kv1]
            if len(k1) == len(np.unique(k1)):
                # the FIRST key alone is unique on the build side (q5/q7/q8:
                # supplier joins add a nationkey equality to a unique
                # suppkey): probe single-key, direct-LUT eligible, and check
                # the second equality as a residual on the gathered payload
                residual = residual + [
                    Call("eq", [probe_expr2, build_expr2], Type.bool_(True))]
                kdata, kvalid = kd1, kv1
                probe_expr2 = build_expr2 = None
        keep = np.ones(len(kdata), bool) if kvalid is None else kvalid.copy()
        kept = kdata[keep]
        order = np.argsort(kept, kind="stable")
        skeys = kept[order]
        row_ids = np.flatnonzero(keep)[order]
        maxdup = 1
        if len(skeys) > 1 and not np.all(np.diff(skeys) > 0):
            if jop.kind in ("semi", "anti") and not residual:
                # existence joins only need the key SET
                skeys, first = np.unique(skeys, return_index=True)
                row_ids = row_ids[first]
            elif jop.kind in ("semi", "anti"):
                # duplicate keys + residual: bounded candidate expansion
                _u, counts = np.unique(skeys, return_counts=True)
                maxdup = int(counts.max())
                if maxdup > 16:
                    return None
            else:
                return None  # duplicate build keys: not a unique-key lookup

        # direct-mapped position table when the key span is dense (FK joins
        # on contiguous surrogate keys), or when a declared hash index makes
        # the table worth its memory: ONE gather per probe instead of a
        # binary search
        direct = None
        skeys_or_lut = skeys
        if len(skeys) and maxdup == 1:
            kmin = int(skeys[0])
            span = int(skeys[-1]) - kmin + 1
            cap = max(4 * len(skeys), 1024)
            if self._has_hash_index(build_plan, key_pair, key_pair2):
                cap = 1 << 26
            if span <= (1 << 26) and len(skeys) >= (span >> 7):
                cap = 1 << 26
            if span <= cap and span <= (1 << 26):
                lut = np.full(span, -1, np.int32)
                # reversed assignment: first occurrence wins
                lut[(skeys - kmin).astype(np.int64)[::-1]] = np.arange(
                    len(skeys), dtype=np.int32)[::-1]
                direct = (kmin, span)
                skeys_or_lut = lut

        # payload columns referenced downstream; existence joins without a
        # residual emit none
        needed = needed_cids & build_cids
        if jop.kind in ("semi", "anti") and not residual:
            needed = set()
        payloads = []
        arrays = [skeys_or_lut]
        for cid in sorted(needed):
            c = bvt.col(cid)
            if is_obj(c.data):
                return None  # wide-decimal payload: host-only values
            arrays.append(to_np(c.data)[row_ids])
            if c.valid is not None:
                arrays.append(to_np(c.valid)[row_ids])
            payloads.append((cid, c.type, c.valid is not None, c.dictionary))
        return {
            "kind": jop.kind,
            "probe_expr": probe_expr,
            "probe_expr2": probe_expr2,
            "probe_sorted": (isinstance(probe_expr, ColRef)
                             and probe_expr.cid in sorted_cids
                             and probe_expr2 is None),
            "probe_cid": (probe_expr.cid
                          if isinstance(probe_expr, ColRef) else None),
            "build_cid": (build_expr.cid
                          if isinstance(build_expr, ColRef) else None),
            "maxdup": maxdup,
            "direct": direct,
            "residual": residual,
            "payloads": payloads,
            "nb": len(skeys),
            # pinned on the device ONCE: the prep is cached per plan and
            # table versions
            "arrays": [be.to_device(a, dev) for a in arrays],
        }

    def _agg_subtree_used_cids(self, op) -> set:
        used = set(op.group_by)
        used.update(a.arg for a in op.aggs if a.arg is not None)

        def walk(x):
            if isinstance(x, L.Select):
                used.update(E.used_cols(x.predicate))
            elif isinstance(x, L.Map):
                for _c, e in x.computed:
                    used.update(E.used_cols(e))
            elif isinstance(x, L.Join) and x.predicate is not None:
                used.update(E.used_cols(x.predicate))
            for c in x.children():
                walk(c)

        walk(op.child)
        return used

    def _propagate_sorted_probe(self, join_preps, sorted_cids) -> None:
        """A probe key that is a payload of an EARLIER unique-key INNER join
        whose own probe rides a sorted base column equals that base column on
        every unmasked row; probe with the base column instead, so that the
        sorted-probe paths engage (q18's semi probes o_orderkey, which IS
        l_orderkey on surviving rows)."""
        inner_by_build = {}
        for si in sorted(join_preps):
            p = join_preps[si]
            if (p.get("kind") == "inner" and p.get("build_cid") is not None
                    and p.get("probe_cid") in sorted_cids
                    and p.get("probe_expr2") is None):
                inner_by_build[p["build_cid"]] = (si, p["probe_expr"])
        for si in sorted(join_preps):
            p = join_preps[si]
            pe = p.get("probe_expr")
            if (isinstance(pe, ColRef) and not p.get("probe_sorted")
                    and p.get("probe_expr2") is None
                    and pe.cid in inner_by_build):
                src_si, src_expr = inner_by_build[pe.cid]
                if src_si < si:
                    p["probe_expr"] = src_expr
                    p["probe_cid"] = src_expr.cid
                    p["probe_sorted"] = True

    def _subtree_max_rows(self, node):
        if isinstance(node, L.Scan):
            e = self.session.catalog.get_table(node.table)
            return e.storage.num_rows if e is not None else 0
        if isinstance(node, L.Tmp):
            return self._subtree_max_rows(node.holder.plan)
        return max((self._subtree_max_rows(c) for c in node.children()),
                   default=0)

    def _walk_spine(self, root):
        """Select/Map chain, passing through dimension joins whose build
        side is the smaller subtree (the probe side continues the spine).
        Returns (steps bottom-up, base node)."""
        steps = []
        cur = root
        while True:
            if isinstance(cur, (L.Select, L.Map)):
                steps.append(("sm", cur))
                cur = cur.children()[0]
                continue
            if (isinstance(cur, L.Join)
                    and cur.kind in ("inner", "semi", "anti", "left", "single")
                    and getattr(cur, "null_aware", None) is None):
                lrows = self._subtree_max_rows(cur.left)
                rrows = self._subtree_max_rows(cur.right)
                if cur.kind in ("semi", "anti", "left", "single"):
                    spine, build = cur.left, cur.right  # semantics fix sides
                elif lrows >= rrows:
                    spine, build = cur.left, cur.right
                else:
                    spine, build = cur.right, cur.left
                steps.append(("join", cur, build, build is cur.right))
                cur = spine
                continue
            break
        steps.reverse()
        return steps, cur

    def _try_fused_agg(self, op: L.Aggregate, epi=None):
        """Run the aggregate and its spine as ONE program, or return None
        (the eager operators then run).

        `epi` (from _try_fused_topk) is a TopK epilogue to fold into the
        program's general mode: {"node": the TopK, "maps": the Map steps
        between it and the aggregate, bottom-up, "k", "kk", "out_cids"}.
        With `epi` given, the result is the pair (vtable, applied): applied
        means the vtable holds the at most kk TopK candidate rows, which
        the caller re-sorts under the full key order and slices; otherwise
        (dense mode, or a declined epilogue) it is the whole aggregate and
        the caller runs the epilogue eagerly.

        The program is built from static capacities learned per plan and
        table versions and kept in session.stage_cache: the group capacity
        `kg` (a count-only calibration run learns it), the lead compaction
        size (a selectivity estimate), post-join compaction caps (learned
        survivor counts) and key bounds for the sort-free dense path. A run
        that outgrows one of them raises, the executor records what it
        saw, and the program runs again (the rebuild contracts below)."""
        from ..plan.serial import plan_key
        from . import device as dv
        from . import fused as F

        want_pair = epi is not None  # also when the epilogue declines below
        epi_arg = epi  # what a rerun is asked for (it returns the pair too)

        def _ret(vt, applied):
            return (vt, applied) if want_pair else vt

        if any(a.distinct for a in op.aggs) or _has_iterref(op):
            return None
        # any_value evaluates as a reduction of any kind: within a group the
        # value is arbitrary (SQL any_value) or constant (FD-reduced keys)
        if any(a.fn not in ("sum", "count", "count_star", "min", "max",
                            "any_value") for a in op.aggs):
            return None
        # mesh scale-out: a large-domain group-by repartitions by key over
        # the mesh (the sharded path) instead of the fused program's one
        # sorted grouping. Dense-domain keys (dictionary strings, bools)
        # keep the fused program.
        if dv.get_mesh() is not None and op.group_by:
            from ..utils.settings import get_setting

            types = {c.cid: c.type for c in op.child.output_cols()}
            dense = all(
                types[cid].is_string or types[cid].kind == K.BOOL
                for cid in op.group_by if cid in types
            )
            if (not dense and self._subtree_max_rows(op.child)
                    >= int(get_setting("system.shuffle_min_rows"))):
                return None
        steps, cur = self._walk_spine(op.child)
        exprs = _program_exprs(steps, {}, cur.restrictions
                               if isinstance(cur, L.Scan) else ())
        if _udf_in_exprs(exprs):
            # a UDF runs on the host, which a program on the card cannot
            # call (nor a graph capture hold): decided here, before anything
            # runs, where the reference's trace fails on the same call
            return None
        if isinstance(cur, L.Scan) and all(st[0] == "sm" for st in steps):
            # (a chunk program that computes on the exact host path streams
            # uncaptured, its exact lanes on the host)
            ck = self._try_chunked_agg(op, steps, cur)  # out-of-core
            if ck is not None:
                return _ret(ck, False)
        if _host_only_exprs(exprs):
            return None  # the exact host path: the eager operators
        if isinstance(cur, L.Scan):
            entry = self.session.catalog.get_table(cur.table)
            if entry.storage.num_rows == 0:
                return None
            dev_t = self.session.device_table(cur.table)
            n = dev_t["__num_rows__"]
            if n < dv.SMALL_ROWS:
                return None  # host tier: the eager numpy operators run
            base_cols = [(c.cid, dev_t[c.name]) for c in cur.cols]
            base_restrictions = cur.restrictions
            mesh_base = self._fused_mesh_base(op, dev_t, base_cols)
            if mesh_base is False:
                return None
            if mesh_base is not None:
                # a table held on the mesh: the program runs position by
                # position over the shards (n rows each), the dense lanes
                # are reduced across positions (_run_on_mesh)
                n = mesh_base["L"]
                epi = None  # the TopK epilogue declines on a mesh
        else:
            # materialized spine base (a shared Tmp, a finished aggregate)
            base_cols, n = self._materialized_base(cur)
            if n < dv.SMALL_ROWS:
                return None
            base_restrictions = []
        if not isinstance(cur, L.Scan):
            mesh_base = None
        if mesh_base is None and any(
                not be.is_torch(t.data) or (t.valid is not None
                                            and not be.is_torch(t.valid))
                for _cid, t in base_cols):
            return None  # host-only (wide-decimal) columns stay eager
        versions = tuple(sorted(self._subtree_versions(op)))
        pkey = plan_key(op)
        if mesh_base is not None:
            # its own capacities and graphs: a position's rows, not the
            # table's (and the one-card session's graphs stay in the store)
            pkey = (pkey, "mesh", mesh_base["mesh"].size)
        basekey = ("fused_agg", pkey, versions)
        cache = self.session.stage_cache
        # the learned capacities and the decline marks belong to the
        # aggregate and are shared by its variants with and without the
        # epilogue; only the "eager" mark is kept per variant
        if epi is not None and cache.get(("fused_epi_decline", basekey)):
            epi = None
        key = (basekey + ("epi", plan_key(epi["node"]))
               if epi is not None else basekey)
        if cache.get(key) == "eager":
            return None
        if mesh_base is not None and cache.get(("fused_mesh_general",
                                                basekey)):
            # its groups need the sorted grouping, which no psum combines:
            # the scan's rows are gathered once onto the session's device
            # (_gather_input, under the scan's restrictions) and the
            # one-card program runs over them as over a materialized base
            # (what GSPMD does for the reference's global sorted grouping)
            base_cols, n = self._materialized_base(cur)
            if n < dv.SMALL_ROWS:
                return None
            base_restrictions, mesh_base = [], None
        self._load_capacities(basekey, n, cache,
                              ("kg", "kbounds", "stepcaps", "dense"))

        # dimension builds (eager, small), cached per plan and versions
        sorted_cids = frozenset()
        if isinstance(cur, L.Scan):
            snames = set(entry.storage.sorted_cols)
            sorted_cids = frozenset(c.cid for c in cur.cols if c.name in snames)
        prep_key = ("fused_prep", basekey)
        join_preps = cache.get(prep_key)
        if join_preps is None:
            join_preps = {}
            for si, st in enumerate(steps):
                if st[0] != "join":
                    continue
                prep = self._prep_fused_join(
                    st[1], st[2], st[3], self._agg_subtree_used_cids(op),
                    sorted_cids)
                if prep is None:
                    cache[key] = "eager"
                    return None
                join_preps[si] = prep
            self._propagate_sorted_probe(join_preps, sorted_cids)
            cache[prep_key] = join_preps
        if _host_only_exprs(_program_exprs(steps, join_preps, ())):
            cache[key] = "eager"  # a UDF in a join step's probe keys
            return None

        # a single group key riding the spine's clustered order (directly,
        # or through an inner unique-key join whose build key is the group
        # key while its probe is the sorted column) needs no sort
        def _base_col_nonnull(cid):
            t = next((t for c, t in base_cols if c == cid), None)
            return t is not None and t.valid is None

        presorted_group = len(op.group_by) == 1 and (
            (op.group_by[0] in sorted_cids
             and _base_col_nonnull(op.group_by[0]))
            or any(p.get("kind") == "inner"
                   and p.get("build_cid") == op.group_by[0]
                   and p.get("probe_cid") in sorted_cids
                   and p.get("probe_expr2") is None
                   for p in join_preps.values()))

        spine = self._plan_spine(
            steps, join_preps, cur, entry if isinstance(cur, L.Scan) else None,
            base_restrictions, n, basekey, cache,
            set(op.group_by) | {a.arg for a in op.aggs if a.arg is not None})

        # learned per-key value bounds: tiny-RANGE integer/date keys (q7/q9's
        # year x nation) take the sort-free dense path once calibrated
        kbounds = None
        force_cal = False
        if not cache.get(("fused_kbounds_dead", basekey)):
            kbounds = cache.get(("fused_kbounds", basekey))
            if kbounds is None and op.group_by and not presorted_group:
                ktypes = {c.cid: c.type for c in op.child.output_cols()}
                force_cal = any(
                    ktypes[cid].kind in (K.INT, K.BIGINT, K.DATE)
                    and not ktypes[cid].is_string
                    for cid in op.group_by if cid in ktypes)

        dev = self.session.device
        kg_learned = None if force_cal else cache.get(("fused_kg", basekey))
        # a materialized (or gathered) base is the program's input: a
        # captured program reads it from static inputs, into which it is
        # copied every run
        inputs = ([] if id(cur) not in self._materialized_bases
                  else [p for _cid, c in base_cols for p in (c.data, c.valid)
                        if p is not None])

        def program(static, cols=None, pad=None, dev_p=dev, preps=join_preps):
            if cols is None:
                cols = (_rebind_cols(base_cols, static) if static
                        else base_cols)
            m = {"base_rows": n}
            with be.no_host_reads(), sc.deferred_errors() as errs:
                r = self._fused_program(
                    op, steps, preps, cols, base_restrictions, n, dev_p,
                    m, spine=spine, kbounds=kbounds, presorted=presorted_group,
                    kg=kg_learned, epi=epi, pad_mask=pad)
            m["err_sources"] = errs.sources
            return _with_err_out(r, errs), m

        from . import exestore

        material = (
            exestore.signature(base_cols) if not inputs
            else tuple((tuple(t.shape), str(t.dtype)) for t in inputs),
            exestore.signature(join_preps), spine["compact_k"],
            tuple(sorted(spine["mid_caps"].items())), kg_learned,
            repr(kbounds), force_cal, presorted_group, dv.SMALL_ROWS, n)
        # whether the run calibrates is decided on the host, as the chain
        # does: with no group capacity learned it does, unless its keys give
        # a dense id, with learned bounds or by their own domains. Those
        # domains are known from the keys' templates: here where every key
        # is a base column, else from an earlier run ("fused_dense"). A run
        # that may calibrate, and a first run over join steps whose
        # survivors no calibration taught, run uncaptured; the program at
        # what they learned is captured right after them.
        dense = cache.get(("fused_dense", basekey))
        if dense is None:
            dense = _base_keys_dense(op.group_by, base_cols)
        dense = not op.group_by or kbounds is not None or bool(dense)
        learning = ((kg_learned is None and not dense)
                    or (bool(spine["join_sis"])
                        and ("fused_stepcaps", basekey) not in cache))
        if (epi is not None and not dense and kg_learned is not None
                and _host_only_exprs(_epi_exprs(epi))):
            # the general mode evaluates a TopK epilogue's Map steps in the
            # program, and a UDF among them runs on the host: this variant
            # declines (the dense mode, and a calibration run, leave the
            # epilogue to the caller and run)
            cache[key] = "eager"
            return None
        try:
            if mesh_base is not None:
                got = self._run_on_mesh(
                    op, mesh_base, basekey, material, learning,
                    lambda cols, pad, dev_s, preps: lambda static: program(
                        static, cols, pad, dev_s, preps), join_preps)
                if got is None:
                    # the general mode: from now on the gathered program
                    self._learn(basekey, n, "dense", False)
                    cache[("fused_mesh_general", basekey)] = True
                    return self._try_fused_agg(op, epi_arg)
                res, meta = got
            else:
                res, meta = self._run_program(
                    basekey, key[len(basekey):] or None, material, program,
                    inputs, calibrating=learning)
        except (F.NotDense, be.HostRead, NotImplementedError):
            # a column or expression the program cannot carry on the device
            # (the reference's trace fails on the same ones): eager, for
            # this plan and these versions
            cache[key] = "eager"
            return None
        try:
            if op.group_by and ("fused_dense", basekey) not in cache:
                self._learn(basekey, n, "dense", gb.bounded_layout(
                    meta["key_templates"],
                    [None] * len(op.group_by)) is not None)
            if meta.get("calibrating"):
                self._learn_calibration(basekey, cache, meta, res)
                return self._try_fused_agg(op, epi_arg)
            applied = meta.get("epi") is not None
            if applied:
                vt_out = self._finish_fused_epi(op, res, meta)
            elif meta["mode"] == "general":
                vt_out = self._finish_fused_general(op, res, meta)
            else:
                vt_out = self._finish_fused_dense(op, res, meta)
            self._learn_stepcaps(basekey, cache, meta)
            if meta.get("kbounds_useless"):
                self._learn(basekey, n, "kbounds", False)
            if learning:
                # this run's rows are dropped: the program at what it
                # learned is captured and replayed now
                from ..utils import compilestats

                compilestats.add("calibrations")
                return self._try_fused_agg(op, epi_arg)
            self._materialized_bases.pop(id(cur), None)
            return _ret(vt_out, applied)
        except F.CompactOverflow:
            # the estimated survivor bound was too small: no lead compaction
            # for this plan and these versions
            cache[("fused_nocompact", basekey)] = True
            self._rebuild(basekey, "lead compaction outgrown")
            return self._try_fused_agg(op, epi_arg)
        except F.MidCompactOverflow as mo:
            # a learned post-join cap was outgrown: record the observed count;
            # the rebuild re-derives the cap or drops the compaction
            si_o, v_o = mo.args
            stepcaps2 = dict(cache.get(("fused_stepcaps", basekey)) or {})
            stepcaps2[si_o] = int(v_o)
            self._learn(basekey, n, "stepcaps", stepcaps2)
            self._rebuild(basekey, f"step {si_o} cap outgrown ({v_o})")
            return self._try_fused_agg(op, epi_arg)
        except F.CapacityOverflow as ce:
            # the learned group capacity was outgrown: twice the true count
            g_real = ce.args[0]
            self._learn(basekey, n, "kg", 1 << (2 * g_real - 1).bit_length())
            self._rebuild(basekey, f"group capacity outgrown (g={g_real})")
            return self._try_fused_agg(op, epi_arg)
        except F.KBoundsOverflow:
            # key values outside the calibrated bounds: drop the bounded
            # dense path for this plan and rebuild general
            self._learn(basekey, n, "kbounds", False)
            self._rebuild(basekey, "key values outside the learned bounds")
            return self._try_fused_agg(op, epi_arg)
        except F.EpiOverflow:
            # the TopK candidates could not be proven exact: the plain
            # program and the eager epilogue, for this plan and these
            # versions
            cache[("fused_epi_decline", basekey)] = True
            self._rebuild(basekey, "TopK epilogue declined")
            return self._try_fused_agg(op, epi_arg)
        # No counterpart here of the reference's retry "without Pallas
        # kernels" (_GatherOverflow, ("fused_nopallas", basekey)): the
        # port's gathers have no overflow flag, since gather_sorted serves
        # every index, and a rerun without the kernels would be a fallback
        # that hides the kernel on the card.

    def _fused_mesh_base(self, op, dev_t, base_cols):
        """For the fused aggregate over a scan: None when the table is not
        held on the mesh; False (decline) when it is but the program cannot
        run position by position (a wide-decimal column); else the shards
        of each position: {"mesh", "L", "cols": [per position: [(cid,
        SCol)]], "pads": [per position: the pad mask's shard or None],
        "devs": [per position: its device]}. Only the dense modes (a global
        aggregate, or keys of small domains) run so: their lanes reduce
        across positions with a psum (the reference's psum path)."""
        from ..parallel.mesh import Sharded

        if not any(isinstance(t.data, Sharded) for _cid, t in base_cols):
            return None
        if any(is_obj(t.data) for _cid, t in base_cols):
            return False
        mesh = next(t.data.mesh for _cid, t in base_cols
                    if isinstance(t.data, Sharded))
        pad = dev_t["__pad_mask__"]
        cols = []
        for i in range(len(mesh.local_positions)):
            cols.append([(cid, SCol(t.type, t.data.shards[i],
                                    None if t.valid is None
                                    else t.valid.shards[i], t.dictionary))
                         for cid, t in base_cols])
        return {"mesh": mesh, "L": dev_t["__num_rows__"] // mesh.size,
                "cols": cols,
                "pads": [None if pad is None else pad.shards[i]
                         for i in range(len(cols))],
                "devs": [torch.device(mesh.devices[s])
                         for s in mesh.local_positions]}

    def _materialized_base(self, cur) -> tuple[list, int]:
        """The fused aggregate's base computed by the eager operators (a
        shared Tmp, a finished aggregate, or the scan of a table held on the
        mesh, gathered: ONE counted gather) as columns on the session's
        device, and its row count. It runs ONCE a statement: it is stashed
        at once, so that a rerun (a calibration's, a rebuild's) or a later
        decline to the eager operators takes it instead of running it
        again."""
        from . import fused as F

        base_vt = self.run(cur).dense()
        self._materialized_bases[id(cur)] = base_vt
        n = base_vt.num_rows
        # a result of the dense grouping lives on the host tier: it is
        # uploaded, as the reference's program takes host arrays in
        # (wide-decimal object columns stay on the host and decline)
        dev = self.session.device
        return [
            (cid, c if is_obj(c.data) else SCol(
                c.type, F.on_device(c.data, n, dev),
                None if c.valid is None else F.on_device(c.valid, n, dev),
                c.dictionary))
            for cid, c in sorted(base_vt.cols.items())], n

    def _run_on_mesh(self, op, mb, basekey, material, learning, make,
                     join_preps):
        """(outputs, meta) of the fused aggregate over a table held on the
        mesh: the program of each position over its shards, on the
        position's own device with the dimension builds copied there once
        (captured in that device's graph store, each position its own
        graph: the key holds its shards' addresses), then its dense lanes
        summed across positions (min and max lanes reduced by min and max)
        with mesh.preduce, its survivor counts by max (each position's
        compaction holds the same capacity), its out-of-bounds count summed.
        The positions' programs are queued one after another and run on
        their cards side by side. None when the program took the general
        mode (sorted groups, which no psum combines): the caller then
        gathers the scan and runs the one-card program over it
        (_materialized_base)."""
        import contextlib

        from . import exestore
        from ..parallel import mesh as msh

        mesh = mb["mesh"]
        runs = []
        for cols, pad, dev_s in zip(mb["cols"], mb["pads"], mb["devs"]):
            preps = self._preps_on(basekey, join_preps, dev_s)
            mat = ((exestore.signature(cols), exestore.signature(pad),
                    exestore.signature(preps)) + material[2:])
            ctx = (torch.cuda.device(dev_s) if dev_s.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                res, meta = self._run_program(
                    basekey, "mesh", mat, make(cols, pad, dev_s, preps), [],
                    calibrating=learning, device=dev_s)
            if meta.get("mode") != "dense":
                return None
            # a graph's outputs hold until the next replay: keep copies
            runs.append(({k: _clone_out(v) for k, v in res.items()}, meta))
        meta = dict(runs[0][1])
        ops = ["sum"]  # present
        for spec in op.aggs:
            if spec.fn in ("count_star", "count"):
                ops += ["sum", "sum"]
            elif spec.fn == "sum":
                ops += ["sum"] * (3 if spec.out.cid in meta["agg_limbs"]
                                  else 2)
            else:
                ops += ["min" if spec.fn == "min" else "max", "sum"]
        res = {"lanes": [msh.preduce(mesh, [r["lanes"][j] for r, _m in runs],
                                     o) for j, o in enumerate(ops)]}
        for k, o in (("extras", "max"), ("step_counts", "max")):
            res[k] = [msh.preduce(mesh, [r[k][j] for r, _m in runs], o)
                      for j in range(len(runs[0][0][k]))]
        oob = [r["oob"] for r, _m in runs]
        res["oob"] = None if oob[0] is None else msh.preduce(mesh, oob, "sum")
        errs = [r["err"] for r, _m in runs if "err" in r]
        if errs:
            res["err"] = msh.preduce(mesh, errs, "max")
        return res, meta

    def _preps_on(self, basekey, join_preps, dev):
        """The fused program's dimension builds on `dev`: the session's
        own on its device, else their arrays copied there once (cached
        beside them, per plan and table versions)."""
        if dev == self.session.device or not join_preps:
            return join_preps
        key = ("fused_prep", basekey, str(dev))
        got = self.session.stage_cache.get(key)
        if got is None:
            got = {si: {**p, "arrays": [a.to(dev) for a in p["arrays"]]}
                   for si, p in join_preps.items()}
            self.session.stage_cache[key] = got
        return got

    def _plan_spine(self, steps, join_preps, cur, entry, base_restrictions,
                    n, basekey, cache, used_last) -> dict:
        """The compactions of a fused program's spine (aggregate or chain),
        as keyword arguments of fused.run_spine: the lead compaction before
        the first join, the columns each step suffix still reads (used_last:
        those the program's tail reads), and the learned post-join caps.
        `entry` is the base table's catalog entry when the base is a Scan
        (None for a materialized base: no lead compaction)."""
        from . import device as dv

        # lead compaction: when the leading filters keep a small fraction of
        # the base rows, gather the survivors once so that every join step
        # and the tail run at the compacted size. The size is a
        # selectivity estimate with 2x headroom; an overflow rebuilds
        # without it (CompactOverflow)
        first_join = next(
            (si for si, st in enumerate(steps) if st[0] == "join"), None)
        lead = first_join if first_join is not None else 0
        compact_k = None
        if (first_join is not None and entry is not None
                and n >= dv.SMALL_ROWS * 8
                and not cache.get(("fused_nocompact", basekey))):
            from ..opt.cardinality import scan_selectivity

            sel = scan_selectivity(entry, cur, list(base_restrictions))
            for st in steps[:lead]:
                if st[0] == "sm" and isinstance(st[1], L.Select):
                    sel *= scan_selectivity(
                        entry, cur, E.conjuncts(st[1].predicate))
            est = int(n * sel * 2) + COMPACT_SLACK
            k = -(-est // COMPACT_QUANTUM) * COMPACT_QUANTUM
            if k <= n // 2:
                compact_k = k
        # columns each step suffix still reads (the rest is dropped, not
        # gathered, at a compaction point)
        used_from = [set() for _ in range(len(steps) + 1)]
        used_from[len(steps)] = set(used_last)
        for si in range(len(steps) - 1, -1, -1):
            u = set(used_from[si + 1])
            st = steps[si]
            if st[0] == "sm":
                if isinstance(st[1], L.Select):
                    u |= E.used_cols(st[1].predicate)
                else:
                    for _info, e in st[1].computed:
                        u |= E.used_cols(e)
            else:
                p = join_preps[si]
                if p.get("probe_expr") is not None:
                    u |= E.used_cols(p["probe_expr"])
                if p.get("probe_expr2") is not None:
                    u |= E.used_cols(p["probe_expr2"])
                for r in p.get("residual", ()):
                    u |= E.used_cols(r)
            used_from[si] = u

        # post-join compaction where a narrowing join was observed to keep a
        # small fraction of the spine: caps are learned survivor counts with
        # 2x pow2 headroom
        join_sis = [si for si, st in enumerate(steps)
                    if st[0] == "join" and st[1].kind in ("inner", "semi", "anti")]
        stepcaps = cache.get(("fused_stepcaps", basekey))
        mid_caps = {}
        if stepcaps:
            size = compact_k or n
            for si in join_sis:
                obs = stepcaps.get(si)
                if obs is None:
                    continue
                capv = 1 << (max(2 * obs, dv.SMALL_ROWS) - 1).bit_length()
                if capv <= size // 4:
                    mid_caps[si] = capv
                    size = capv
        return {"compact_k": compact_k, "lead": lead,
                "used_after": used_from[lead], "used_from": used_from,
                "mid_caps": mid_caps, "join_sis": join_sis}

    def _fused_program(self, op, steps, join_preps, base_cols,
                       base_restrictions, n, dev, meta, *, spine, kbounds,
                       presorted, kg, epi=None, pad_mask=None) -> dict:
        """The fused program itself: every operation on the session's
        tensors, nothing read back to the host. Returns its outputs by name
        and fills `meta` with what the finish needs to read them. A TopK
        epilogue applies in the general mode, outside calibration. Over one
        mesh position's shard, `pad_mask` marks its true rows."""
        from . import fused as F

        env, mask, cur_n, out = F.run_spine(
            steps, join_preps, base_cols, base_restrictions, n, dev, meta,
            pad_mask=pad_mask, **spine)
        if mask is not None and mask.ndim == 0:
            mask = F.on_device(mask, cur_n, dev)
        oob_cnt = None
        offsets = None
        if op.group_by:
            key_cols = [sc._bcast(env[c], cur_n) for c in op.group_by]
            gid, domain = gb.dense_gid(key_cols)
            radices = None
            if gid is None and kbounds is not None:
                # learned-bounds dense path: codes are value - kmin; rows
                # outside the bounds are counted and force a rebuild
                gid, domain, radices, offsets, oob = gb.bounded_gid(
                    key_cols, kbounds)
                if gid is not None:
                    ob = oob if mask is None else (oob & mask)
                    oob_cnt = ob.sum(dtype=torch.int64)
                else:
                    meta["kbounds_useless"] = True
            if gid is None:
                meta["mode"] = "general"
                meta["key_templates"] = [
                    (c.type, c.dictionary, c.valid is not None)
                    for c in key_cols]
                grp = F.general_group(op, key_cols, env, mask, cur_n, meta,
                                      dev, presorted=presorted, kg=kg)
                if epi is not None and not meta["calibrating"]:
                    grp = F.apply_topk_epi(op, epi, grp, meta, dev)
                out.update(grp)
                if meta["calibrating"]:
                    # per-key value bounds ride the count-only run: a later
                    # run may take the bounded dense path
                    kb, kinds = [], []
                    for c in key_cols:
                        if (gb.small_domain(c) is None
                                and c.type.kind in (K.INT, K.BIGINT, K.DATE)
                                and be.is_torch(c.data)
                                and c.data.dtype in (torch.int32, torch.int64)):
                            k64 = c.data.to(torch.int64)
                            keep = mask
                            if c.valid is not None:
                                keep = c.valid if keep is None else keep & c.valid
                            big = 1 << 62
                            if keep is not None:
                                kb.append(torch.where(keep, k64, big).min())
                                kb.append(torch.where(keep, k64, -big).max())
                            else:
                                kb.extend([k64.min(), k64.max()])
                            kinds.append(True)
                        else:
                            kinds.append(False)
                    meta["kb_kinds"] = kinds
                    out["kb"] = kb
                return out
            if radices is None:
                radices = [gb.small_domain(c) for c in key_cols]
            gid = F.on_device(gid, cur_n, dev)
        else:
            gid = torch.zeros((cur_n,), dtype=torch.int32, device=dev)
            domain, radices = 1, []
        meta["calibrating"] = False
        meta["mode"] = "dense"
        meta["domain"], meta["radices"] = domain, radices
        meta["key_offsets"] = offsets
        meta["key_templates"] = [
            (env[c].type, env[c].dictionary, env[c].valid is not None)
            for c in op.group_by]

        def msum(w):
            wm = w if mask is None else torch.where(mask, w, torch.zeros_like(w))
            if domain == 1 and not wm.dtype.is_floating_point:
                # one group (a global aggregate): a reduction, not a
                # scatter-add of every row into one slot; exact for integers
                return wm.sum(dtype=wm.dtype).reshape(1)
            return be.segment_sum(wm, gid, num_segments=domain)

        ones = torch.ones((cur_n,), dtype=torch.int64, device=dev)
        present = msum(ones)
        lanes = [present]
        meta["agg_dicts"] = {}
        meta["agg_limbs"] = set()
        for spec in op.aggs:
            if spec.fn == "count_star":
                lanes += [present, present]
                continue
            arg = sc._bcast(env[spec.arg], cur_n)
            avalid = None if arg.valid is None else F.on_device(arg.valid, cur_n, dev)
            cnt = msum(ones if avalid is None else avalid.to(torch.int64))
            if spec.fn == "count":
                lanes += [cnt, cnt]
                continue
            adata = F.on_device(arg.data, cur_n, dev)
            if spec.fn == "sum":
                data = adata.to(be.tdtype(np_dtype(spec.out.type)))
                if avalid is not None:
                    data = torch.where(avalid, data, torch.zeros_like(data))
                if (spec.out.type.kind == K.DECIMAL
                        and dec_is_wide(spec.out.type)
                        and data.dtype == torch.int64):
                    # exact wide sum: 32-bit-split accumulators (lo in
                    # [0, 2^32), hi signed), recombined on the host
                    meta["agg_limbs"].add(spec.out.cid)
                    lanes += [msum(data >> 32), msum(data & 0xFFFFFFFF), cnt]
                    continue
                lanes += [msum(data), cnt]
                continue
            # min / max / any_value with full masking
            sentinel = gb._extreme(be.dt(adata), maximum=(spec.fn == "min"))
            keep = mask if avalid is None else (
                avalid if mask is None else (mask & avalid))
            data = adata if keep is None else torch.where(
                keep, adata, sentinel.item())
            red = (be.segment_min if spec.fn == "min" else be.segment_max)(
                data, gid, num_segments=domain)
            meta["agg_dicts"][spec.out.cid] = arg.dictionary
            lanes += [red, cnt]
        out["lanes"] = lanes
        out["oob"] = oob_cnt
        return out

    def _learn_calibration(self, basekey, cache, meta, res) -> None:
        """Count-only calibration run: learn the group capacity, the per-step
        survivor counts and the per-key value bounds (one fetch), once every
        compaction is known to have held its survivors. Bounds that cannot
        give a dense group id (a key without a small domain or bounds, or a
        domain too large) are learned as of no use at once, so that the
        program at the learned sizes is the one every later run replays."""
        from . import device as dv
        from ..utils import compilestats

        compilestats.add("calibrations")

        fetch = {"g": res["g"].reshape(1)}
        for j, c in enumerate(res.get("kb", ())):
            fetch[f"kb{j}"] = c.reshape(1)
        for j, c in enumerate(res["step_counts"]):
            fetch[f"sc{j}"] = c.reshape(1)
        for j, c in enumerate(res["extras"]):
            fetch[f"x{j}"] = c.reshape(1)
        if "err" in res:
            fetch["err"] = res["err"]
        host = {k: int(v[0]) for k, v in dv.fetch_arrays_np(fetch).items()}
        # a compaction that overflowed truncated what the run counted: learn
        # nothing from it (the reference learns from the truncated run and
        # then overflows on every learned value in turn); nor from a run
        # whose data raised
        self._check_fused_extras(meta, [host[f"x{j}"]
                                        for j in range(len(res["extras"]))])
        sc.raise_data_error(host.get("err", 0), meta.get("err_sources"))
        g = host["g"]
        tight = 1 << (max(4 * g, dv.SMALL_ROWS) - 1).bit_length()
        self._learn(basekey, meta["base_rows"], "kg",
                    min(tight, meta.get("n", tight)))
        n_kb = len(res.get("kb", ()))
        if n_kb:
            it = iter(host[f"kb{j}"] for j in range(n_kb))
            bounds = [(next(it), next(it)) if flagk else None
                      for flagk in meta["kb_kinds"]]
            useful = gb.bounded_layout(meta["key_templates"], bounds)
            self._learn(basekey, meta["base_rows"], "kbounds",
                        bounds if useful is not None else False)
        elif meta.get("kb_kinds") is not None:
            # calibrated with bounds support but no key qualified
            self._learn(basekey, meta["base_rows"], "kbounds", False)
        if meta["join_sis"]:
            counts = {si: host[f"sc{j}"]
                      for j, si in enumerate(meta["join_sis"])}
            self._learn(basekey, meta["base_rows"], "stepcaps", counts)

    def _check_fused_extras(self, meta, vals) -> None:
        """Each compaction's true survivor count against its static
        capacity (vals: fetched ints, one per extras slot, in order)."""
        from . import fused as F

        for desc, v in zip(meta.get("extras", ()), vals):
            if desc[0] == "lead" and v > desc[1]:
                raise F.CompactOverflow()
            if desc[0] == "mid" and v > desc[2]:
                raise F.MidCompactOverflow(desc[1], v)

    def _learn_stepcaps(self, basekey, cache, meta) -> None:
        """After a full run that recorded per-join-step survivor counts with
        none learned before (no calibration ran): keep them, so that the
        next execution compacts where a join narrows the spine."""
        counts = meta.get("last_stepcounts")
        if not counts or cache.get(("fused_stepcaps", basekey)):
            return
        self._learn(basekey, meta["base_rows"], "stepcaps", counts)

    # the stage-cache names of the learned capacities, and their capstore
    # key prefixes (utils/capstore.py; the reference's keys)
    _LEARNED = {"kg": ("fused_kg", ""),
                "dense": ("fused_dense", "dense::"),
                "kbounds": ("fused_kbounds", "kbounds::"),
                "stepcaps": ("fused_stepcaps", "stepcaps::"),
                "outcap": ("fused_outcap", "outcap::")}

    def _learn(self, basekey, n, what, value) -> None:
        """Keep a learned capacity of the fused program `basekey` over n base
        rows in session.stage_cache and in the capstore, if one is set. For
        "kbounds", False means none of use (the bounded dense path is dead
        for this plan and these versions)."""
        from ..utils import capstore

        cache = self.session.stage_cache
        name, prefix = self._LEARNED[what]
        stored = value
        if what == "kbounds":
            cache[("fused_kbounds_dead", basekey)] = value is False
            if value is False:
                cache.pop((name, basekey), None)
            else:
                cache[(name, basekey)] = value
                stored = [list(b) if b else None for b in value]
        else:
            cache[(name, basekey)] = value
            if what == "stepcaps":
                stored = {str(k): int(v) for k, v in value.items()}
        capstore.put(prefix + repr((basekey, n)), stored)

    def _load_capacities(self, basekey, n, cache, whats) -> None:
        """Fill what session.stage_cache has not learned for `basekey` from
        the capstore: a fresh session over a store calibrates nothing."""
        from ..utils import capstore

        for what in whats:
            name, prefix = self._LEARNED[what]
            dead = what == "kbounds" and ("fused_kbounds_dead", basekey) in cache
            if (name, basekey) in cache or dead:
                continue
            v = capstore.get(prefix + repr((basekey, n)))
            if v is not None:
                self._keep_learned(cache, what, basekey, v)

    def _keep_learned(self, cache, what, basekey, v) -> None:
        """Put one stored capacity (its JSON form) into the stage cache."""
        name = self._LEARNED[what][0]
        if what == "kbounds":
            if v is False:
                cache[("fused_kbounds_dead", basekey)] = True
            else:
                cache[(name, basekey)] = [tuple(b) if b else None for b in v]
        elif what == "stepcaps":
            cache[(name, basekey)] = {int(k): int(c) for k, c in v.items()}
        elif what == "dense":
            cache[(name, basekey)] = bool(v)
        else:
            cache[(name, basekey)] = int(v)

    def seed_capacities(self, entries: dict) -> None:
        """Put learned capacities, keyed as the capstore keys them
        (utils/capstore.py), into session.stage_cache and into the capstore
        if one is set: the fused programs they belong to then run at these
        sizes with no calibration run (tools/artifact.py)."""
        import ast

        from ..utils import capstore

        by_prefix = sorted(self._LEARNED.items(), key=lambda kv: -len(kv[1][1]))
        for key, v in entries.items():
            what, prefix = next((w, p) for w, (_n, p) in by_prefix
                                if key.startswith(p))
            basekey, _n = ast.literal_eval(key[len(prefix):])
            self._keep_learned(self.session.stage_cache, what, basekey, v)
            capstore.put(key, v)

    def _rebuild(self, basekey, why: str) -> None:
        """A learned capacity was outgrown: the captured programs of
        `basekey` are dropped, the caller runs the program again."""
        for store in self.session.graph_stores():
            store.drop(basekey)
        self._perf_note(f"rebuild {basekey[0]}: {why}")

    def _run_program(self, basekey, variant, material, program, inputs,
                     calibrating=False, device=None):
        """(outputs, meta) of a fused program: replayed from its CUDA graph
        (runtime/exestore.py, captured on the first run at these learned
        capacities, in the graph store of `device`, by default the
        session's), or run as it is called where it calibrates or the
        store's comparison switch is off."""
        from . import exestore

        if exestore.CAPTURE and not calibrating:
            t0 = self._perf_sync()
            got = self.session.graph_store(device).run(
                basekey, variant, material, program, inputs)
            self._perf_note(f"{basekey[0]} from its graph: "
                            f"{(self._perf_sync() - t0) * 1e3:.3f} ms")
            return got
        return program(inputs)

    def _finish_fused_dense(self, op, res, meta) -> VTable:
        """Dense mode: ONE packed fetch of every (domain,)-sized lane and
        the scalars; group slots are extracted and keys decoded on the host,
        and the (small) result lives on the host tier."""
        from . import device as dv
        from . import fused as F

        fetch = {("l", i): a for i, a in enumerate(res["lanes"])}
        for j, c in enumerate(res["extras"]):
            fetch[("x", j)] = c.reshape(1)
        for j, c in enumerate(res["step_counts"]):
            fetch[("s", j)] = c.reshape(1)
        if res["oob"] is not None:
            fetch[("o", 0)] = res["oob"].reshape(1)
        if "err" in res:
            fetch["err"] = res["err"]
        host = dv.fetch_arrays_np(fetch)
        self._check_fused_extras(meta, [
            int(host[("x", j)][0]) for j in range(len(res["extras"]))])
        if res["oob"] is not None and int(host[("o", 0)][0]) > 0:
            raise F.KBoundsOverflow(int(host[("o", 0)][0]))
        sc.raise_data_error(host.get("err", [0])[0], meta.get("err_sources"))
        if meta["join_sis"]:
            meta["last_stepcounts"] = {
                si: int(host[("s", j)][0])
                for j, si in enumerate(meta["join_sis"])}
        lanes = [host[("l", i)] for i in range(len(res["lanes"]))]
        present = lanes[0]
        radices = meta["radices"]

        def cpu_col(t, data_np, valid_np, dictionary=None):
            return SCol(t, np.asarray(data_np),
                        None if valid_np is None else np.asarray(valid_np),
                        dictionary)

        if op.group_by:
            slots_np = np.flatnonzero(present > 0)
            g = len(slots_np)
            if g == 0:
                return VTable({c.cid: _empty_scol(c.type)
                               for c in op.output_cols()}, 0)
            rem = slots_np
            codes = []
            for r in reversed(radices):
                codes.append(rem % r)
                rem = rem // r
            codes.reverse()
            agg_cols: dict[int, SCol] = {}
            offsets = meta.get("key_offsets") or [None] * len(op.group_by)
            for pos, cid in enumerate(op.group_by):
                ktype, kdict, knullable = meta["key_templates"][pos]
                code = codes[pos]
                valid = None
                if knullable:
                    # the NULL slot is the radix's last code, one past a
                    # dictionary's end: the NULL row keeps code 0
                    valid = code != (radices[pos] - 1)
                    code = np.where(valid, code, 0)
                if offsets[pos] is not None:
                    code = code + offsets[pos]  # bounded codes: value - kmin
                agg_cols[cid] = cpu_col(
                    ktype, code.astype(np.dtype(np_dtype(ktype))), valid, kdict)
            sel = slots_np
        else:
            g = 1
            agg_cols = {}
            sel = slice(None)
        idx = 1
        for spec in op.aggs:
            if spec.out.cid in meta["agg_limbs"] | meta.get("agg_exact",
                                                            set()):
                from ..ops import decwide

                # a wide sum: a limb pair, or an exact object total (the
                # out-of-core combine) beside a placeholder
                tot = lanes[idx][sel]
                if spec.out.cid in meta["agg_limbs"]:
                    tot = decwide.combine_limbs(tot, lanes[idx + 1][sel])
                val = decwide.demote_if_possible(tot)
                cnt = lanes[idx + 2][sel]
                idx += 3
            else:
                val, cnt = lanes[idx][sel], lanes[idx + 1][sel]
                idx += 2
            agg_cols[spec.out.cid] = self._finish_fused_agg(
                spec, val, cnt, cpu_col, meta["agg_dicts"].get(spec.out.cid))
        out = {c.cid: agg_cols[c.cid] for c in op.group_cols}
        for spec in op.aggs:
            out[spec.out.cid] = agg_cols[spec.out.cid]
        return VTable(out, g)

    def _finish_fused_general(self, op, res, meta) -> VTable:
        """General mode: ONE small fetch (group count, compaction survivor
        counts, step counts, wide-sum limb flag), then the kg-slot lanes are
        sliced to the group count ON THE DEVICE: group results never round
        trip through the host."""
        from . import device as dv
        from . import fused as F

        lanes = res["lanes"]
        limb_slots = []  # (hi, lo) lane positions of wide sums
        i = sum(1 + (1 if t[2] else 0) for t in meta["key_templates"])
        for spec in op.aggs:
            if spec.out.cid in meta["agg_limbs"]:
                limb_slots.append(i)
                i += 3
            else:
                i += 2
        fetch = {"g": res["g"]}
        if limb_slots:
            # wide sums combine exactly into one int64 unless a group's high
            # limb leaves the safe band; checked on the device (slots past
            # the group count hold gather garbage and are masked) and
            # fetched with the scalars
            rows_ok = (torch.arange(lanes[0].shape[0], device=lanes[0].device)
                       < res["g"])
            flag = torch.zeros((), dtype=torch.bool, device=lanes[0].device)
            for hi_s in limb_slots:
                flag = flag | (((lanes[hi_s].abs() >> 30) > 0) & rows_ok).any()
            fetch["limbflag"] = flag
        scalars = self._fetch_fused_scalars(res, meta, fetch)
        g = scalars["g"]
        if g > meta["kg"]:
            raise F.CapacityOverflow(g)
        sc.raise_data_error(scalars["err"], meta.get("err_sources"))
        if g == 0:
            return VTable({c.cid: _empty_scol(c.type, lanes[0] if lanes else None)
                           for c in op.output_cols()}, 0)
        limb_overflow = bool(scalars.get("limbflag", 0))
        # a graph's lanes hold until the next replay (runtime/exestore.py)
        sliced = [a[:g].clone() if meta.get("from_graph") else a[:g]
                  for a in lanes]

        def dev_col(t, data, valid, dictionary=None):
            return SCol(t, data, valid, dictionary)

        agg_cols: dict[int, SCol] = {}
        i = 0
        for pos, cid in enumerate(op.group_by):
            ktype, kdict, knull = meta["key_templates"][pos]
            data = sliced[i]
            i += 1
            valid = None
            if knull:
                valid = sliced[i]
                i += 1
            agg_cols[cid] = dev_col(ktype, data, valid, kdict)
        for spec in op.aggs:
            if spec.out.cid in meta["agg_limbs"]:
                hi, lo, cnt = sliced[i], sliced[i + 1], sliced[i + 2]
                i += 3
                if limb_overflow:
                    # pathological magnitude: exact host path (object ints)
                    from ..ops import decwide

                    h = dv.fetch_arrays_np({0: hi, 1: lo, 2: cnt})
                    val = decwide.demote_if_possible(
                        decwide.combine_limbs(h[0], h[1]))
                    valid = np.asarray(h[2]) > 0
                    if not is_obj(val):
                        val, valid = be.like(val, hi), be.like(valid, hi)
                    agg_cols[spec.out.cid] = SCol(
                        spec.out.type, val, valid,
                        meta["agg_dicts"].get(spec.out.cid))
                    continue
                agg_cols[spec.out.cid] = dev_col(
                    spec.out.type, (hi << 32) + lo, cnt > 0,
                    meta["agg_dicts"].get(spec.out.cid))
                continue
            val, cnt = sliced[i], sliced[i + 1]
            i += 2
            agg_cols[spec.out.cid] = self._finish_fused_agg(
                spec, val, cnt, dev_col, meta["agg_dicts"].get(spec.out.cid))
        out = {c.cid: agg_cols[c.cid] for c in op.group_cols}
        for spec in op.aggs:
            out[spec.out.cid] = agg_cols[spec.out.cid]
        return VTable(out, g)

    def _fetch_fused_scalars(self, res, meta, scalars: dict) -> dict:
        """ONE packed fetch of a fused program's named scalars (0-dim or
        1-element tensors) together with each compaction's survivor count
        and the per-step survivor counts. Checks the compactions against
        their capacities, records the step counts in meta, and returns the
        named scalars as ints."""
        from . import device as dv

        fetch = {k: v.reshape(1) for k, v in scalars.items()}
        for j, c in enumerate(res["extras"]):
            fetch[("x", j)] = c.reshape(1)
        for j, c in enumerate(res["step_counts"]):
            fetch[("s", j)] = c.reshape(1)
        if "err" in res:
            fetch["err"] = res["err"]
        host = dv.fetch_arrays_np(fetch)
        self._check_fused_extras(meta, [
            int(host[("x", j)][0]) for j in range(len(res["extras"]))])
        if meta["join_sis"]:
            meta["last_stepcounts"] = {
                si: int(host[("s", j)][0])
                for j, si in enumerate(meta["join_sis"])}
        out = {k: int(host[k][0]) for k in scalars}
        out["err"] = int(host["err"][0]) if "err" in res else 0
        return out

    def _finish_fused_epi(self, op, res, meta) -> VTable:
        """The TopK epilogue's finish: ONE fetch of the scalars (compaction
        survivor counts, step counts, group count, tie count at the
        candidate cutoff, wide-limb flag), then the kk-slot candidate lanes
        sliced to the candidate count on the device. The candidates are a
        proven superset of the true top k under the full sort order: every
        row whose priority reaches the cutoff is one when the tie count is
        at most kk (fused.topk_candidates); otherwise EpiOverflow."""
        from . import fused as F

        e = meta["epi"]
        kk = e["kk"]
        scalars = self._fetch_fused_scalars(
            res, meta, {"g": res["g"], "tie": res["tie"],
                        "limb": res["limbflag"]})
        g = scalars["g"]
        if g > meta["kg"]:
            raise F.CapacityOverflow(g)
        if self.track_tuples is not None:
            # the Aggregate never passes through run() on this path
            self.track_tuples[id(op)] = g
        if scalars["limb"]:
            raise F.EpiOverflow("wide-sum limb overflow")
        if g > kk and scalars["tie"] > kk:
            raise F.EpiOverflow(f"tie overflow at cutoff ({scalars['tie']} > {kk})")
        # after the overflows: a rerun sees every group
        sc.raise_data_error(scalars["err"], meta.get("err_sources"))
        return _candidate_vtable(e["templates"], res["lanes"], min(g, kk),
                                 bool(meta.get("from_graph")))

    def _finish_fused_agg(self, spec, val, cnt, make_col, dictionary) -> SCol:
        t = spec.out.type
        if spec.fn in ("count", "count_star"):
            return make_col(t, be.astype(val, np.int64), None)
        return make_col(t, val, cnt > 0, dictionary)

    # ------------------------------------------------------- fused chain
    def _try_fused_chain(self, op, epi=None):
        """Run a Scan -> [Select/Map/dimension-Join]* chain with no
        aggregate on top as ONE program emitting the surviving rows of every
        output column, or return None (the eager operators then run).

        The materialize-terminated counterpart of _try_fused_agg: the eager
        chain pays one or more host syncs per join. It shares the spine walk,
        the dimension-join preps, the lead and learned post-join compactions
        and the per-step survivor counts (fused.run_spine). Its tail is one
        of three: the compacted tail gathers the output columns at the
        survivors' positions (compact_positions, then one sorted gather) into
        a learned capacity, 4x the power of two of the survivor count that a
        calibration run learns; where the survivors exceed half the spine it
        emits full-width masked lanes and the finish runs one eager
        select_mask; with a TopK epilogue (`epi`, see _try_fused_topk) it
        emits the top kk candidate rows instead, and the result is the pair
        (vtable, applied)."""
        from ..plan.serial import plan_key
        from . import device as dv
        from . import fused as F

        want_pair = epi is not None  # also when the epilogue declines below

        def _ret(vt, applied):
            return (vt, applied) if want_pair else vt

        if dv.get_mesh() is not None:
            return None  # mesh execution routes through the sharded paths
        if self._in_fused_chain or _has_iterref(op):
            return None
        steps, cur = self._walk_spine(op)
        if not any(st[0] == "join" for st in steps):
            return None
        if not isinstance(cur, L.Scan):
            return None  # materialized bases recurse here on their own top
        if _host_only_exprs(_program_exprs(steps, {}, cur.restrictions)):
            return None  # a UDF runs on the host (see _try_fused_agg)
        entry = self.session.catalog.get_table(cur.table)
        if entry is None or entry.storage.num_rows == 0:
            return None
        versions = tuple(sorted(self._subtree_versions(op)))
        basekey = ("fused_chain", plan_key(op), versions)
        cache = self.session.stage_cache
        if cache.get(basekey) == "eager":
            return None
        if epi is not None and _host_only_exprs(_epi_exprs(epi)):
            # the chain's epilogue evaluates its Map steps in the program:
            # a UDF among them declines the chain for the plan and these
            # versions, as the reference's trace failure does
            cache[basekey] = "eager"
            return None
        if epi is not None and cache.get(("fused_epi_decline", basekey)):
            epi = None
        dev_t = self.session.device_table(cur.table)
        n = dev_t["__num_rows__"]
        if n < dv.SMALL_ROWS:
            return None  # host tier: the eager numpy operators run
        base_cols = [(c.cid, dev_t[c.name]) for c in cur.cols]
        if any(not be.is_torch(t.data) or (t.valid is not None
                                           and not be.is_torch(t.valid))
               for _cid, t in base_cols):
            return None  # host-only (wide-decimal) columns stay eager

        out_cids = [c.cid for c in op.output_cols()]
        # columns any step consumes (the payloads the preps carry)
        needed = set(out_cids)
        for st in steps:
            if st[0] == "sm":
                if isinstance(st[1], L.Select):
                    needed |= E.used_cols(st[1].predicate)
                else:
                    for _info, e in st[1].computed:
                        needed |= E.used_cols(e)
            elif st[1].predicate is not None:
                needed |= E.used_cols(st[1].predicate)
        snames = set(entry.storage.sorted_cols)
        sorted_cids = frozenset(c.cid for c in cur.cols if c.name in snames)
        prep_key = ("fused_prep", basekey)
        join_preps = cache.get(prep_key)
        if join_preps is None:
            join_preps = {}
            # the build sides run eagerly; a chain among them stays eager
            self._in_fused_chain = True
            try:
                for si, st in enumerate(steps):
                    if st[0] != "join":
                        continue
                    prep = self._prep_fused_join(st[1], st[2], st[3], needed,
                                                 sorted_cids)
                    if prep is None:
                        cache[basekey] = "eager"
                        return None
                    join_preps[si] = prep
            finally:
                self._in_fused_chain = False
            self._propagate_sorted_probe(join_preps, sorted_cids)
            cache[prep_key] = join_preps
        if _host_only_exprs(_program_exprs(steps, join_preps, ())):
            cache[basekey] = "eager"  # a UDF in a join step's probe keys
            return None

        self._load_capacities(basekey, n, cache, ("outcap", "stepcaps"))
        spine = self._plan_spine(steps, join_preps, cur, entry,
                                 cur.restrictions, n, basekey, cache, out_cids)
        # the output capacity: learned by a calibration run (kept in
        # session.stage_cache and, with system.capstore_dir set, across
        # processes)
        outcap_obs = cache.get(("fused_outcap", basekey))
        meta = {"calibrating": outcap_obs is None, "do_compact": False}
        if outcap_obs is not None:
            final_n = spine["compact_k"] or n
            for si in spine["join_sis"]:
                final_n = spine["mid_caps"].get(si, final_n)
            meta["outcap"] = 1 << (max(4 * outcap_obs, dv.SMALL_ROWS)
                                   - 1).bit_length()
            meta["do_compact"] = meta["outcap"] <= final_n // 2
        dev = self.session.device

        def program(_static):
            m = dict(meta, base_rows=n)
            with be.no_host_reads(), sc.deferred_errors() as errs:
                r = self._fused_chain_program(
                    steps, join_preps, base_cols, cur.restrictions, n, dev, m,
                    spine=spine, out_cids=out_cids, epi=epi)
            m["err_sources"] = errs.sources
            return _with_err_out(r, errs), m

        from . import exestore

        material = (exestore.signature(base_cols),
                    exestore.signature(join_preps), spine["compact_k"],
                    tuple(sorted(spine["mid_caps"].items())),
                    meta.get("outcap"), meta["do_compact"], dv.SMALL_ROWS, n)
        variant = ("epi", plan_key(epi["node"])) if epi is not None else None
        try:
            # the calibration run (no output capacity yet) is not captured
            res, meta = self._run_program(basekey, variant, material, program,
                                          [], calibrating=meta["calibrating"])
        except (F.NotDense, be.HostRead, NotImplementedError):
            # a column or expression the program cannot carry on the device
            # (the reference's trace fails on the same ones)
            cache[basekey] = "eager"
            return None
        try:
            out = self._finish_fused_chain(op, res, meta, basekey, cache)
            if out is None:  # calibrated: run again at the learned sizes
                return self._try_fused_chain(op, epi)
            return _ret(out, meta.get("epi") is not None)
        except F.CompactOverflow:
            cache[("fused_nocompact", basekey)] = True
            self._rebuild(basekey, "lead compaction outgrown")
            return self._try_fused_chain(op, epi)
        except F.MidCompactOverflow as mo:
            si_o, v_o = mo.args
            stepcaps = dict(cache.get(("fused_stepcaps", basekey)) or {})
            stepcaps[si_o] = int(v_o)
            self._learn(basekey, n, "stepcaps", stepcaps)
            self._rebuild(basekey, f"step {si_o} cap outgrown ({v_o})")
            return self._try_fused_chain(op, epi)
        except F.CapacityOverflow as ce:
            self._learn(basekey, n, "outcap", ce.args[0])
            self._rebuild(basekey, f"output capacity outgrown ({ce.args[0]})")
            return self._try_fused_chain(op, epi)
        except F.EpiOverflow:
            cache[("fused_epi_decline", basekey)] = True
            self._rebuild(basekey, "TopK epilogue declined")
            return self._try_fused_chain(op, epi)
        # No counterpart of the reference's retry without Pallas kernels
        # (_GatherOverflow): see _try_fused_agg.

    def _fused_chain_program(self, steps, join_preps, base_cols,
                             base_restrictions, n, dev, meta, *, spine,
                             out_cids, epi) -> dict:
        """The fused chain itself, nothing read back to the host: the
        spine, then the survivor count and (past calibration) one of the
        three tails. Returns its outputs by name and fills `meta`."""
        from . import fused as F

        env, mask, cur_n, out = F.run_spine(
            steps, join_preps, base_cols, base_restrictions, n, dev, meta,
            **spine)
        mask = (torch.ones((cur_n,), dtype=torch.bool, device=dev)
                if mask is None else F.on_device(mask, cur_n, dev))
        meta["rows"] = cur_n
        out["survivors"] = mask.sum(dtype=torch.int64)
        if meta["calibrating"]:
            return out
        if epi is not None:
            # in-program TopK over the surviving rows: the top kk candidates
            # by the primary sort key, exact by the tie count as in the
            # aggregate's epilogue
            for m in epi["maps"]:
                for info, e in m.computed:
                    env[info.cid] = sc._bcast(sc.eval_expr(e, env), cur_n)
                sc.checked_all(env, [info.cid for info, _e in m.computed],
                               mask, cur_n)
            k0 = epi["node"].keys[0]
            prio = keymod.topk_priority(env[k0.cid], k0.ascending,
                                        k0.nulls_first, mask)
            if prio is None:
                raise F.NotDense("chain topk: no order image")
            kk = min(epi["kk"], cur_n)
            cand, out["tie"] = F.topk_candidates(
                F.dev_lane(prio, cur_n, dev), kk, mask)
            out["lanes"], meta["templates"] = F.take_candidates(
                env, epi["out_cids"], cand, cur_n, dev)
            meta["epi"] = {"kk": kk, "k": epi["k"]}
            return out
        lanes = {}
        meta["templates"] = []
        for cid in out_cids:
            c = sc._bcast(env[cid], cur_n)
            lanes[cid] = SCol(c.type, F.dev_lane(c.data, cur_n, dev),
                              None if c.valid is None
                              else F.dev_lane(c.valid, cur_n, dev),
                              c.dictionary)
            meta["templates"].append(
                (cid, c.type, c.dictionary, c.valid is not None))
        if meta["do_compact"]:
            # the survivors' positions and ONE sorted gather of every lane;
            # the count is compact_positions', exact even past the capacity
            lanes, _m, out["survivors"] = F.compact(
                lanes, mask, meta["outcap"], set(out_cids), dev)
        else:
            out["mask"] = mask
        out["lanes"] = [p for cid in out_cids
                        for p in (lanes[cid].data, lanes[cid].valid)
                        if p is not None]
        return out

    def _finish_fused_chain(self, op, res, meta, basekey, cache):
        """ONE fetch of the scalars (compaction survivor counts, step
        counts, the chain's survivors, the tie count of an epilogue), then
        the chain's rows: a calibration run learns the output capacity and
        the step counts and returns None; the candidates of an epilogue and
        the compacted lanes are sliced on the device; the full-width lanes
        go through one select_mask. An outgrown output capacity raises
        CapacityOverflow with the true count."""
        from . import fused as F

        named = {"survivors": res["survivors"]}
        if meta.get("epi") is not None:
            named["tie"] = res["tie"]
        scalars = self._fetch_fused_scalars(res, meta, named)
        survivors = scalars["survivors"]
        # before anything is learned
        sc.raise_data_error(scalars["err"], meta.get("err_sources"))
        if meta["calibrating"]:
            from ..utils import compilestats

            compilestats.add("calibrations")
            n = meta["base_rows"]
            self._learn(basekey, n, "outcap", survivors)
            if meta["join_sis"]:
                self._learn(basekey, n, "stepcaps", meta["last_stepcounts"])
            return None
        if meta.get("epi") is not None:
            kk = meta["epi"]["kk"]
            if survivors > kk and scalars["tie"] > kk:
                raise F.EpiOverflow(
                    f"tie overflow at cutoff ({scalars['tie']} > {kk})")
            rows = min(survivors, kk)
        elif meta["do_compact"]:
            if survivors > meta["outcap"]:
                raise F.CapacityOverflow(survivors)
            rows = survivors
        else:
            rows = None
        self._learn_stepcaps(basekey, cache, meta)
        if self.track_tuples is not None:
            self.track_tuples[id(op)] = survivors
        # a graph's outputs hold until the next replay (runtime/exestore.py):
        # the rows that leave as device tensors are copied out
        own = bool(meta.get("from_graph"))
        if rows is not None:
            return _candidate_vtable(meta["templates"], res["lanes"], rows,
                                     own)
        vt = _candidate_vtable(meta["templates"], res["lanes"], meta["rows"])
        out = vt.select_mask(res["mask"])
        if own and out is vt:  # every row survived: the lanes themselves
            out = _candidate_vtable(meta["templates"], res["lanes"],
                                    meta["rows"], True)
        return out

    # ------------------------------------------------------------- aggregate
    def _run_aggregate(self, op: L.Aggregate) -> VTable:
        fused = self._try_fused_agg(op)
        if fused is not None:
            return fused
        vt = self.run_sharded(op.child)
        sharded = self._try_sharded_agg(op, vt)
        if sharded is not None:
            return sharded
        vt = self._gather_input(vt).dense()
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

        kind = op.kind
        lvt = self.run_sharded(op.left)
        rvt = self.run_sharded(op.right)
        lcids = {c.cid for c in op.left.output_cols()}
        rcids = {c.cid for c in op.right.output_cols()}
        if dv.is_sharded(lvt) or dv.is_sharded(rvt):
            # a side held on the mesh: the sharded join takes it as it is;
            # where that declines, each such side leaves the mesh whole
            lkeys, rkeys, null_safe = extract_equi_keys(op.predicate, lcids,
                                                        rcids)
            if (lkeys and op.null_aware is None and kind in (
                    "inner", "semi", "anti", "left", "mark", "single",
                    "full")):
                sharded = self._try_sharded_join(op, kind, lvt, rvt, lkeys,
                                                 rkeys, null_safe)
                if sharded is not None:
                    self._perf_note(f"join strategy=sharded kind={kind} "
                                    f"nl={lvt.num_rows} nr={rvt.num_rows}")
                    return sharded
            lvt, rvt = self._gather_input(lvt), self._gather_input(rvt)
        lvt, rvt = dv.align_devices(lvt, rvt)
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

        lkeys, rkeys, null_safe = extract_equi_keys(op.predicate, lcids, rcids)

        if not lkeys:
            lvt, rvt = lvt.dense(), rvt.dense()
            nl, nr = lvt.num_rows, rvt.num_rows
            # no equi keys: nested loop via cross-product pairs; larger
            # inputs go through the blockwise nested loop, so that the
            # pair buffers never exceed 2^26
            if nl * nr > (1 << 26):
                return self._chunked_nonequi_join(op, kind, lvt, rvt)
            pidx, bidx, total = _all_pairs(nl, nr, _first_tensor(lvt, rvt))
        else:
            def _eval_keys():
                lk, rk, codes = [], [], []
                for le, re_ in zip(lkeys, rkeys):
                    a = sc._bcast(sc.eval_expr(le, lvt.cols), nl)
                    b = sc._bcast(sc.eval_expr(re_, rvt.cols), nr)
                    codes += [sc.first_error(c.err, None, len(c))
                              for c in (a, b) if c.err is not None]
                    a, b = _unify_string_keys(sc.without_err(a),
                                              sc.without_err(b))
                    lk.append(a)
                    rk.append(b)
                # every key of both sides: one reduction each, one read
                sc.raise_data_errors(codes, None, 1)
                return lk, rk

            if (kind in ("inner", "semi", "anti", "left", "mark", "single",
                         "full")
                    and op.null_aware is None):
                sharded = self._try_sharded_join(op, kind, lvt, rvt, lkeys,
                                                 rkeys, null_safe)
                if sharded is not None:
                    self._perf_note(f"join strategy=sharded kind={kind} "
                                    f"nl={nl} nr={nr}")
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

    def _chunked_nonequi_join(self, op, kind, lvt: VTable, rvt: VTable) -> VTable:
        """Blockwise nested loop for non-equi joins whose full pair matrix
        exceeds the 2^26 buffer bound: the left side processes in chunks of
        C = 2^26 / nr rows against the whole right side, so every kind's
        per-left-row decisions stay exact (reference: the morsel-driven
        nested-loop join handles any size; this matches that without ever
        materializing more than one chunk of pairs)."""
        nl, nr = lvt.num_rows, rvt.num_rows
        ref = _first_tensor(lvt, rvt)
        C = max(1, (1 << 26) // max(nr, 1))
        parts: list[VTable] = []
        matched_r = be.full(nr, False, jnp.bool_, ref)  # full: right matched
        chunk_kind = "left" if kind == "full" else kind
        for lo in range(0, nl, C):
            hi = min(lo + C, nl)
            # monotone positions: the left chunk's gather is a sorted one
            idx = be.iota(hi - lo, jnp.int64, ref) + lo
            lch = lvt.take(idx, hi - lo, monotone=True)
            pidx, bidx, total = _all_pairs(hi - lo, nr, ref)
            if kind == "full":
                env = _pair_env(lch, rvt, pidx, bidx, op.predicate)
                mask = jnp.broadcast_to(sc.truth_mask(sc.checked(
                    sc.eval_expr(op.predicate, env), None, total)), (total,))
                matched_r = matched_r | joinops.matched_flags(bidx, mask, nr)
            parts.append(self._finish_pairs_join(
                op, chunk_kind, lch, rvt, pidx, bidx, total))
        self.last_nonequi_chunks = len(parts)
        out = parts[0]
        ocols = op.output_cols()
        for p in parts[1:]:
            out = _vconcat(out, p, ocols)
        if kind == "full":
            n_ur = int(jnp.sum(~matched_r))
            if n_ur:
                (ui,) = jnp.nonzero(~matched_r, size=n_ur)
                cols = {cid: _null_scol(lvt.col(cid), n_ur) for cid in lvt.cols}
                for c in op.right.output_cols():
                    cols[c.cid] = rvt.col(c.cid).take(ui)
                out = _vconcat(out, VTable(cols, n_ur), ocols)
        return out

    def _finish_pairs_join(self, op, kind, lvt, rvt, pidx, bidx, total) -> VTable:
        """Evaluate the full predicate on candidate pairs and assemble the
        join result for every join kind."""
        nl, nr = lvt.num_rows, rvt.num_rows
        ref = _first_tensor(lvt, rvt)
        if total > 0 and op.predicate is not None:
            env = _pair_env(lvt, rvt, pidx, bidx, op.predicate)
            # raised on the candidate pairs only (a join filter)
            mask = sc.truth_mask(sc.checked(
                sc.eval_expr(op.predicate, env), None, total))
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
        outer_c = sc.checked(sc.eval_expr(outer_e, lvt.cols), None,
                             lvt.num_rows)
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
def _topk_rows(op: L.TopK, vt: VTable) -> VTable:
    """The TopK's rows of a dense vt: a stable sort under the full key
    order, then the offset and limit."""
    if vt.num_rows == 0:
        return vt
    perm = keymod.sort_permutation(
        [(vt.col(k.cid), k.ascending, k.nulls_first) for k in op.keys],
        vt.num_rows)
    lo = min(op.offset, vt.num_rows)
    hi = min(op.offset + op.n, vt.num_rows)
    return vt.take(perm[lo:hi], hi - lo)


# the methods that raise a fused program's data error, after its packed
# fetch (and before anything is learned from the run)
FETCH_FINISHES = ("_finish_fused_dense", "_finish_fused_general",
                  "_finish_fused_epi", "_finish_fused_chain",
                  "_learn_calibration")


def _with_err_out(out: dict, errs) -> dict:
    """A fused program's outputs with its data errors' code (sc.
    deferred_errors) as the scalar "err", where a consumer could fail."""
    if errs.code is not None:
        out["err"] = errs.code
    return out


def _rebind_cols(base_cols, tensors):
    """base_cols ((cid, SCol) pairs) with their data and validity tensors
    replaced, in order, by `tensors` (a captured program's static inputs)."""
    it = iter(tensors)
    return [(cid, SCol(c.type, next(it),
                       None if c.valid is None else next(it), c.dictionary))
            for cid, c in base_cols]


def _candidate_vtable(templates, lanes, rows: int, own=False) -> VTable:
    """A fused program's output lanes, sliced to their first `rows` slots on
    the device, as a VTable (templates: (cid, type, dictionary, has
    validity) per column, the validity lane after the data lane); copies of
    the slices with `own` (lanes of a CUDA graph, which its next replay
    overwrites)."""
    if rows == 0:
        return VTable({cid: _empty_scol(t, lanes[0] if lanes else None)
                       for cid, t, _d, _v in templates}, 0)
    cols = {}
    it = iter(a[:rows].clone() if own else a[:rows] for a in lanes)
    for cid, t, d, has_valid in templates:
        data = next(it)
        cols[cid] = SCol(t, data, next(it) if has_valid else None, d)
    return VTable(cols, rows)


def _has_iterref(node) -> bool:
    """True when the plan reads an Iterate's working table. Its result
    changes every round under the same plan and table versions, so the
    caches keyed by those (the fused programs' preps and learned
    capacities, shared subtrees) must not hold it: the fused programs
    decline such plans and a shared subtree over it is not kept. (The
    reference keys them the same way and returns the first round's build
    side in every later round once the tables are on the device tier.)"""
    if isinstance(node, L.IterRef):
        return True
    if isinstance(node, L.Tmp) and _has_iterref(node.holder.plan):
        return True
    return any(_has_iterref(c) for c in node.children())


def _udf_in_exprs(exprs) -> bool:
    """True when any of the expressions calls a user-defined function."""
    return any(isinstance(x, Call) and x.op.startswith("udf:")
               for e in exprs if e is not None for x in E.walk(e))


def _host_only_exprs(exprs) -> bool:
    """True when any of the expressions calls a user-defined function or
    computes on the exact host path (sc.goes_exact): a fused program
    declines such a plan on the host, before it runs."""
    return any((isinstance(x, Call) and x.op.startswith("udf:"))
               or (isinstance(x, (Call, Cast)) and sc.goes_exact(x))
               for e in exprs if e is not None for x in E.walk(e))


def _program_exprs(steps, join_preps, restrictions) -> list:
    """The expressions a fused program evaluates itself: the base scan's
    restrictions, the spine's Select predicates and Map expressions, and
    each join step's probe keys and residual conjuncts (its build side runs
    eagerly, before the program). Group keys and aggregate arguments are
    column references into these."""
    out = list(restrictions)
    for si, st in enumerate(steps):
        if st[0] == "sm":
            if isinstance(st[1], L.Select):
                out.append(st[1].predicate)
            else:
                out.extend(e for _info, e in st[1].computed)
            continue
        p = join_preps.get(si) or {}
        out += [p.get("probe_expr"), p.get("probe_expr2")]
        out += list(p.get("residual") or ())
    return out


def _epi_exprs(epi) -> list:
    """The expressions of a TopK epilogue's Map steps."""
    return [e for m in epi["maps"] for _info, e in m.computed]


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


def _on(x, device, n: int) -> torch.Tensor:
    """A global column (a tensor, or a host array: uint64 hashes travel as
    their int64 bit patterns) as an n-row tensor on `device`, the form the
    mesh's shard_put splits into shards."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a)
        x = torch.from_numpy(a)
    x = x.to(device)
    if tuple(x.shape) != (n,):
        x = x.broadcast_to((n,)).contiguous()
    return x


def _clone_out(v):
    """A copy of a program's output (a tensor, a list of them, or
    another value)."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (list, tuple)):
        return type(v)(_clone_out(x) for x in v)
    return v


def _mesh_of(vt: VTable):
    """The mesh of a table held on it (its first Sharded value's)."""
    from ..parallel.mesh import Sharded

    for x in [vt.row_valid] + [p for c in vt.cols.values()
                               for p in (c.data, c.valid)]:
        if isinstance(x, Sharded):
            return x.mesh
    raise ExecError("not a table held on the mesh")


def _local_len(vt: VTable) -> int:
    return vt.num_rows // _mesh_of(vt).size


def _views(vt: VTable) -> list:
    """A table held on the mesh as one VTable a local position: its
    shards' tensors (host columns sliced to the position's rows), its
    selection vector's shard."""
    from ..parallel.mesh import Sharded

    mesh = _mesh_of(vt)
    L = vt.num_rows // mesh.size

    def piece(x, i, s):
        if x is None:
            return None
        if isinstance(x, Sharded):
            return x.shards[i]
        return x[s * L:(s + 1) * L]

    out = []
    for i, s in enumerate(mesh.local_positions):
        cols = {cid: SCol(c.type, piece(c.data, i, s), piece(c.valid, i, s),
                          c.dictionary) for cid, c in vt.cols.items()}
        out.append(VTable(cols, L, row_valid=piece(vt.row_valid, i, s)))
    return out


def _raise_mesh_errors(mesh, codes: list) -> None:
    """Raise the data error of the per-position codes (sc.first_error's,
    beside their positions): reduced over the mesh with one read, the same
    on every process."""
    if codes:
        from ..parallel import mesh as msh

        sc.raise_data_error(be.to_host(msh.preduce(mesh, codes, "max"))[0])


def _shard_of(x, ref: torch.Tensor, n: int) -> torch.Tensor:
    """A per-position value (a tensor, a host array or a scalar) as an
    n-row tensor beside `ref`."""
    if not isinstance(x, torch.Tensor):
        x = be.like(np.asarray(x), ref)
    x = x.to(ref.device)
    if tuple(x.shape) != (n,):
        x = x.broadcast_to((n,)).contiguous()
    return x


def _view_ref(v: VTable, mesh, i: int) -> torch.Tensor:
    """A tensor on a view's position's device (for placing host values)."""
    for c in v.cols.values():
        if isinstance(c.data, torch.Tensor):
            return c.data
    if isinstance(v.row_valid, torch.Tensor):
        return v.row_valid
    return torch.empty(0, device=mesh.devices[mesh.local_positions[i]])


def _live_rows(row_valid) -> int:
    """The live rows under a selection vector (Sharded: over every
    position)."""
    from ..parallel import mesh as msh

    if isinstance(row_valid, msh.Sharded):
        return int(msh.to_host(row_valid.mesh, [
            s.sum(dtype=torch.int64).reshape(1)
            for s in row_valid.shards]).sum())
    return int(jnp.sum(row_valid))


def _heavy_hitters_sharded(h, valid, n_ax: int) -> torch.Tensor:
    """The hashes that take more than 1 / (2 n_ax) of a sample of h's live
    rows (every max(1, rows / 2^16)-th global row of the Sharded h): the
    keys a skewed join splits. Every process reads the same sample. The
    sample skips dead rows, which the reference's sample reads."""
    from ..parallel.shuffle import take_rows

    rows = h.mesh.size * h.local_len
    idx = np.arange(0, rows, max(1, rows // (1 << 16)), dtype=np.int64)
    idx_dev = torch.from_numpy(idx).to(h.shards[0].device)
    samp = take_rows(h, idx, idx_dev)
    if valid is not None:
        samp = samp[take_rows(valid, idx, idx_dev).to(samp.device)]
    samp = be.to_host(samp)
    dev = h.shards[0].device
    if samp.size == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    vals_u, cnts_u = np.unique(samp, return_counts=True)
    heavy = vals_u[cnts_u / samp.size > 1.0 / (2 * n_ax)]
    return torch.from_numpy(np.ascontiguousarray(heavy)).to(dev)


def _stay_local(mesh, side: dict, heavy: torch.Tensor) -> None:
    """The rows of `side` (per-position lists of the sharded join) whose
    hash is hot stay on their own position."""
    for i, s in enumerate(mesh.local_positions):
        hot = torch.isin(side["h"][i], heavy.to(side["h"][i].device))
        d = side["dest"][i]
        side["dest"][i] = torch.where(hot, torch.full_like(d, s), d)


def _replicate_hot(mesh, side: dict, heavy: torch.Tensor, ln: int) -> int:
    """Each position appends its rows of `side` whose hash is hot, once for
    every destination position (the other side's hot rows stay local, so
    each pair forms on one position); every position appends the same
    count of rows, its own padded with dead ones. Returns the new local
    length."""
    from ..parallel import mesh as msh

    from ..ops import pgather

    n_ax = mesh.size
    hots = [torch.isin(h, heavy.to(h.device)) for h in side["h"]]
    counts = msh.to_host(mesh, [x.sum(dtype=torch.int64).reshape(1)
                                for x in hots]).reshape(-1)  # one read
    width = int(counts.max())
    if width == 0:
        return ln
    for i, (s, hot) in enumerate(zip(mesh.local_positions, hots)):
        dev = hot.device
        # the hot rows' positions, padded to `width` (K3: no read back)
        _cnt, idx = pgather.nonzero_positions(hot, width)
        idx = torch.as_tensor(idx, device=dev).to(torch.int64).clamp(0, ln - 1)
        live = (torch.arange(width, device=dev) < int(counts[s])).repeat(n_ax)
        rep = idx.repeat(n_ax)
        v0 = side["valid"][i]
        if v0 is None:
            v0 = torch.ones((ln,), dtype=torch.bool, device=dev)
        side["h"][i] = torch.cat([side["h"][i], side["h"][i][rep]])
        if "ko" in side:
            side["ko"][i] = torch.cat([side["ko"][i], side["ko"][i][rep]])
        side["arrs"][i] = [torch.cat([a, a[rep]]) for a in side["arrs"][i]]
        side["dest"][i] = torch.cat([side["dest"][i], torch.repeat_interleave(
            torch.arange(n_ax, dtype=torch.int32, device=dev), width)])
        side["valid"][i] = torch.cat([v0 & ~hot, v0[rep] & live])
    return ln + n_ax * width


class _WideShip(Exception):
    """A wide-decimal value beyond 127 bits cannot limb-split for the mesh
    exchange; callers fall back to the single-device path."""


def _wide_sum(spec: L.AggSpec) -> bool:
    """A sum whose total may pass int64 (a wide DECIMAL, such as a BIGINT's
    sum): summed as two 32-bit limbs and recombined exactly."""
    return (spec.fn == "sum" and spec.out.type.kind == K.DECIMAL
            and dec_is_wide(spec.out.type))


def _obj_to_limbs(a: np.ndarray):
    """Host object array of Python ints -> (hi, lo) int64 limb arrays that
    CAN ship over the mesh (the reference's full i128 range; SQL
    decimal(38) needs 127 bits)."""
    try:
        hi = np.array([int(x) >> 64 for x in a], dtype=np.int64)
    except OverflowError as e:
        raise _WideShip() from e
    lo = np.array([int(x) & 0xFFFFFFFFFFFFFFFF for x in a],
                  dtype=np.uint64).view(np.int64)
    return hi, lo


def _limbs_to_obj(hi, lo) -> np.ndarray:
    hi = be.to_host(hi).astype(np.int64)
    lo = be.to_host(lo).astype(np.int64).view(np.uint64)
    return np.array([(int(h) << 64) | int(lw) for h, lw in zip(hi, lo)],
                    dtype=np.object_)


def _flatten_vt(vt: VTable):
    """VTable -> (layout, flat array list) for the shuffle exchange; rebuild
    with _rebuild_vt from the same layout. Wide-decimal object columns
    (host Python ints) limb-split into two int64 arrays so that they can
    ship; raises _WideShip when a value exceeds 127 bits."""
    layout, arrays = [], []
    for cid, c in vt.cols.items():
        wide = is_obj(c.data)
        layout.append((cid, c.valid is not None, wide))
        if wide:
            arrays.extend(_obj_to_limbs(c.data))
        else:
            arrays.append(c.data)
        if c.valid is not None:
            arrays.append(c.valid)
    return layout, arrays


def _rebuild_vt(src: VTable, layout, arrays, n: int) -> VTable:
    cols = {}
    i = 0
    for cid, hasv, wide in layout:
        t = src.cols[cid]
        if wide:
            data = _limbs_to_obj(arrays[i], arrays[i + 1])
            i += 2
        else:
            data = arrays[i]
            i += 1
        valid = None
        if hasv:
            valid = be.to_host(arrays[i]) if wide else arrays[i]
            i += 1
        cols[cid] = SCol(t.type, data, valid, t.dictionary)
    return VTable(cols, n)


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
