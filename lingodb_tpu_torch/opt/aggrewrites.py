"""Aggregate-shape rewrites: eager aggregation (groupjoin) + distinct split.

Equivalents of:
- the reference's groupjoin (relalg.groupjoin, RelAlgOps.td:240; detection in
  OptimizeImplementations.cpp:580-660): an Aggregate whose group keys are the
  unique join key of the left side pushes the aggregation into the right side
  BEFORE the join. On an accelerator this turns a duplicate-key materializing join +
  wide grouping into a segment reduction followed by a unique-key lookup —
  the shape the fused single-program pipeline compiles.
- splitting DISTINCT aggregates into a two-level grouping (dedup grouping,
  then plain aggregation), so the heavy dedup level runs through the fused
  join+group program instead of an eager distinct (reference lowers
  count(distinct) via a nested aggregation in RelAlgToSubOp as well).
"""

from __future__ import annotations

from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import Call, ColRef
from ..sql.types import Type


def _max_cid(plan: L.LogicalOp) -> int:
    m = 0
    for node in L.walk_plan(plan):
        for c in node.output_cols():
            m = max(m, c.cid)
        if isinstance(node, L.Map):
            m = max([m] + [ci.cid for ci, _e in node.computed])
        if isinstance(node, L.Tmp):
            m = max(m, _max_cid(node.holder.plan))
    return m


class _Cids:
    def __init__(self, plan):
        self.next = _max_cid(plan) + 1

    def fresh(self, name: str, t: Type) -> L.ColInfo:
        c = L.ColInfo(self.next, name, t)
        self.next += 1
        return c


# ------------------------------------------------------- eager aggregation
_PUSHABLE = ("sum", "count", "count_star", "min", "max")


def eager_aggregation(plan: L.LogicalOp, catalog) -> L.LogicalOp:
    """Aggregate(K, aggs) over Join[inner|left](L, R, lk=rk AND residual(R))
    where K are L columns containing lk, L is unique on lk, and every
    aggregate reads R: push the aggregation into R, then join on the now
    unique key (reference: groupjoin detection,
    OptimizeImplementations.cpp:580-660).

      count/count_star need a post-join fixup: unmatched L rows produce
      NULL -> count is 0 (left join count over NULL-extension) and
      count_star is 1 (the NULL-extended row itself counts)."""
    from .constraints import collect_fds

    cids = _Cids(plan)

    def rec(op: L.LogicalOp) -> L.LogicalOp:
        kids = op.children()
        if kids:
            op = op.replace_children([rec(c) for c in kids])
        if not isinstance(op, L.Aggregate) or not op.group_by:
            return op
        j = op.child
        if not isinstance(j, L.Join) or j.kind not in ("inner", "left"):
            return op
        lcids = {c.cid for c in j.left.output_cols()}
        rcids = {c.cid for c in j.right.output_cols()}
        eqs, residual = [], []
        for c in E.conjuncts(j.predicate):
            if (isinstance(c, Call) and c.op == "eq"
                    and isinstance(c.args[0], ColRef) and isinstance(c.args[1], ColRef)):
                a, b = c.args[0].cid, c.args[1].cid
                if a in lcids and b in rcids:
                    eqs.append((c.args[0], c.args[1]))
                    continue
                if b in lcids and a in rcids:
                    eqs.append((c.args[1], c.args[0]))
                    continue
            residual.append(c)
        if len(eqs) != 1:
            return op
        lk, rk = eqs[0]
        if any(E.used_cols(r) - rcids for r in residual):
            return op
        if not set(op.group_by) <= lcids or lk.cid not in op.group_by:
            return op
        if any(a.distinct or a.fn not in _PUSHABLE for a in op.aggs):
            return op
        if any(a.arg is not None and a.arg not in rcids for a in op.aggs):
            return op
        fds = collect_fds(j.left, catalog)
        if fds.key is None or not fds.key <= fds.expand({lk.cid}):
            return op  # L not unique on the join key

        r_in = L.Select(j.right, E.make_and(residual)) if residual else j.right
        rk_info = next(c for c in j.right.output_cols() if c.cid == rk.cid)
        inner_aggs = []
        fixups = []  # (orig ColInfo, inner ColInfo, fn)
        for a in op.aggs:
            fn, arg = a.fn, a.arg
            if fn == "count_star":
                # count(*) per key over R = count of the (non-null) key rows
                fn, arg = "count", rk.cid
            out_t = a.out.type if a.out.type.nullable else a.out.type.as_nullable()
            ic = cids.fresh(a.out.name, out_t)
            inner_aggs.append(L.AggSpec(ic, fn, arg))
            fixups.append((a.out, ic, a.fn))
        inner = L.Aggregate(r_in, [rk.cid], inner_aggs, [rk_info])
        jkind = "inner" if j.kind == "inner" else "single"
        njoin = L.Join(jkind, j.left, inner,
                       Call("eq", [lk, ColRef(rk.cid, rk_info.type)], Type.bool_(True)))
        computed = []
        for orig, ic, fn in fixups:
            ref = ColRef(ic.cid, ic.type)
            if fn in ("count", "count_star"):
                # inner join: matches guarantee a value, default never fires.
                # left join: unmatched L rows must count 0 (count over the
                # NULL extension) resp. 1 (count_star counts the row itself)
                dflt = 1 if (fn == "count_star" and j.kind == "left") else 0
                e = Call("coalesce", [ref, E.Const(dflt, orig.type)], orig.type)
            else:
                e = ref if ic.type == orig.type else __cast(ref, orig.type)
            computed.append((orig, e))
        return L.Map(njoin, computed)

    return rec(plan)


def __cast(ref: ColRef, t: Type):
    from ..plan.exprs import Cast

    return Cast(ref, t)


def eager_fact_preagg(plan: L.LogicalOp, catalog) -> L.LogicalOp:
    """The mirrored eager-aggregation direction for star joins:

      Aggregate(K, aggs) over [Map(L-only)] Join[inner](L, R, lk = rk)
      with R unique on rk, K subset of R's columns, and every aggregate
      argument from L

    becomes

      Aggregate(K, lift(aggs)) over Join[inner](Aggregate(L by lk, aggs),
                                               R, lk = rk)

    — the fact side pre-reduces by ITS join key before the join (TPC-H Q10:
    lineitem pre-sums revenue per l_orderkey). On an accelerator this is decisive:
    lk rides the fact table's clustered order, so the big pre-aggregation
    takes the fused SORT-FREE presorted grouping, the join shrinks to
    unique-key LUT form, and the final grouping runs at dimension
    cardinality instead of fact cardinality. sum/count lift through as
    sums, min/max as min/max (both levels partition the same rows:
    each fact row joins at most one R row — rk unique — and survives iff
    its lk group survives, so regrouping partial results by K is exact).
    Reference analogue: eager aggregation / groupjoin,
    OptimizeImplementations.cpp:580-660.
    """
    from .constraints import collect_fds

    cids = _Cids(plan)

    def sub_rows(node):
        out = 0
        for s in L.walk_plan(node):
            if isinstance(s, L.Scan):
                e = catalog.get_table(s.table)
                if e is not None:
                    out = max(out, e.num_rows)
        return out

    def attempt(op, j, pushed_map, fact, dims):
        """Try the rewrite with `fact` as the aggregate-argument side and
        `dims` as the group-key side (the join may come in either
        orientation from the join-order pass)."""
        fcids = {c.cid for c in fact.output_cols()}
        dcids = {c.cid for c in dims.output_cols()}
        if pushed_map is not None:
            # the Map must read only fact-side columns (it computes the
            # aggregate arguments); its outputs count as fact columns
            for _ci, e in pushed_map.computed:
                if E.used_cols(e) - fcids:
                    return None
            fcids = fcids | {ci.cid for ci, _e in pushed_map.computed}
        eqs = []
        for c in E.conjuncts(j.predicate):
            if (isinstance(c, Call) and c.op == "eq"
                    and isinstance(c.args[0], ColRef)
                    and isinstance(c.args[1], ColRef)):
                a, b = c.args[0].cid, c.args[1].cid
                if a in fcids and b in dcids:
                    eqs.append((c.args[0], c.args[1]))
                    continue
                if b in fcids and a in dcids:
                    eqs.append((c.args[1], c.args[0]))
                    continue
            return None  # residual predicate: bail (pushdown ran already)
        if len(eqs) != 1:
            return None
        fk, dk = eqs[0]
        if not set(op.group_by) <= dcids:
            return None
        # split: fact-side aggregates get pushed; any_value over dimension
        # columns (FD-recovered group payloads) stays in the outer level —
        # dimension columns pass through the rebuilt join unchanged
        push_specs, keep_specs = [], []
        for a in op.aggs:
            if a.distinct:
                return None
            if (a.fn == "any_value" and a.arg is not None
                    and a.arg in dcids):
                keep_specs.append(a)
                continue
            if a.fn not in _PUSHABLE:
                return None
            if a.arg is None and a.fn != "count_star":
                return None
            if a.arg is not None and a.arg not in fcids:
                return None
            push_specs.append(a)
        if not push_specs:
            return None
        fds = collect_fds(dims, catalog)
        if fds.key is None or not fds.key <= fds.expand({dk.cid}):
            return None  # dims not unique on the join key
        # worth it only when the fact side dwarfs the dimension side —
        # otherwise the extra aggregation level just adds a pass
        if sub_rows(fact) < 2 * sub_rows(dims):
            return None

        fk_info = next((c for c in fact.output_cols() if c.cid == fk.cid),
                       None)
        if fk_info is None:
            return None
        f_in = fact
        if pushed_map is not None:
            f_in = L.Map(f_in, list(pushed_map.computed))
        inner_aggs, outer_aggs = [], []
        lifted = {"sum": "sum", "count": "sum", "count_star": "sum",
                  "min": "min", "max": "max"}
        for a in push_specs:
            ic = cids.fresh(a.out.name, a.out.type)
            inner_aggs.append(L.AggSpec(ic, a.fn, a.arg))
            outer_aggs.append(L.AggSpec(a.out, lifted[a.fn], ic.cid))
        outer_aggs.extend(keep_specs)
        inner = L.Aggregate(f_in, [fk.cid], inner_aggs, [fk_info])
        # cascade: the new inner aggregate may itself sit over a star join
        # (Q10: group by custkey over (lineitem x orders) x customer —
        # the first application pre-aggregates by o_custkey, the second
        # pushes down to the clustered l_orderkey level)
        inner = rec(inner)
        njoin = L.Join("inner", inner, dims,
                       Call("eq", [ColRef(fk.cid, fk_info.type), dk],
                            Type.bool_(True)))
        return L.Aggregate(njoin, op.group_by, outer_aggs, op.group_cols)

    def rec(op: L.LogicalOp) -> L.LogicalOp:
        kids = op.children()
        if kids:
            op = op.replace_children([rec(c) for c in kids])
        if not isinstance(op, L.Aggregate) or not op.group_by:
            return op
        j = op.child
        pushed_map = None
        if isinstance(j, L.Map):
            pushed_map, j = j, j.child
        if not isinstance(j, L.Join) or j.kind != "inner":
            return op
        if getattr(j, "null_aware", None) is not None:
            return op
        # the join-order pass may leave the fact spine on EITHER side
        for fact, dims in ((j.left, j.right), (j.right, j.left)):
            out = attempt(op, j, pushed_map, fact, dims)
            if out is not None:
                return out
        return op

    return rec(plan)


# ------------------------------------------------------------ distinct split
def split_distinct_aggregates(plan: L.LogicalOp, catalog=None) -> L.LogicalOp:
    """Aggregate(K, aggs all DISTINCT on one shared argument x) becomes
      Aggregate(K, plain aggs on x) over Aggregate(K+[x], no aggs)
    — the inner dedup grouping carries the join/filter spine into the fused
    program; the outer level runs over the small distinct set."""
    cids = _Cids(plan)

    def rec(op: L.LogicalOp) -> L.LogicalOp:
        kids = op.children()
        if kids:
            op = op.replace_children([rec(c) for c in kids])
        if not isinstance(op, L.Aggregate) or not op.aggs:
            return op
        if not all(a.distinct for a in op.aggs):
            return op
        args = {a.arg for a in op.aggs}
        if len(args) != 1 or None in args:
            return op
        (x,) = args
        if any(a.fn not in ("count", "sum", "min", "max") for a in op.aggs):
            return op
        child_cols = {c.cid: c for c in op.child.output_cols()}
        if x not in child_cols or x in op.group_by:
            return op
        inner_keys = list(op.group_by) + [x]
        inner_infos = list(op.group_cols) + [child_cols[x]]
        inner = L.Aggregate(op.child, inner_keys, [], inner_infos)
        outer_aggs = [L.AggSpec(a.out, a.fn, a.arg) for a in op.aggs]
        return L.Aggregate(inner, list(op.group_by), outer_aggs, op.group_cols)

    return rec(plan)


def eliminate_singleton_agg(plan: L.LogicalOp, catalog) -> L.LogicalOp:
    """Drop aggregates whose groups provably hold exactly ONE row.

    When the group keys functionally determine a unique key of the input
    (constraints.collect_fds), every group is a singleton: sum/min/max/
    any_value are the identity (cast to the output type), count_star and
    count(non-nullable) are 1. The Aggregate becomes a Map, skipping the
    whole grouping machinery — the shape eager_fact_preagg leaves behind on
    Q10-class plans (outer re-aggregation of a pre-aggregated fact joined
    through unique keys: ~1M-row sort for nothing). Reference analogue:
    the reference's hash table degenerates gracefully per-tuple
    (Hashtable.cpp); the accelerator build must not pay a 1M-row sort for it.
    """
    from ..plan.exprs import Cast, ColRef, Const
    from .constraints import collect_fds

    def rec(op: L.LogicalOp) -> L.LogicalOp:
        op = op.replace_children([rec(c) for c in op.children()])
        if not isinstance(op, L.Aggregate) or not op.group_by:
            return op
        if any(a.fn not in ("sum", "min", "max", "any_value",
                            "count", "count_star") for a in op.aggs):
            return op
        fds = collect_fds(op.child, catalog)
        if fds.key is None or not (fds.key <= fds.expand(set(op.group_by))):
            return op
        ctypes = {c.cid: c.type for c in op.child.output_cols()}
        computed = []
        for a in op.aggs:
            if a.fn == "count_star":
                computed.append((a.out, Const(1, a.out.type)))
                continue
            at = ctypes.get(a.arg)
            if at is None:
                return op
            if a.fn == "count":
                if at.nullable:
                    return op  # would need a conditional; not worth it
                computed.append((a.out, Const(1, a.out.type)))
                continue
            src = ColRef(a.arg, at)
            e = src if at == a.out.type else Cast(src, a.out.type)
            computed.append((a.out, e))
        return L.Map(op.child, computed)

    return rec(plan)
