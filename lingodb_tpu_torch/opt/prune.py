"""Column pruning (projection pushdown).

Equivalent of the reference's ColumnFolding pass
(reference: src/compiler/Dialect/RelAlg/Transforms/ColumnFolding.cpp — folds
away columns no operator upstream consumes). On an accelerator this directly cuts device-memory
traffic and host->device upload: scans materialize only referenced columns,
and joins/sorts stop gathering dead payload columns through every kernel.

Top-down required-set propagation; Tmp shared subtrees receive the union of
their references' requirements via a fixpoint (a holder's plan may itself
reference other holders).
"""

from __future__ import annotations

from ..plan import exprs as E
from ..plan import logical as L


def prune_columns(plan: L.LogicalOp) -> L.LogicalOp:
    holders: dict[int, L.TmpHolder] = {}
    holder_req: dict[int, set[int]] = {}

    def note_tmp(op: L.Tmp, kept_mapping) -> None:
        holders[id(op.holder)] = op.holder
        holder_req.setdefault(id(op.holder), set()).update(
            s for s, _c in kept_mapping)

    def rec(op: L.LogicalOp, req: set[int]) -> L.LogicalOp:
        if isinstance(op, L.Materialize):
            return L.Materialize(rec(op.child, set(op.cids)), op.cids, op.names)
        if isinstance(op, L.Scan):
            used = set(req)
            for r in op.restrictions:
                used |= E.used_cols(r)
            cols = [c for c in op.cols if c.cid in used]
            return L.Scan(op.table, cols, op.restrictions)
        if isinstance(op, L.ConstRel):
            return op  # rows are positional; keep as bound
        if isinstance(op, L.Tmp):
            kept = [(s, c) for s, c in op.mapping if c.cid in req]
            if not kept:
                kept = op.mapping[:1]  # keep one column so row count survives
            note_tmp(op, kept)
            return L.Tmp(op.holder, kept)
        if isinstance(op, L.Select):
            return L.Select(rec(op.child, req | E.used_cols(op.predicate)),
                            op.predicate)
        if isinstance(op, L.Map):
            kept = [(c, e) for c, e in op.computed if c.cid in req]
            creq = req - {c.cid for c, _e in op.computed}
            for _c, e in kept:
                creq |= E.used_cols(e)
            child = rec(op.child, creq)
            return L.Map(child, kept) if kept else child
        if isinstance(op, L.Join):
            lcids = {c.cid for c in op.left.output_cols()}
            rcids = {c.cid for c in op.right.output_cols()}
            used = set(req)
            if op.predicate is not None:
                used |= E.used_cols(op.predicate)
            if op.null_aware:
                for part in op.null_aware:
                    if isinstance(part, E.BExpr):
                        used |= E.used_cols(part)
            left = rec(op.left, used & lcids)
            right = rec(op.right, used & rcids)
            return L.Join(op.kind, left, right, op.predicate, op.mark_col,
                          op.null_aware)
        if isinstance(op, L.Aggregate):
            kept_aggs = [a for a in op.aggs if a.out.cid in req]
            if not op.group_by and not kept_aggs and op.aggs:
                kept_aggs = [op.aggs[0]]  # global aggregate: keep the 1-row shape
            creq = set(op.group_by)
            creq |= {a.arg for a in kept_aggs if a.arg is not None}
            child = rec(op.child, creq)
            return L.Aggregate(child, op.group_by, kept_aggs, op.group_cols)
        if isinstance(op, (L.Sort, L.TopK)):
            child = rec(op.children()[0], req | {k.cid for k in op.keys})
            return op.replace_children([child])
        if isinstance(op, L.Limit):
            return op.replace_children([rec(op.child, req)])
        if isinstance(op, L.Distinct):
            return L.Distinct(rec(op.child, req | set(op.cids)), op.cids)
        if isinstance(op, L.SetOp):
            if op.kind == "union" and op.all and op.cols:
                # bag union: positions are independent, prune them
                keep = [i for i, c in enumerate(op.cols) if c.cid in req] or [0]
                cols = [op.cols[i] for i in keep]
                lmap = [op.lmap[i] for i in keep]
                rmap = [op.rmap[i] for i in keep]
                left = rec(op.left, set(lmap))
                right = rec(op.right, set(rmap))
                return L.SetOp(op.kind, op.all, left, right, cols, lmap, rmap)
            # set semantics (and intersect/except ALL) compare full rows:
            # every mapped position stays live
            left = rec(op.left, set(op.lmap))
            right = rec(op.right, set(op.rmap))
            return L.SetOp(op.kind, op.all, left, right, op.cols, op.lmap, op.rmap)
        if isinstance(op, L.Window):
            kept_funcs = [f for f in op.funcs if f.out.cid in req]
            creq = req - {f.out.cid for f in op.funcs}
            creq |= set(op.partition_by) | {k.cid for k in op.order_by}
            creq |= {f.arg for f in kept_funcs if f.arg is not None}
            child = rec(op.child, creq)
            if not kept_funcs:
                return child
            return L.Window(child, op.partition_by, op.order_by, kept_funcs,
                            op.frame_start, op.frame_end, op.frame_mode)
        # unknown node: conservatively require everything below
        kids = op.children()
        if not kids:
            return op
        return op.replace_children(
            [rec(c, {x.cid for x in c.output_cols()}) for c in kids])

    out = rec(plan, {c.cid for c in plan.output_cols()})

    # shared subtrees: requirements accumulate across references (including
    # references inside other holders' plans). rec() is pure, so re-prune each
    # holder's ORIGINAL plan until the requirement sets (and the holder set
    # itself) stop growing, then commit the final pruned plans.
    while True:
        sizes = {h: len(holder_req.get(h, ())) for h in holders}
        results = {hid: rec(holder.plan, set(holder_req.get(hid, ())))
                   for hid, holder in list(holders.items())}
        stable = len(sizes) == len(holders) and all(
            len(holder_req.get(h, ())) == n for h, n in sizes.items())
        if stable:
            for hid, holder in holders.items():
                holder.plan = results[hid]
            break
    return out
