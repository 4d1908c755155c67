"""Common-subtree elimination: share repeated subplans via Tmp.

Equivalent of the reference's CommonSubtreeElimination +
IntroduceTmp passes (reference: src/compiler/Dialect/RelAlg/Transforms/
CommonSubtreeElimination.cpp — fingerprints alpha-equivalent subtrees and
rewires duplicates onto one relalg.tmp materialization, Passes.cpp:46-47).

The binder expands each CTE/view reference into an independent clone with
fresh column ids, so duplicates differ only by cid renaming. Fingerprints
canonicalize cids *defined inside* the subtree to structural indices (free
cids — correlated references to the outside — stay literal, so two
occurrences match only when they reference the same outer columns). Each
group of >=2 alpha-equivalent subtrees containing at least one heavy
operator collapses onto one TmpHolder; the executor materializes the holder
once and every Tmp reference renames its columns.
"""

from __future__ import annotations

from ..plan import exprs as E
from ..plan import logical as L

# a subtree is worth materializing once when it contains real work; sharing a
# bare Scan/Select chain would only add a materialization boundary
_HEAVY = (L.Aggregate, L.Join, L.Window, L.Distinct, L.SetOp, L.Sort, L.TopK)


def _own_defs(op: L.LogicalOp) -> list[int]:
    """Column ids newly defined by this node (not inherited from children)."""
    if isinstance(op, (L.Scan, L.ConstRel, L.SetOp)):
        return [c.cid for c in op.cols]
    if isinstance(op, L.Map):
        return [c.cid for c, _e in op.computed]
    if isinstance(op, L.Join):
        return [op.mark_col.cid] if op.mark_col is not None else []
    if isinstance(op, L.Aggregate):
        return [a.out.cid for a in op.aggs]
    if isinstance(op, L.Window):
        return [f.out.cid for f in op.funcs]
    if isinstance(op, L.Tmp):
        return [c.cid for _s, c in op.mapping]
    if isinstance(op, (L.Iterate, L.IterRef)):
        return [c.cid for c in op.cols]
    return []


def _params(op: L.LogicalOp, canon: dict[int, int]):
    """Canonical, hashable description of the node's own attributes with
    bound cids replaced by negative structural indices."""

    def cn(cid):
        return canon.get(cid, cid)

    def ce(e):
        return None if e is None else repr(E.map_cols(e, canon))

    if isinstance(op, L.Scan):
        return (op.table,
                tuple((c.name, str(c.type)) for c in op.cols),
                tuple(ce(r) for r in op.restrictions))
    if isinstance(op, L.ConstRel):
        return (tuple(str(c.type) for c in op.cols), repr(op.rows))
    if isinstance(op, L.Select):
        return (ce(op.predicate),)
    if isinstance(op, L.Map):
        return tuple((str(c.type), ce(e)) for c, e in op.computed)
    if isinstance(op, L.Join):
        na = op.null_aware
        return (op.kind, ce(op.predicate),
                None if op.mark_col is None else str(op.mark_col.type),
                None if na is None else tuple(ce(x) for x in na))
    if isinstance(op, L.Aggregate):
        return (tuple(cn(g) for g in op.group_by),
                tuple((a.fn, None if a.arg is None else cn(a.arg),
                       a.distinct, str(a.out.type)) for a in op.aggs),
                tuple(cn(c.cid) for c in op.group_cols))
    if isinstance(op, (L.Sort, L.TopK)):
        keys = tuple((cn(k.cid), k.ascending, k.nulls_first) for k in op.keys)
        if isinstance(op, L.TopK):
            return (keys, op.n, op.offset)
        return (keys,)
    if isinstance(op, L.Limit):
        return (op.n, op.offset)
    if isinstance(op, L.Distinct):
        return tuple(cn(c) for c in op.cids)
    if isinstance(op, L.SetOp):
        return (op.kind, op.all,
                tuple(cn(c) for c in op.lmap), tuple(cn(c) for c in op.rmap),
                tuple(str(c.type) for c in op.cols))
    if isinstance(op, L.Window):
        return (tuple(cn(p) for p in op.partition_by),
                tuple((cn(k.cid), k.ascending, k.nulls_first) for k in op.order_by),
                tuple((f.fn, None if f.arg is None else cn(f.arg),
                       repr(f.extra), repr(f.default), str(f.out.type))
                      for f in op.funcs),
                op.frame_start, op.frame_end, op.frame_mode)
    if isinstance(op, L.Materialize):
        return (tuple(cn(c) for c in op.cids), tuple(op.names))
    if isinstance(op, L.Tmp):
        # identity of the holder matters: same holder + same source columns
        return (id(op.holder), tuple(s for s, _c in op.mapping),
                tuple(str(c.type) for _s, c in op.mapping))
    if isinstance(op, L.IterRef):
        # holder identity keeps refs of different loops distinct
        return ("iterref", id(op.holder), tuple(str(c.type) for c in op.cols))
    if isinstance(op, L.Iterate):
        return ("iterate", id(op.holder), op.distinct, op.emit, op.max_iters,
                tuple(cn(c) for c in op.lmap), tuple(cn(c) for c in op.smap),
                tuple(str(c.type) for c in op.cols))
    raise TypeError(type(op))


def eliminate_common_subtrees(plan: L.LogicalOp) -> L.LogicalOp:
    """Collapse alpha-equivalent duplicated subtrees onto shared Tmp nodes."""
    sigs: dict[int, tuple] = {}       # id(node) -> fingerprint
    defs: dict[int, list[int]] = {}   # id(node) -> cids defined in subtree
    heavy: dict[int, bool] = {}       # id(node) -> contains heavy op
    occurrences: dict[tuple, list] = {}

    def fingerprint(node: L.LogicalOp) -> tuple:
        child_sigs = []
        d: list[int] = []
        h = isinstance(node, _HEAVY)
        for c in node.children():
            child_sigs.append(fingerprint(c))
            d.extend(defs[id(c)])
            h = h or heavy[id(c)]
        d.extend(_own_defs(node))
        canon = {cid: -(i + 1) for i, cid in enumerate(d)}
        sig = (type(node).__name__, _params(node, canon), tuple(child_sigs))
        sigs[id(node)] = sig
        defs[id(node)] = d
        heavy[id(node)] = h
        occurrences.setdefault(sig, []).append(node)
        return sig

    fingerprint(plan)

    chosen = {
        sig
        for sig, nodes in occurrences.items()
        if len(nodes) >= 2 and heavy[id(nodes[0])]
        and not isinstance(nodes[0], (L.Materialize, L.Tmp))
    }
    if not chosen:
        return plan

    holders: dict[tuple, L.TmpHolder] = {}
    rep_out: dict[tuple, list] = {}

    def rebuild(node: L.LogicalOp, is_root: bool) -> L.LogicalOp:
        sig = sigs[id(node)]
        if not is_root and sig in chosen:
            holder = holders.get(sig)
            if holder is None:
                holder = L.TmpHolder(None)
                holders[sig] = holder
                rep_out[sig] = node.output_cols()
                # the holder plan itself is rebuilt so *nested* shared
                # subtrees still collapse (its root sig is excluded to avoid
                # self-replacement)
                ch = [rebuild(c, False) for c in node.children()]
                holder.plan = node.replace_children(ch) if ch else node
            return L.Tmp(
                holder,
                [(r.cid, o) for r, o in zip(rep_out[sig], node.output_cols())],
            )
        ch = [rebuild(c, False) for c in node.children()]
        return node.replace_children(ch) if ch else node

    return rebuild(plan, True)
