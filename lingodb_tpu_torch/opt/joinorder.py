"""Join-order optimization: exact DP over connected subgraphs + GOO fallback.

Equivalent of the reference's join ordering
(reference: src/compiler/Dialect/RelAlg/Transforms/queryopt/DPhyp.cpp:61-72
solve() — exact dynamic programming over csg-cmp pairs; GOO.cpp greedy
fallback chosen when the subgraph count explodes, OptimizeJoinOrder.cpp:
122-126). This implementation enumerates connected subsets with a bitmask DP
(C_out cost), using sample-based scan selectivities and distinct-count join
selectivities from opt/cardinality.py; inner-join components larger than
DP_LIMIT relations fall back to greedy operator ordering."""

from __future__ import annotations

from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import Call
from .cardinality import ColumnOrigins, default_selectivity, join_selectivity, scan_selectivity

DP_LIMIT = 14


def reorder_joins(plan: L.LogicalOp, catalog) -> L.LogicalOp:
    from ..utils.settings import get_setting

    if get_setting("system.join_order") is False:
        return plan
    if isinstance(plan, L.Materialize):
        return L.Materialize(reorder_joins(plan.child, catalog), plan.cids, plan.names)
    # Order each maximal inner/cross-join component exactly once: collect the
    # whole chain at its root, recurse only into the non-join leaves. (A
    # bottom-up rewrite would re-run _order on every prefix subtree — O(n)
    # orderings of one n-way chain.)
    if isinstance(plan, L.Join) and plan.kind in ("inner", "cross"):
        rels, preds = _collect(plan)
        if len(rels) > 2:
            rels = [reorder_joins(r, catalog) for r in rels]
            return _order(rels, preds, catalog)
    children = [reorder_joins(c, catalog) for c in plan.children()]
    if children:
        plan = plan.replace_children(children)
    return plan


def _collect(op: L.LogicalOp):
    rels: list[L.LogicalOp] = []
    preds: list = []

    def go(n):
        if isinstance(n, L.Join) and n.kind in ("inner", "cross"):
            go(n.left)
            go(n.right)
            if n.predicate is not None:
                preds.extend(E.conjuncts(n.predicate))
        else:
            rels.append(n)

    go(op)
    return rels, preds


def estimate_rel_card(plan: L.LogicalOp, catalog) -> float:
    if isinstance(plan, L.Scan):
        entry = catalog.get_table(plan.table)
        n = max(entry.num_rows if entry else 1000, 1)
        return max(n * scan_selectivity(entry, plan, plan.restrictions), 1.0)
    if isinstance(plan, L.Select):
        base = estimate_rel_card(plan.child, catalog)
        scan = plan.child
        while isinstance(scan, (L.Map,)):
            scan = scan.child
        if isinstance(scan, L.Scan):
            entry = catalog.get_table(scan.table)
            return max(base * scan_selectivity(entry, scan, E.conjuncts(plan.predicate)), 1.0)
        return max(base * default_selectivity(plan.predicate), 1.0)
    if isinstance(plan, L.Map):
        return estimate_rel_card(plan.child, catalog)
    if isinstance(plan, L.Aggregate):
        base = estimate_rel_card(plan.child, catalog)
        return max(base**0.7, 1.0) if plan.group_by else 1.0
    if isinstance(plan, L.ConstRel):
        return max(len(plan.rows), 1)
    if isinstance(plan, L.Join):
        l = estimate_rel_card(plan.left, catalog)
        r = estimate_rel_card(plan.right, catalog)
        if plan.kind in ("semi", "anti"):
            return max(l * 0.5, 1.0)
        if plan.kind in ("single", "mark", "left"):
            return l
        return max(l * r * 0.1, 1.0)
    ch = plan.children()
    return estimate_rel_card(ch[0], catalog) if ch else 1000.0


# memo entries pin the plan object (key is its id) so a garbage-collected
# plan's id can never alias a live entry
_CARD_MEMO: dict = {}


def _estimate_cached(r, catalog) -> float:
    k = id(r)
    v = _CARD_MEMO.get(k)
    if v is None:
        card = estimate_rel_card(r, catalog)
        if len(_CARD_MEMO) > 8192:
            _CARD_MEMO.clear()
        _CARD_MEMO[k] = v = (r, card)
    return v[1]


def _order(rels, preds, catalog) -> L.LogicalOp:
    n = len(rels)
    origins = ColumnOrigins(rels, catalog)
    cards = [_estimate_cached(r, catalog) for r in rels]
    rel_cids = [frozenset(c.cid for c in r.output_cols()) for r in rels]

    pred_masks = []
    pred_sels = []
    for p in preds:
        u = E.used_cols(p)
        m = 0
        for i in range(n):
            if u & rel_cids[i]:
                m |= 1 << i
        pred_masks.append(m)
        if m.bit_count() == 2:
            i, j = [k for k in range(n) if m >> k & 1]
            pred_sels.append(join_selectivity(p, origins, cards[i], cards[j]))
        else:
            pred_sels.append(default_selectivity(p))

    if n > DP_LIMIT:
        return _goo(rels, preds, cards, pred_masks, pred_sels)

    multi_preds = [(pm, s) for pm, s in zip(pred_masks, pred_sels)
                   if pm and pm.bit_count() >= 2]

    def card_of(mask: int) -> float:
        c = 1.0
        for i in range(n):
            if mask >> i & 1:
                c *= cards[i]
        for pm, s in multi_preds:
            if (pm & mask) == pm:
                c *= s
        return max(c, 1.0)

    # best[mask] = (cost, plan)
    best: dict[int, tuple[float, L.LogicalOp]] = {}
    for i in range(n):
        m = 1 << i
        best[m] = (0.0, rels[i])
        # single-relation predicates that slipped past pushdown
        local = [p for p, pm in zip(preds, pred_masks) if pm == m]
        if local:
            best[m] = (0.0, L.Select(rels[i], E.make_and(local)))

    full = (1 << n) - 1
    masks_by_size = [[] for _ in range(n + 1)]
    for m in range(1, full + 1):
        masks_by_size[m.bit_count()].append(m)

    for size in range(2, n + 1):
        for mask in masks_by_size[size]:
            besthere = None
            # invariant per mask: the result cardinality and the set of
            # in-scope predicates depend only on mask, not on the split
            card = card_of(mask)
            preds_in = [pm for pm in pred_masks if pm and (pm & mask) == pm]
            s1 = (mask - 1) & mask
            while s1:
                s2 = mask ^ s1
                if s1 < s2:  # each unordered split once
                    if s1 in best and s2 in best:
                        conn = any((pm & s1) and (pm & s2) for pm in preds_in)
                        penalty = 1.0 if conn else 1e9
                        cost = best[s1][0] + best[s2][0] + card * penalty
                        if besthere is None or cost < besthere[0]:
                            besthere = (cost, (s1, s2))
                s1 = (s1 - 1) & mask
            if besthere is not None:
                s1, s2 = besthere[1]
                joinp = [
                    p for p, pm in zip(preds, pred_masks)
                    if (pm & s1) and (pm & s2) and (pm & ~mask) == 0
                ]
                j = L.Join(
                    "inner" if joinp else "cross",
                    best[s1][1], best[s2][1],
                    E.make_and(joinp) if joinp else None,
                )
                best[mask] = (besthere[0], j)

    if full in best:
        out = best[full][1]
        used = set()
        # predicates covered exactly once during construction; any predicate
        # spanning >2 relations may not have been applied — re-check
        applied = _applied_preds(out)
        leftover = [p for p in preds if id(p) not in applied]
        if leftover:
            out = L.Select(out, E.make_and(leftover))
        return out
    return _goo(rels, preds, cards, pred_masks, pred_sels)


def _applied_preds(plan: L.LogicalOp) -> set[int]:
    out = set()
    for node in L.walk_plan(plan):
        if isinstance(node, L.Join) and node.predicate is not None:
            for c in E.conjuncts(node.predicate):
                out.add(id(c))
        elif isinstance(node, L.Select):
            for c in E.conjuncts(node.predicate):
                out.add(id(c))
    return out


def _goo(rels, preds, cards, pred_masks, pred_sels) -> L.LogicalOp:
    """Greedy Operator Ordering (reference: queryopt/GOO.cpp): repeatedly
    join the pair with the smallest estimated result."""
    items = [
        {"plan": r, "mask": 1 << i, "card": cards[i]} for i, r in enumerate(rels)
    ]
    pool = list(zip(preds, pred_masks, pred_sels))

    while len(items) > 1:
        bestpick = None
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                a, b = items[i], items[j]
                m = a["mask"] | b["mask"]
                ps = [
                    (p, pm, s) for p, pm, s in pool
                    if (pm & a["mask"]) and (pm & b["mask"]) and (pm & ~m) == 0
                ]
                sel = 1.0
                for _p, _pm, s in ps:
                    sel *= s
                card = a["card"] * b["card"] * sel
                if not ps:
                    card *= 1e6
                if bestpick is None or card < bestpick[0]:
                    bestpick = (card, i, j, ps)
        card, i, j, ps = bestpick
        a, b = items[i], items[j]
        for x in ps:
            pool.remove(x)
        joined = L.Join(
            "inner" if ps else "cross", a["plan"], b["plan"],
            E.make_and([p for p, _pm, _s in ps]) if ps else None,
        )
        items = [x for k, x in enumerate(items) if k not in (i, j)] + [
            {"plan": joined, "mask": a["mask"] | b["mask"], "card": max(card, 1.0)}
        ]
    out = items[0]["plan"]
    if pool:
        out = L.Select(out, E.make_and([p for p, _pm, _s in pool]))
    return out
