"""Constraint propagation passes: functional dependencies + equivalences.

Equivalent of the reference's PropagateConstraints.cpp
(reference: src/compiler/Dialect/RelAlg/Transforms/PropagateConstraints.cpp
— ReduceAggrKeys at :58-123 via FunctionalDependencies.reduce, and
ExpandTransitiveEqualities at :135-219 via llvm::EquivalenceClasses; the FD
lattice itself is include/lingodb/compiler/Dialect/RelAlg/
FunctionalDependencies.h and per-operator derivation in
OperatorInterfaceImpl.cpp:506-600).

Both passes matter disproportionately on an accelerator: ReduceGroupByKeys turns wide
multi-key groupings (hash over many columns, lexicographic multi-key sorts)
into single-key dense-gid groupings, and ExpandTransitiveEqualities gives the
join-order optimizer extra equi-join edges so fewer plans degenerate into
replicated cross products on the mesh.
"""

from __future__ import annotations

from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import BExpr, Call, ColRef
from ..sql.types import Type


# --------------------------------------------------- functional dependencies
class FDs:
    """Set of functional dependencies lhs -> rhs over column ids, plus an
    optional unique key (reference: FunctionalDependencies.h:5-70)."""

    def __init__(self):
        self.fds: list[tuple[frozenset[int], frozenset[int]]] = []
        self.key: frozenset[int] | None = None

    def insert(self, lhs, rhs) -> None:
        self.fds.append((frozenset(lhs), frozenset(rhs)))

    def merge(self, other: "FDs") -> None:
        self.fds.extend(other.fds)

    def expand(self, available: set[int]) -> set[int]:
        """Closure of `available` under the FDs."""
        result = set(available)
        changed = True
        while changed:
            changed = False
            for lhs, rhs in self.fds:
                if lhs <= result and not rhs <= result:
                    result |= rhs
                    changed = True
        return result

    def reduce(self, keys: list[int]) -> list[int]:
        """Drop keys functionally determined by the remaining ones
        (order-preserving; reference: FunctionalDependencies.h reduce())."""
        res = list(keys)
        for k in list(keys):
            local = set(res) - {k}
            if set(keys) <= self.expand(local):
                res = [x for x in res if x != k]
        return res


def _eq_col_pairs(pred: BExpr | None) -> list[tuple[int, int]]:
    """col=col equality conjuncts of a predicate."""
    out = []
    for c in E.conjuncts(pred):
        if (isinstance(c, Call) and c.op == "eq" and len(c.args) == 2
                and isinstance(c.args[0], ColRef) and isinstance(c.args[1], ColRef)):
            out.append((c.args[0].cid, c.args[1].cid))
    return out


def collect_fds(op: L.LogicalOp, catalog) -> FDs:
    """Bottom-up FD derivation (reference: OperatorInterfaceImpl.cpp:506-600:
    base table primary keys, selection/inner-join equality predicates,
    aggregation group keys)."""
    fds = FDs()
    if isinstance(op, L.Scan):
        entry = catalog.get_table(op.table) if catalog is not None else None
        if entry is not None and entry.primary_key:
            by_name = {c.name: c.cid for c in op.cols}
            if all(n in by_name for n in entry.primary_key):
                pk = frozenset(by_name[n] for n in entry.primary_key)
                rest = {c.cid for c in op.cols} - pk
                fds.key = pk
                if rest:
                    fds.insert(pk, rest)
        for a, b in _eq_col_pairs(E.make_and(op.restrictions) if op.restrictions else None):
            fds.insert({a}, {b})
            fds.insert({b}, {a})
        return fds
    if isinstance(op, L.Select):
        fds = collect_fds(op.child, catalog)
        for a, b in _eq_col_pairs(op.predicate):
            fds.insert({a}, {b})
            fds.insert({b}, {a})
        return fds
    if isinstance(op, L.Map):
        fds = collect_fds(op.child, catalog)
        for ci, e in op.computed:
            used = E.used_cols(e)
            if used:
                fds.insert(used, {ci.cid})
        return fds
    if isinstance(op, L.Aggregate):
        fds = collect_fds(op.child, catalog)
        if op.group_by:
            fds.key = frozenset(op.group_by)
        return fds
    if isinstance(op, L.Join):
        if op.kind in ("semi", "anti"):
            return collect_fds(op.left, catalog)
        if op.kind in ("inner", "cross"):
            lf = collect_fds(op.left, catalog)
            rf = collect_fds(op.right, catalog)
            lcids = {c.cid for c in op.left.output_cols()}
            rcids = {c.cid for c in op.right.output_cols()}
            lks, rks = set(), set()
            for a, b in _eq_col_pairs(op.predicate):
                if a in lcids and b in rcids:
                    lks.add(a)
                    rks.add(b)
                elif b in lcids and a in rcids:
                    lks.add(b)
                    rks.add(a)
            # key propagation (reference: FD interface key inference,
            # OperatorInterfaceImpl.cpp): a side joined on a unique key
            # matches each opposite row at most once, so the opposite
            # side's key remains a key of the join
            r_unique = (rf.key is not None and rks
                        and rf.key <= rf.expand(frozenset(rks)))
            l_unique = (lf.key is not None and lks
                        and lf.key <= lf.expand(frozenset(lks)))
            lkey, rkey = lf.key, rf.key
            fds = lf
            fds.merge(rf)
            for a, b in _eq_col_pairs(op.predicate):
                fds.insert({a}, {b})
                fds.insert({b}, {a})
            fds.key = None
            if r_unique and lkey is not None:
                fds.key = lkey
            elif l_unique and rkey is not None:
                fds.key = rkey
            return fds
        if op.kind in ("left", "single", "mark"):
            # right columns may be NULL-extended, but each output row still
            # carries an unmodified left row: left-only FDs keep holding
            left = collect_fds(op.left, catalog)
            left.key = None
            return left
        return FDs()
    if isinstance(op, (L.Sort, L.Limit, L.TopK)):
        return collect_fds(op.children()[0], catalog)
    if isinstance(op, L.Distinct):
        fds = collect_fds(op.child, catalog)
        fds.key = frozenset(op.cids)
        return fds
    if isinstance(op, L.Window):
        return collect_fds(op.child, catalog)
    return FDs()  # ConstRel, SetOp, Tmp: no constraints tracked


# ----------------------------------------------------- reduce group-by keys
def reduce_group_keys(plan: L.LogicalOp, catalog) -> L.LogicalOp:
    """Shrink Aggregate group keys to a minimal FD cover; dropped keys are
    recomputed as any_value aggregates with their original cids (within a
    group they are constant by the FD), so upstream references are untouched
    (reference: ReduceAggrKeyPattern, PropagateConstraints.cpp:58-105 —
    dropped keys become AggrFunc::any)."""

    def rec(op: L.LogicalOp) -> L.LogicalOp:
        kids = op.children()
        if kids:
            op = op.replace_children([rec(c) for c in kids])
        if isinstance(op, L.Aggregate) and len(op.group_by) > 1:
            fds = collect_fds(op.child, catalog)
            reduced = fds.reduce(op.group_by)
            if len(reduced) < len(op.group_by):
                kept = set(reduced)
                aggs = list(op.aggs)
                group_cols = []
                for ci in op.group_cols:
                    if ci.cid in kept:
                        group_cols.append(ci)
                    else:
                        aggs.append(L.AggSpec(ci, "any_value", ci.cid))
                return L.Aggregate(op.child, reduced, aggs, group_cols)
        return op

    return rec(plan)


# ---------------------------------------------- expand transitive equalities
class _DSU:
    """Union-find over column ids, with class-member enumeration."""

    def __init__(self):
        self.parent: dict[int, int] = {}

    def find(self, x: int) -> int:
        self.parent.setdefault(x, x)
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb

    def equivalent(self, a: int, b: int) -> bool:
        return self.find(a) == self.find(b)

    def members(self, x: int) -> list[int]:
        self.find(x)
        r = self.find(x)
        return [m for m in self.parent if self.find(m) == r]

    def absorb(self, other: "_DSU") -> None:
        for m in list(other.parent):
            self.union(m, other.find(m))


def _bridge(dsu: _DSU, direct: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union each direct a=b pair into dsu; return the pairs that became
    newly equivalent OTHER than the direct pairs themselves (reference:
    ExpandTransitiveEqualities::merge, PropagateConstraints.cpp:142-160 —
    pairs not equivalent before the merge)."""
    new_pairs: list[tuple[int, int]] = []
    skip = set(direct) | {(b, a) for a, b in direct}
    for a, b in direct:
        if dsu.equivalent(a, b):
            continue
        ca, cb = dsu.members(a), dsu.members(b)
        dsu.union(a, b)
        for x in ca:
            for y in cb:
                if (x, y) not in skip:
                    new_pairs.append((x, y))
    return new_pairs


def expand_transitive_equalities(plan: L.LogicalOp) -> L.LogicalOp:
    """Derive implied column equalities (a=b and b=c imply a=c) from
    selection and inner-join/cross-product equality predicates, and attach
    them as additional predicates above the op that bridged them; the
    following pushdown pass turns cross-side ones into join predicates,
    giving the join-order optimizer extra equi-join edges (reference:
    ExpandTransitiveEqualities, PropagateConstraints.cpp:135-219)."""
    types: dict[int, Type] = {}
    for node in L.walk_plan(plan):
        for c in node.output_cols():
            types.setdefault(c.cid, c.type)

    def new_preds(pairs, avail: set[int]) -> list[BExpr]:
        out = []
        for a, b in pairs:
            if a in avail and b in avail and a in types and b in types:
                out.append(Call("eq", [ColRef(a, types[a]), ColRef(b, types[b])],
                                Type.bool_(True)))
        return out

    def rec(op: L.LogicalOp) -> tuple[L.LogicalOp, _DSU]:
        if isinstance(op, L.Select):
            child, dsu = rec(op.child)
            pairs = _bridge(dsu, _eq_col_pairs(op.predicate))
            preds = new_preds(pairs, {c.cid for c in op.output_cols()})
            pred = E.make_and([op.predicate] + preds) if preds else op.predicate
            return L.Select(child, pred), dsu
        if isinstance(op, L.Map):
            child, dsu = rec(op.child)
            return L.Map(child, op.computed), dsu
        if isinstance(op, L.Join):
            if op.kind in ("inner", "cross"):
                left, dl = rec(op.left)
                right, dr = rec(op.right)
                dl.absorb(dr)  # disjoint column sets: no new pairs yet
                pairs = _bridge(dl, _eq_col_pairs(op.predicate))
                out: L.LogicalOp = L.Join(op.kind, left, right, op.predicate,
                                          op.mark_col, op.null_aware)
                preds = new_preds(pairs, {c.cid for c in out.output_cols()})
                if preds:
                    out = L.Select(out, E.make_and(preds))
                return out, dl
            if op.kind in ("semi", "anti", "mark", "single", "left"):
                left, dl = rec(op.left)
                right, _dr = rec(op.right)
                return L.Join(op.kind, left, right, op.predicate, op.mark_col,
                              op.null_aware), dl
            left, _ = rec(op.left)
            right, _ = rec(op.right)
            return L.Join(op.kind, left, right, op.predicate, op.mark_col,
                          op.null_aware), _DSU()
        kids = op.children()
        if not kids:
            return op, _DSU()
        new_kids = []
        dsu = _DSU()
        for i, c in enumerate(kids):
            nc, d = rec(c)
            new_kids.append(nc)
            if i == 0:
                dsu = d
        out = op.replace_children(new_kids)
        if isinstance(op, L.Aggregate):
            keep = set(op.group_by)
            pruned = _DSU()
            for root in {dsu.find(m) for m in list(dsu.parent)}:
                inter = sorted(set(dsu.members(root)) & keep)
                for m in inter[1:]:
                    pruned.union(inter[0], m)
            dsu = pruned
        elif isinstance(op, L.SetOp):
            dsu = _DSU()
        return out, dsu

    out, _ = rec(plan)
    return out
