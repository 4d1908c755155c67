"""Query optimizer: logical rewrite passes.

Equivalent of the reference RelAlg optimization pipeline
(reference: src/compiler/Dialect/RelAlg/Passes.cpp:17-50 — the pass order is
SimplifyAggregations -> ... -> Pushdown -> ... -> OptimizeJoinOrder -> ...).
Round-1 passes: predicate pushdown (reference: Transforms/Pushdown.cpp) and
scan-restriction folding; join ordering (DPhyp) lands in opt/joinorder.py.
"""

from __future__ import annotations

from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import BExpr


# (pass_name, plan.pretty()) pairs for the most recent optimize() call when
# system.snapshot_passes is on (reference: per-pass IR snapshots,
# src/execution/Instrumentation.cpp:29-80)
last_pass_snapshots: list[tuple[str, str]] = []


def optimize(plan: L.LogicalOp, catalog) -> L.LogicalOp:
    """Run the logical pass pipeline (reference order: Passes.cpp:17-50).

    `system.opt` (LINGODB_OPT) restricts to a comma-separated subset of pass
    names; `system.snapshot_passes` records the plan after every pass into
    `last_pass_snapshots` and writes snapshot-<N>-<pass>.plan files under
    `system.snapshot_dir` (reference: Instrumentation.cpp snapshots)."""
    from ..utils import compilestats, settings

    compilestats.add("optimizations")

    # shared subtrees (Tmp holders) optimize exactly once; they are leaves to
    # the per-reference rewrites below (reference: IntroduceTmp keeps the
    # materialized tree out of later per-use rewrites, Passes.cpp:47)
    for node in L.walk_plan(plan):
        if isinstance(node, L.Tmp) and not node.holder.optimized:
            node.holder.optimized = True
            node.holder.plan = optimize(node.holder.plan, catalog)

    from .aggrewrites import (eager_aggregation, eager_fact_preagg,
                              eliminate_singleton_agg,
                              split_distinct_aggregates)
    from .constraints import expand_transitive_equalities, reduce_group_keys
    from .cse import eliminate_common_subtrees
    from .joinorder import reorder_joins
    from .prune import prune_columns

    passes = [
        ("decorrelate-lateral", lambda p: decorrelate_lateral(p)),
        # x IS NOT NULL conjuncts for strict-compared nullable columns: they
        # push to scans and tighten selectivity estimates
        ("infer-not-null", infer_not_null),
        ("pushdown", pushdown),
        # left/single joins whose right side is referenced by nobody above
        # and cannot change the left row count: drop them before join order
        ("eliminate-trivial-join", lambda p: eliminate_trivial_join(p, catalog)),
        # implied a=c edges from a=b, b=c: extra Selects that the following
        # pushdown sinks into join predicates (new edges for join ordering)
        ("expand-transitive-equalities", expand_transitive_equalities),
        ("pushdown", pushdown),
        ("fold-scan-restrictions", fold_scan_restrictions),
        ("reduce-group-by-keys", lambda p: reduce_group_keys(p, catalog)),
        # groupjoin: push aggregation through a unique-key join (the fused
        # pipeline then compiles segment-reduction + unique-key lookup)
        ("eager-aggregation", lambda p: eager_aggregation(p, catalog)),
        ("split-distinct-aggregates", split_distinct_aggregates),
        ("join-order", lambda p: reorder_joins(p, catalog)),
        # fact-side pre-aggregation wants the final join orientation (the
        # fact spine as the aggregate's direct join child), so it runs
        # after ordering
        ("eager-fact-preagg", lambda p: eager_fact_preagg(p, catalog)),
        # aggregates whose groups are provably singletons (group keys
        # determine a unique key — the outer re-aggregation left behind by
        # eager-fact-preagg) become Maps: identity values, count=1
        ("eliminate-singleton-agg",
         lambda p: eliminate_singleton_agg(p, catalog)),
        # collapse alpha-equivalent duplicated subtrees (CTE/view clones) onto
        # shared Tmp materializations (reference: CommonSubtreeElimination +
        # IntroduceTmp, Passes.cpp:46-47)
        ("cse", eliminate_common_subtrees),
        # LAST: drop dead columns (after cse so holder requirements union)
        ("column-folding", prune_columns),
    ]
    only = {s.strip() for s in settings.OPT_PASSES.get().split(",") if s.strip()}
    snapshot = settings.SNAPSHOT_PASSES.get()
    snaps = [("input", plan.pretty())] if snapshot else None
    for name, fn in passes:
        if only and name not in only:
            continue
        plan = fn(plan)
        if snaps is not None:
            snaps.append((name, plan.pretty()))
    if snaps is not None:
        global last_pass_snapshots
        last_pass_snapshots = snaps
        import os

        d = settings.SNAPSHOT_DIR.get() or "."
        for i, (name, text) in enumerate(snaps):
            with open(os.path.join(d, f"snapshot-{i}-{name}.plan"), "w") as f:
                f.write(text + "\n")
    return plan


# ----------------------------------------------------------------- pushdown
def _or_factors(preds: list) -> list:
    """Conjuncts common to every branch of an OR, factored out as additional
    top-level conjuncts ((A AND C) OR (B AND C) == (A OR B) AND C). Lets
    single-table factors push to scans and equality factors become join
    edges for the DP — the TPC-DS Q13/Q48 OR-of-ANDs pattern otherwise
    degenerates to a cross product (reference: the same normalization feeds
    its hash-join key detection, HashJoinUtils.cpp:21-278)."""
    from ..plan.exprs import Call

    extra = []
    for p in preds:
        if isinstance(p, Call) and p.op == "or":
            branch_sets = [{repr(x): x for x in E.conjuncts(b)}
                           for b in E.disjuncts(p)]
            common = set(branch_sets[0])
            for bs in branch_sets[1:]:
                common &= set(bs)
            have = {repr(x) for x in preds} | {repr(x) for x in extra}
            extra.extend(branch_sets[0][k] for k in sorted(common)
                         if k not in have)
    return preds + extra


def pushdown(plan: L.LogicalOp) -> L.LogicalOp:
    """Push Select predicates toward the scans (reference:
    Transforms/Pushdown.cpp:709 LoC — same rules: through Map when the
    predicate doesn't use computed columns, into the matching side of joins;
    predicates over both join sides stay as join predicates)."""
    return _push(plan, [])


def _push(op: L.LogicalOp, preds: list[BExpr]) -> L.LogicalOp:
    if isinstance(op, L.Select):
        return _push(op.child, _or_factors(preds + E.conjuncts(op.predicate)))
    if isinstance(op, L.Map):
        computed_cids = {c.cid for c, _ in op.computed}
        down, stay = _split(preds, lambda p: not (E.used_cols(p) & computed_cids))
        child = _push(op.child, down)
        out: L.LogicalOp = L.Map(child, [(c, e) for c, e in op.computed])
        return _wrap(out, stay)
    if isinstance(op, L.Join):
        lcids = {c.cid for c in op.left.output_cols()}
        rcids = {c.cid for c in op.right.output_cols()}
        if op.kind in ("inner", "cross"):
            jpreds = E.conjuncts(op.predicate) if op.predicate else []
            allp = _or_factors(preds + jpreds)
            lp, rest = _split(allp, lambda p: E.used_cols(p) <= lcids)
            rp, joinp = _split(rest, lambda p: E.used_cols(p) <= rcids)
            left = _push(op.left, lp)
            right = _push(op.right, rp)
            kind = "inner" if joinp else op.kind
            if op.kind == "inner" and not joinp:
                kind = "cross"
            return L.Join(kind, left, right, E.make_and(joinp) if joinp else None,
                          op.mark_col)
        if op.kind in ("semi", "anti", "mark", "single", "left"):
            # left-side-only predicates can push into the left child
            lp, stay = _split(preds, lambda p: E.used_cols(p) <= lcids)
            left = _push(op.left, lp)
            right = _push(op.right, [])
            j = L.Join(op.kind, left, right, op.predicate, op.mark_col,
                       op.null_aware)
            return _wrap(j, stay)
        # full outer: nothing pushes
        left = _push(op.left, [])
        right = _push(op.right, [])
        return _wrap(L.Join(op.kind, left, right, op.predicate, op.mark_col), preds)
    if isinstance(op, (L.Sort, L.Limit, L.TopK, L.Distinct)):
        # limit/topk change semantics; apply preds above
        child = _push(op.children()[0], [] if isinstance(op, (L.Limit, L.TopK)) else preds)
        out = op.replace_children([child])
        return _wrap(out, preds if isinstance(op, (L.Limit, L.TopK)) else [])
    if isinstance(op, L.Aggregate):
        group_cids = set(op.group_by)
        down, stay = _split(preds, lambda p: E.used_cols(p) <= group_cids)
        child = _push(op.child, down)
        return _wrap(op.replace_children([child]), stay)
    if isinstance(op, L.SetOp):
        # conservatively keep above (mapping cids through is a later pass)
        l = _push(op.left, [])
        r = _push(op.right, [])
        return _wrap(op.replace_children([l, r]), preds)
    if isinstance(op, L.Window):
        child = _push(op.child, [])
        return _wrap(op.replace_children([child]), preds)
    if isinstance(op, L.Materialize):
        return L.Materialize(_push(op.child, preds), op.cids, op.names)
    if isinstance(op, L.Iterate):
        # optimize inside the loop, but never move predicates across the
        # fixpoint boundary (they would change which rows recurse)
        return _wrap(op.replace_children(
            [_push(op.base, []), _push(op.step, [])]), preds)
    # leaves: Scan / ConstRel / IterRef
    return _wrap(op, preds)


def _split(preds, f):
    yes, no = [], []
    for p in preds:
        (yes if f(p) else no).append(p)
    return yes, no


def _wrap(op: L.LogicalOp, preds: list[BExpr]) -> L.LogicalOp:
    if not preds:
        return op
    return L.Select(op, E.make_and(preds))


# ------------------------------------------------------- constant folding
def fold_constants(plan: L.LogicalOp) -> None:
    """Replace, in place, every column-free Call, Cast and CASE of the
    plan's expressions by its value, computed once on the host by the scalar
    operators (ops/consteval.py::fold); an error a constant raises ("integer
    out of range") is raised here, whatever the rows, as PostgreSQL raises
    it when it folds the constant. The executor folds the plan it is given
    (Executor.execute), so EXPLAIN and the plan's JSON show the optimized
    plan as written; in place, so the operators keep their identity
    (EXPLAIN ANALYZE's row counts)."""
    from ..ops.consteval import fold

    todo, seen = [plan], set()
    while todo:
        node = todo.pop()
        todo.extend(node.children())
        if isinstance(node, L.Tmp) and node.holder.plan is not None and id(
                node.holder) not in seen:
            seen.add(id(node.holder))
            todo.append(node.holder.plan)
        elif isinstance(node, L.Scan):
            node.restrictions = [fold(r) for r in node.restrictions]
        elif isinstance(node, L.Select):
            node.predicate = fold(node.predicate)
        elif isinstance(node, L.Map):
            node.computed = [(c, fold(e)) for c, e in node.computed]
        elif isinstance(node, L.Join):
            if node.predicate is not None:
                node.predicate = fold(node.predicate)
            if node.null_aware is not None:
                na = node.null_aware
                node.null_aware = (fold(na[0]),) + tuple(na[1:])
        elif isinstance(node, L.Window):
            for f in node.funcs:
                if f.default is not None:
                    f.default = fold(f.default)


# -------------------------------------------------- scan restriction folding
def fold_scan_restrictions(plan: L.LogicalOp) -> L.LogicalOp:
    """Move simple single-column predicates directly above scans into the scan
    node (reference: pushed-down scan filters, src/runtime/storage/
    Restrictions.cpp — vectorized selection applied during the scan)."""
    if isinstance(plan, L.Select):
        child = fold_scan_restrictions(plan.child)
        if isinstance(child, L.Scan):
            scan_cids = {c.cid for c in child.cols}
            into, stay = _split(
                E.conjuncts(plan.predicate),
                lambda p: E.used_cols(p) <= scan_cids and _is_simple(p),
            )
            if into:
                child = L.Scan(child.table, child.cols, child.restrictions + into)
            return _wrap(child, stay)
        return L.Select(child, plan.predicate)
    new_children = [fold_scan_restrictions(c) for c in plan.children()]
    if not new_children:
        return plan
    return plan.replace_children(new_children)


def _is_simple(p: BExpr) -> bool:
    from ..plan.exprs import Call, CaseExpr

    for node in E.walk(p):
        if isinstance(node, CaseExpr):
            return False
    return True


# ----------------------------------------------------- infer-not-null
_STRICT_CMP = {"eq", "neq", "lt", "lte", "gt", "gte"}


def infer_not_null(plan: L.LogicalOp) -> L.LogicalOp:
    """Add `x IS NOT NULL` conjuncts for nullable columns that appear directly
    in strict (null-rejecting) comparisons inside Select predicates
    (reference: Transforms/InferNotNullConditions.cpp — cmp/between/oneof
    operands gain NOT NULL checks when AND-ed into the result). The extra
    conjuncts then push to scans and sharpen sample-based selectivities."""
    from ..plan.exprs import Call, ColRef
    from ..sql.types import Type

    def rec(op: L.LogicalOp) -> L.LogicalOp:
        kids = op.children()
        if kids:
            op = op.replace_children([rec(c) for c in kids])
        if not isinstance(op, L.Select):
            return op
        conj = E.conjuncts(op.predicate)
        have = {repr(c) for c in conj}
        extra: list[BExpr] = []

        def note(a):
            if isinstance(a, ColRef) and a.type.nullable:
                nn = Call("isnotnull", [a], Type.bool_(False))
                if repr(nn) not in have:
                    have.add(repr(nn))
                    extra.append(nn)

        for c in conj:
            if isinstance(c, Call) and c.op in _STRICT_CMP:
                for a in c.args:
                    note(a)
            elif isinstance(c, Call) and c.op == "in":
                # col IN (v1..vn): null-rejecting when no vi is NULL
                from ..plan.exprs import Const

                if all(isinstance(x, (Const, ColRef)) and (
                        not isinstance(x, Const) or x.value is not None)
                       and not x.type.nullable
                       for x in c.args[1:]):
                    note(c.args[0])
        if extra:
            return L.Select(op.child, E.make_and(conj + extra))
        return op

    return rec(plan)


# ----------------------------------------------------- trivial-join removal
def _child_reqs(op: L.LogicalOp, req: set[int]) -> list[set[int]]:
    """Required-cid set per child given cids required of `op` (consumption
    rules mirror prune.rec, opt/prune.py; conservative for Aggregate/Window:
    all outputs assumed live — column-folding runs later)."""
    if isinstance(op, L.Materialize):
        return [set(op.cids)]
    if isinstance(op, L.Select):
        return [req | E.used_cols(op.predicate)]
    if isinstance(op, L.Map):
        creq = set(req) - {c.cid for c, _e in op.computed}
        for c, e in op.computed:
            if c.cid in req:
                creq |= E.used_cols(e)
        return [creq]
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
        return [used & lcids, used & rcids]
    if isinstance(op, L.Aggregate):
        creq = set(op.group_by)
        creq |= {a.arg for a in op.aggs if a.arg is not None}
        return [creq]
    if isinstance(op, (L.Sort, L.TopK)):
        return [req | {k.cid for k in op.keys}]
    if isinstance(op, L.Limit):
        return [req]
    if isinstance(op, L.Distinct):
        return [req | set(op.cids)]
    if isinstance(op, L.SetOp):
        return [set(op.lmap), set(op.rmap)]
    if isinstance(op, L.Window):
        creq = set(req) - {f.out.cid for f in op.funcs}
        creq |= set(op.partition_by) | {k.cid for k in op.order_by}
        creq |= {f.arg for f in op.funcs if f.arg is not None}
        return [creq]
    # Iterate / unknown: require every child output (never eliminates below)
    return [{c.cid for c in ch.output_cols()} for ch in op.children()]


def eliminate_trivial_join(plan: L.LogicalOp, catalog) -> L.LogicalOp:
    """Drop left/single joins that nobody consumes: no right output column is
    required above, and the join cannot change the left row count — single
    joins by definition (exactly one output row per left row), left joins
    when the right equi-key columns form a duplicate-free key of the right
    side (reference: Transforms/EliminateTrivialJoin.cpp — OuterJoinOp with
    empty mapping + isDuplicateFreeKey(right keys))."""
    from .constraints import _eq_col_pairs, collect_fds

    def rec(op: L.LogicalOp, req: set[int]) -> L.LogicalOp:
        if (isinstance(op, L.Join) and op.kind in ("left", "single")
                and op.null_aware is None):
            rcids = {c.cid for c in op.right.output_cols()}
            if not (req & rcids):
                drop = op.kind == "single"
                if not drop:
                    rkeys = {b if b in rcids else a
                             for a, b in _eq_col_pairs(op.predicate)
                             if (a in rcids) != (b in rcids)}
                    if rkeys:
                        fds = collect_fds(op.right, catalog)
                        drop = (fds.key is not None
                                and fds.key <= fds.expand(set(rkeys)))
                if drop:
                    return rec(op.left, req)
        kids = op.children()
        if not kids:
            return op
        return op.replace_children(
            [rec(c, r) for c, r in zip(kids, _child_reqs(op, req))])

    return rec(plan, {c.cid for c in plan.output_cols()})


# ------------------------------------------------- lateral decorrelation
def _node_exprs(op) -> list:
    """Expressions evaluated directly by a plan node."""
    out = []
    if isinstance(op, L.Select):
        out.append(op.predicate)
    elif isinstance(op, L.Map):
        out.extend(e for _c, e in op.computed)
    elif isinstance(op, L.Join) and op.predicate is not None:
        out.append(op.predicate)
    elif isinstance(op, L.Scan):
        out.extend(op.restrictions)
    return out


def _free_cids(op, produced: set[int] | None = None) -> set[int]:
    """cids referenced somewhere in the subtree but not produced inside it."""
    refs: set[int] = set()
    local: set[int] = set()

    def walk(n):
        for e in _node_exprs(n):
            refs.update(E.used_cols(e))
        local.update(c.cid for c in n.output_cols())
        if isinstance(n, L.Map):
            local.update(c.cid for c, _e in n.computed)
        if isinstance(n, L.Aggregate):
            local.update(a.out.cid for a in n.aggs)
        for c in n.children():
            walk(c)

    walk(op)
    return refs - local


def _hoist_correlated(op, lateral: set[int]):
    """Remove Select conjuncts referencing `lateral` cids from the spine of
    `op` (through Select/Map, and through the outer-preserving side of
    joins). Returns (new_op, hoisted_conjuncts, ok)."""
    if isinstance(op, L.Select):
        child, hoisted, ok = _hoist_correlated(op.child, lateral)
        if not ok:
            return op, [], False
        stay, lift = [], []
        for c in E.conjuncts(op.predicate):
            (lift if E.used_cols(c) & lateral else stay).append(c)
        out = L.Select(child, E.make_and(stay)) if stay else child
        return out, hoisted + lift, True
    if isinstance(op, L.Map):
        child, hoisted, ok = _hoist_correlated(op.child, lateral)
        if not ok:
            return op, [], False
        return L.Map(child, op.computed), hoisted, True
    if isinstance(op, L.Join) and op.kind in ("inner", "cross", "left"):
        l, hl, okl = _hoist_correlated(op.left, lateral)
        if not okl:
            return op, [], False
        if op.kind in ("inner", "cross"):
            r, hr, okr = _hoist_correlated(op.right, lateral)
            if not okr:
                return op, [], False
            return L.Join(op.kind, l, r, op.predicate), hl + hr, True
        return L.Join(op.kind, l, op.right, op.predicate), hl, True
    # any other node: sound only if nothing below references lateral cids
    if _free_cids(op) & lateral:
        return op, [], False
    return op, [], True


def decorrelate_lateral(op: L.LogicalOp) -> L.LogicalOp:
    """Rewrite comma-FROM lateral references (a derived table referencing an
    earlier FROM item) into plain join predicates where the correlated
    conjuncts sit in hoistable Select positions (reference: general dependent
    joins are handled by relalg Unnesting, Transforms/Unnesting.cpp; this
    covers the SQL-level lateral pattern the tpcxbb suite uses)."""
    op = op.replace_children([decorrelate_lateral(c) for c in op.children()])
    if isinstance(op, L.Join) and op.kind in ("cross", "inner"):
        lcids = {c.cid for c in op.left.output_cols()}
        lateral = _free_cids(op.right) & lcids
        if lateral:
            right, hoisted, ok = _hoist_correlated(op.right, lateral)
            if ok and hoisted and not (_free_cids(right) & lcids):
                parts = ([op.predicate] if op.predicate is not None else []) + hoisted
                return L.Join("inner", op.left, right, E.make_and(parts))
    return op
