"""Analyzer/binder: AST -> typed logical plan.

Equivalent of the reference's SQLQueryAnalyzer + SQLMlirTranslator
(reference: src/compiler/frontend/sql_analyzer.cpp — scoping, name resolution,
type inference/coercion; src/compiler/frontend/sql_mlir_translator.cpp —
bound AST -> relalg trees). Instead of emitting MLIR, binding produces the
logical plan IR in plan/logical.py directly, and subqueries are decorrelated
into join variants during binding (the reference does this in later
ImplicitToExplicitJoins/Unnesting passes, src/compiler/Dialect/RelAlg/
Transforms/Unnesting.cpp).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import BExpr, Call, CaseExpr, Cast, ColRef, Const
from ..plan.logical import ColInfo
from . import ast as A
from .types import IntervalUnit, K, Type, common_numeric


class BindError(Exception):
    pass


def _references_cte(node, name: str) -> bool:
    """Does this AST subtree contain a table reference to `name`?
    (Generic dataclass walk; a nested WITH redefining the name shadows it.)"""
    import dataclasses

    lname = name.lower()

    def walk(x) -> bool:
        if isinstance(x, A.BaseTableRef):
            return x.name.lower() == lname
        if isinstance(x, A.SelectStmt) and any(
                c.name.lower() == lname for c in x.ctes):
            # shadowed: only the shadowing CTE definitions themselves may
            # still reference the outer name (standard scoping)
            return any(walk(c.query) for c in x.ctes)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return any(walk(getattr(x, f.name)) for f in dataclasses.fields(x))
        if isinstance(x, (list, tuple)):
            return any(walk(v) for v in x)
        return False

    return walk(node)


# the row count of an OFFSET given without a LIMIT: every row that is left
NO_LIMIT = 1 << 62

# ----------------------------------------------------------------- aggregates
AGG_FNS = {
    "sum", "count", "avg", "min", "max", "stddev_samp", "var_samp",
    "bool_and", "bool_or", "any_value", "string_agg",
}
WINDOW_ONLY_FNS = {
    "rank", "dense_rank", "row_number", "lead", "lag", "first_value",
    "last_value", "nth_value", "ntile", "percent_rank", "cume_dist",
}


@dataclass
class AggMarker(BExpr):
    """Placeholder for an aggregate call inside a bound expression; replaced
    with a ColRef to the Aggregate op's output during select binding."""

    fn: str
    arg: Optional[BExpr]
    distinct: bool
    type: Type


# ----------------------------------------------------------------- scope
@dataclass
class TableBinding:
    alias: str
    cols: list[ColInfo]  # in definition order; names lowercased


class Scope:
    """Name-resolution scope. Child scopes (subqueries) see parent bindings;
    resolving through a parent records the access as correlated."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.tables: list[TableBinding] = []
        self.ctes: dict[str, tuple[L.LogicalOp, list[ColInfo]]] = (
            dict(parent.ctes) if parent else {}
        )

    def add(self, binding: TableBinding):
        self.tables.append(binding)

    def all_cols(self) -> list[ColInfo]:
        out = []
        for t in self.tables:
            out.extend(t.cols)
        return out

    def resolve(self, parts: list[str]) -> tuple[ColInfo, bool]:
        """Resolve a (possibly qualified) column name.
        Returns (colinfo, is_correlated)."""
        hits = self._resolve_local(parts)
        if len(hits) == 1:
            return hits[0], False
        if len(hits) > 1:
            raise BindError(f"ambiguous column reference {'.'.join(parts)}")
        if self.parent is not None:
            info, _ = self.parent.resolve(parts)
            return info, True
        raise BindError(f"unknown column {'.'.join(parts)}")

    def _resolve_local(self, parts: list[str]) -> list[ColInfo]:
        hits = []
        if len(parts) == 1:
            name = parts[0]
            for t in self.tables:
                for c in t.cols:
                    if c.name == name:
                        hits.append(c)
        else:
            tab, name = parts[-2], parts[-1]
            for t in self.tables:
                if t.alias == tab:
                    for c in t.cols:
                        if c.name == name:
                            hits.append(c)
        return hits


# ----------------------------------------------------------------- binder
class Binder:
    """Stateful binder: issues fresh column ids, resolves against a catalog.

    `catalog` must provide get_table(name) -> object with .column_names,
    .column_types (or None)."""

    def __init__(self, catalog):
        self.catalog = catalog
        self._next_cid = 0
        self._col_info: dict[int, ColInfo] = {}

    def fresh(self, name: str, t: Type) -> ColInfo:
        cid = self._next_cid
        self._next_cid += 1
        info = ColInfo(cid, name, t)
        self._col_info[cid] = info
        return info

    # -------------------------------------------------------------- top level
    def bind_query(self, stmt: A.SelectStmt) -> L.Materialize:
        scope = Scope()
        plan, cols = self.bind_select(stmt, scope)
        names = [c.name for c in cols]
        return L.Materialize(plan, [c.cid for c in cols], names)

    # -------------------------------------------------------------- select
    def bind_select(self, stmt: A.SelectStmt, scope: Scope) -> tuple[L.LogicalOp, list[ColInfo]]:
        # CTEs register into this scope (visible to subqueries too)
        for cte in stmt.ctes:
            if (cte.recursive and cte.query.set_op in ("union", "union_all")
                    and _references_cte(cte.query.right, cte.name)):
                plan, cols = self.bind_recursive_cte(cte, scope)
                scope.ctes[cte.name] = (plan, cols)
                continue
            sub_scope = Scope(scope)
            plan, cols = self.bind_select(cte.query, sub_scope)
            if cte.column_aliases:
                cols = [
                    ColInfo(c.cid, a, c.type)
                    for c, a in zip(cols, cte.column_aliases)
                ] + cols[len(cte.column_aliases):]
            scope.ctes[cte.name] = (plan, cols)

        if stmt.set_op is not None:
            return self.bind_setop(stmt, scope)
        if stmt.values is not None:
            return self.bind_values(stmt.values, scope, alias="values")
        return self.bind_select_core(stmt, scope)

    def bind_recursive_cte(self, cte: A.CTE, scope: Scope):
        """WITH RECURSIVE name AS (base UNION [ALL] step): lowers to the
        Iterate fixpoint operator (reference capability: subop.loop,
        SubOperatorOps.td:937-953 — the reference has no SQL surface for it;
        we expose recursive CTEs on top). Column names/types come from the
        non-recursive term (standard SQL); the step may be any plan
        (joins, aggregates, window functions) over the self-reference."""
        q = cte.query
        if _references_cte(q.left, cte.name):
            raise BindError(
                f"recursive reference to {cte.name!r} in the "
                f"non-recursive term")
        base_plan, base_cols = self.bind_select(q.left, Scope(scope))
        names = list(cte.column_aliases) + [
            c.name for c in base_cols[len(cte.column_aliases):]]
        out_cols = [self.fresh(n, c.type) for n, c in zip(names, base_cols)]
        holder = L.IterateHolder()
        template = L.IterRef(holder, list(out_cols))

        step_scope = Scope(scope)
        step_scope.ctes[cte.name] = (template, out_cols)
        step_plan, step_cols = self.bind_select(q.right, step_scope)
        if len(step_cols) != len(base_cols):
            raise BindError(
                f"recursive CTE {cte.name!r}: column count mismatch between "
                f"terms ({len(base_cols)} vs {len(step_cols)})")
        casts, smap = [], []
        for oc, sc_ in zip(out_cols, step_cols):
            if sc_.type.base_eq(oc.type):
                smap.append(sc_.cid)
            else:
                nc = self.fresh(sc_.name, oc.type)
                casts.append((nc, Cast(ColRef(sc_.cid, sc_.type), oc.type)))
                smap.append(nc.cid)
        if casts:
            step_plan = L.Map(step_plan, casts)
        from ..utils.settings import MAX_RECURSION

        plan: L.LogicalOp = L.Iterate(
            holder, base_plan, step_plan, out_cols,
            distinct=(q.set_op == "union"),
            lmap=[c.cid for c in base_cols], smap=smap,
            max_iters=MAX_RECURSION.get() or (1 << 62))
        if q.order_by or q.limit is not None:
            sscope = Scope(scope)
            sscope.add(TableBinding("", out_cols))
            plan, out_cols = self._apply_order_limit(
                plan, out_cols, q, sscope, out_cols)
        return plan, out_cols

    def bind_setop(self, stmt: A.SelectStmt, scope: Scope):
        lplan, lcols = self.bind_select(stmt.left, Scope(scope))
        rplan, rcols = self.bind_select(stmt.right, Scope(scope))
        if len(lcols) != len(rcols):
            raise BindError("set operation column count mismatch")
        out_cols, lmap, rmap = [], [], []
        lcasts, rcasts = [], []
        for lc, rc in zip(lcols, rcols):
            t = self.common_type(lc.type, rc.type)
            t = t.as_nullable(lc.type.nullable or rc.type.nullable)
            lcid, rcid = lc.cid, rc.cid
            if not lc.type.base_eq(t):
                nc = self.fresh(lc.name, t)
                lcasts.append((nc, Cast(ColRef(lc.cid, lc.type), t)))
                lcid = nc.cid
            if not rc.type.base_eq(t):
                nc = self.fresh(rc.name, t)
                rcasts.append((nc, Cast(ColRef(rc.cid, rc.type), t)))
                rcid = nc.cid
            out_cols.append(self.fresh(lc.name, t))
            lmap.append(lcid)
            rmap.append(rcid)
        if lcasts:
            lplan = L.Map(lplan, lcasts)
        if rcasts:
            rplan = L.Map(rplan, rcasts)
        kind = stmt.set_op
        all_ = kind.endswith("_all")
        kind = kind.removesuffix("_all")
        plan = L.SetOp(kind, all_, lplan, rplan, out_cols, lmap, rmap)
        # order/limit/offset over the set-op result; ORDER BY names resolve
        # against the left branch's output names
        sscope = Scope(scope)
        sscope.add(TableBinding("", out_cols))
        return self._apply_order_limit(plan, out_cols, stmt, sscope, out_cols)

    def bind_values(self, rows: list[list[A.Expr]], scope: Scope, alias: str, column_aliases=None):
        bound_rows = []
        ncols = len(rows[0])
        types: list[Optional[Type]] = [None] * ncols
        for row in rows:
            if len(row) != ncols:
                raise BindError("VALUES rows have differing lengths")
            brow = []
            for i, e in enumerate(row):
                b = self.bind_scalar(e, Scope(scope))
                brow.append(b)
                if b.type.kind != K.NULL:
                    types[i] = (
                        b.type if types[i] is None else self.common_type(types[i], b.type)
                    )
            bound_rows.append(brow)
        types = [t if t is not None else Type.int_(True) for t in types]
        nullable = [
            any(r[i].type.kind == K.NULL or r[i].type.nullable for r in bound_rows)
            for i in range(ncols)
        ]
        names = column_aliases or [f"col{i}" for i in range(ncols)]
        cols = [
            self.fresh(n, t.as_nullable(nl))
            for n, t, nl in zip(names, types, nullable)
        ]
        pyrows = []
        for brow in bound_rows:
            pr = []
            for b, c in enumerate(brow):
                pass
            pr = [self.const_value(b, cols[i].type) for i, b in enumerate(brow)]
            pyrows.append(pr)
        return L.ConstRel(cols, pyrows), cols

    def const_value(self, b: BExpr, t: Type):
        """Evaluate a constant expression to a python value coerced to t."""
        from ..ops.consteval import eval_const

        return eval_const(b, t)

    def const_int(self, e: A.Expr) -> int:
        b = self.bind_scalar(e, Scope())
        from ..ops.consteval import eval_const

        v = eval_const(b, Type.bigint())
        if v is None:
            raise BindError("expected integer constant")
        return int(v)

    # ------------------------------------------------------------ FROM clause
    def bind_from(self, refs: list[A.TableRef], scope: Scope) -> L.LogicalOp:
        plan = None
        for ref in refs:
            p = self.bind_table_ref(ref, scope)
            plan = p if plan is None else L.Join("cross", plan, p, None)
        if plan is None:
            # SELECT without FROM: single-row dummy relation
            plan = L.ConstRel([], [[]])
        return plan

    def bind_table_ref(self, ref: A.TableRef, scope: Scope) -> L.LogicalOp:
        if isinstance(ref, A.BaseTableRef):
            alias = ref.alias or ref.name
            if ref.name in scope.ctes:
                plan, cols = self.instantiate_cte(ref.name, scope)
                scope.add(TableBinding(alias, cols))
                return plan
            views = getattr(self.catalog, "views", {})
            if ref.name in views:
                sub_scope = Scope(scope)
                plan, cols = self.bind_select(views[ref.name], sub_scope)
                scope.add(TableBinding(alias, cols))
                return plan
            entry = self.catalog.get_table(ref.name)
            if entry is None:
                raise BindError(f"unknown table {ref.name!r}")
            cols = [
                self.fresh(n, t)
                for n, t in zip(entry.column_names, entry.column_types)
            ]
            scope.add(TableBinding(alias, cols))
            return L.Scan(ref.name, cols)
        if isinstance(ref, A.SubqueryRef):
            sub_scope = Scope(scope)
            plan, cols = self.bind_select(ref.subquery, sub_scope)
            if ref.column_aliases:
                cols = [
                    ColInfo(c.cid, a, c.type)
                    for c, a in zip(cols, ref.column_aliases)
                ]
            scope.add(TableBinding(ref.alias, cols))
            return plan
        if isinstance(ref, A.ValuesRef):
            plan, cols = self.bind_values(ref.rows, scope, ref.alias, ref.column_aliases)
            scope.add(TableBinding(ref.alias, cols))
            return plan
        if isinstance(ref, A.JoinRef):
            return self.bind_join(ref, scope)
        raise BindError(f"unsupported table ref {type(ref).__name__}")

    def instantiate_cte(self, name: str, scope: Scope):
        """Clone the CTE plan with fresh column ids so multiple uses are
        independent (reference materializes shared subtrees via relalg.tmp /
        IntroduceTmp; we re-expand and let CSE/caching handle reuse later)."""
        plan, cols = scope.ctes[name]
        mapping: dict[int, int] = {}
        new_plan = self.clone_plan(plan, mapping)
        new_cols = [
            ColInfo(mapping.get(c.cid, c.cid), c.name, c.type) for c in cols
        ]
        return new_plan, new_cols

    def clone_plan(self, op: L.LogicalOp, mapping: dict[int, int]) -> L.LogicalOp:
        """Deep-copy a plan, assigning fresh cids to every defined column."""

        def m(e: BExpr) -> BExpr:
            return E.map_cols(e, mapping)

        def mc(c: ColInfo) -> ColInfo:
            if c.cid not in mapping:
                mapping[c.cid] = self.fresh(c.name, c.type).cid
            return ColInfo(mapping[c.cid], c.name, c.type)

        if isinstance(op, L.Scan):
            return L.Scan(op.table, [mc(c) for c in op.cols], [m(r) for r in op.restrictions])
        if isinstance(op, L.ConstRel):
            return L.ConstRel([mc(c) for c in op.cols], [list(r) for r in op.rows])
        children = [self.clone_plan(c, mapping) for c in op.children()]
        if isinstance(op, L.Select):
            return L.Select(children[0], m(op.predicate))
        if isinstance(op, L.Map):
            return L.Map(children[0], [(mc(c), m(e)) for c, e in op.computed])
        if isinstance(op, L.Join):
            na = op.null_aware
            return L.Join(
                op.kind, children[0], children[1],
                None if op.predicate is None else m(op.predicate),
                mc(op.mark_col) if op.mark_col else None,
                None if na is None else tuple(m(x) for x in na),
            )
        if isinstance(op, L.Aggregate):
            return L.Aggregate(
                children[0],
                [mapping.get(g, g) for g in op.group_by],
                [
                    L.AggSpec(mc(a.out), a.fn, None if a.arg is None else mapping.get(a.arg, a.arg), a.distinct)
                    for a in op.aggs
                ],
                [ColInfo(mapping.get(c.cid, c.cid), c.name, c.type) for c in op.group_cols],
            )
        if isinstance(op, L.Sort):
            return L.Sort(children[0], [L.SortKey(mapping.get(k.cid, k.cid), k.ascending, k.nulls_first) for k in op.keys])
        if isinstance(op, L.Limit):
            return L.Limit(children[0], op.n, op.offset)
        if isinstance(op, L.TopK):
            return L.TopK(children[0], [L.SortKey(mapping.get(k.cid, k.cid), k.ascending, k.nulls_first) for k in op.keys], op.n, op.offset)
        if isinstance(op, L.Distinct):
            return L.Distinct(children[0], [mapping.get(c, c) for c in op.cids])
        if isinstance(op, L.SetOp):
            return L.SetOp(
                op.kind, op.all, children[0], children[1],
                [mc(c) for c in op.cols],
                [mapping.get(c, c) for c in op.lmap],
                [mapping.get(c, c) for c in op.rmap],
            )
        if isinstance(op, L.Window):
            return L.Window(
                children[0],
                [mapping.get(p, p) for p in op.partition_by],
                [L.SortKey(mapping.get(k.cid, k.cid), k.ascending, k.nulls_first) for k in op.order_by],
                [L.WindowFn(mc(f.out), f.fn, None if f.arg is None else mapping.get(f.arg, f.arg), f.extra, f.default) for f in op.funcs],
                op.frame_start, op.frame_end, op.frame_mode,
            )
        if isinstance(op, L.Materialize):
            return L.Materialize(children[0], [mapping.get(c, c) for c in op.cids], list(op.names))
        if isinstance(op, L.IterRef):
            # holder identity is shared across clones: CSE can then collapse
            # duplicate references to one materialized fixpoint
            return L.IterRef(op.holder, [mc(c) for c in op.cols])
        if isinstance(op, L.Iterate):
            return L.Iterate(
                op.holder, children[0], children[1], [mc(c) for c in op.cols],
                op.distinct,
                [mapping.get(c, c) for c in op.lmap],
                [mapping.get(c, c) for c in op.smap],
                op.emit, op.max_iters,
            )
        raise BindError(f"cannot clone {type(op).__name__}")

    def bind_join(self, ref: A.JoinRef, scope: Scope) -> L.LogicalOp:
        kind = ref.kind
        swap = kind == "right"
        if swap:
            kind = "left"
            lref, rref = ref.right, ref.left
        else:
            lref, rref = ref.left, ref.right
        # inner scopes: each side resolves its own names first; the parent
        # chain keeps earlier FROM items visible so derived tables may
        # reference them laterally (tpcxbb q16 style; decorrelated by the
        # optimizer's lateral pass)
        lscope = Scope(scope)
        lscope.ctes = scope.ctes
        lplan = self.bind_table_ref(lref, lscope)
        rscope = Scope(scope)
        rscope.ctes = scope.ctes
        rplan = self.bind_table_ref(rref, rscope)

        # condition resolves against both sides (plus outer scope)
        cond_scope = Scope(scope.parent)
        cond_scope.ctes = scope.ctes
        for t in lscope.tables + rscope.tables:
            cond_scope.add(t)

        pred = None
        if ref.natural or ref.using:
            names = ref.using or sorted(
                {c.name for t in lscope.tables for c in t.cols}
                & {c.name for t in rscope.tables for c in t.cols}
            )
            parts = []
            for n in names:
                lc = Scope._resolve_local(lscope, [n])
                rc = Scope._resolve_local(rscope, [n])
                if not lc or not rc:
                    raise BindError(f"USING column {n} not present on both sides")
                parts.append(self.make_cmp("eq", ColRef(lc[0].cid, lc[0].type), ColRef(rc[0].cid, rc[0].type)))
            pred = E.make_and(parts)
        elif ref.condition is not None:
            if kind == "inner" and _ast_has_subquery(ref.condition):
                # subqueries in an INNER join condition: rewrite as
                # cross-product + filter so the subquery machinery (single /
                # mark joins, inlining, unnesting) applies unchanged
                # (reference: ImplicitToExplicitJoins works on the selection)
                cross = L.Join("cross", lplan, rplan, None)
                plan2, pred_b = self.bind_scalar_with_subqueries(
                    ref.condition, cond_scope, cross)
                for t in lscope.tables + rscope.tables:
                    scope.add(t)
                return L.Select(plan2, pred_b)
            pred, lplan, rplan = self.bind_join_condition(ref.condition, cond_scope, lplan, rplan)

        if kind == "cross" and pred is None:
            plan = L.Join("cross", lplan, rplan, None)
        else:
            plan = L.Join(kind if pred is not None or kind != "inner" else "cross", lplan, rplan, pred)
        for t in lscope.tables + rscope.tables:
            scope.add(t)
        return plan

    def bind_join_condition(self, cond: A.Expr, scope: Scope, lplan, rplan):
        """Bind an ON condition. Subqueries inside join conditions are rare;
        support scalar/uncorrelated by attaching to the right side."""
        pred = self.bind_scalar(cond, scope)
        return pred, lplan, rplan

    # --------------------------------------------------------- select core
    def bind_select_core(self, stmt: A.SelectStmt, scope: Scope):
        plan = self.bind_from(stmt.from_refs, scope)

        if stmt.where is not None:
            plan = self.bind_where(stmt.where, scope, plan)

        # expand stars and assemble raw select items
        items: list[tuple[A.Expr, Optional[str]]] = []
        for it in stmt.items:
            if isinstance(it.expr, A.Star):
                for t in scope.tables:
                    if it.expr.table is None or t.alias == it.expr.table:
                        for c in t.cols:
                            items.append((None, c.name, c))
                if it.expr.table is not None and not any(
                    t.alias == it.expr.table for t in scope.tables
                ):
                    raise BindError(f"unknown table {it.expr.table} in star")
            else:
                items.append((it.expr, it.alias, None))

        alias_map = {
            a: e for e, a, c in items if a is not None and e is not None
        }

        # resolve group-by (aliases + ordinals allowed)
        group_exprs_ast: list[A.Expr] = []
        for g in stmt.group_by:
            g = self._substitute_alias(g, alias_map, items)
            group_exprs_ast.append(g)

        has_agg = any(
            e is not None and self._contains_agg(e) for e, _, _ in items
        ) or (stmt.having is not None and self._contains_agg(stmt.having)) or any(
            self._contains_agg(o.expr) for o in stmt.order_by
        )

        agg_out_cols = None
        if group_exprs_ast or has_agg:
            plan, group_repl, agg_collect = self._bind_aggregation(
                plan, scope, group_exprs_ast, stmt, alias_map, items
            )
        else:
            group_repl, agg_collect = None, None

        if stmt.having is not None and not (group_exprs_ast or has_agg):
            raise BindError("HAVING without aggregation")

        # window functions evaluate after aggregation
        plan = self._bind_windows(plan, scope, stmt, items, group_repl, agg_collect)

        # bind output expressions (post-aggregate space)
        out_cols: list[ColInfo] = []
        computed: list[tuple[ColInfo, BExpr]] = []
        bound_items: list[BExpr] = []
        post_agg_ctx = (group_repl, agg_collect) if (group_repl is not None or agg_collect is not None) else None
        for e, alias, direct in items:
            if direct is not None:
                out_cols.append(ColInfo(direct.cid, alias or direct.name, direct.type))
                bound_items.append(ColRef(direct.cid, direct.type))
                continue
            plan, b = self.bind_scalar_with_subqueries(e, scope, plan, post_agg=post_agg_ctx)
            name = alias or self._default_name(e)
            if isinstance(b, ColRef):
                out_cols.append(ColInfo(b.cid, name, b.type))
            else:
                c = self.fresh(name, b.type)
                computed.append((c, b))
                out_cols.append(c)
            bound_items.append(b)

        if computed:
            plan = L.Map(plan, computed)
            computed = []

        # having (after select-expr binding so aliases work inside? SQL says no,
        # but bind HAVING in post-agg space)
        if stmt.having is not None:
            plan, h = self.bind_scalar_with_subqueries(
                stmt.having, scope, plan, post_agg=post_agg_ctx
            )
            plan = L.Select(plan, h)

        if stmt.distinct:
            plan = L.Distinct(plan, [c.cid for c in out_cols])

        plan, out_cols = self._apply_order_limit(
            plan, out_cols, stmt, scope, out_cols, group_repl, agg_collect,
            alias_map,
        )
        return plan, out_cols

    def _apply_order_limit(self, plan, out_cols, stmt, scope, select_cols,
                           group_repl=None, agg_collect=None, alias_map=None):
        offset = self.const_int(stmt.offset) if stmt.offset else 0
        if stmt.order_by:
            keys = []
            computed = []
            for o in stmt.order_by:
                e = o.expr
                # ordinal
                if isinstance(e, A.Literal) and isinstance(e.value, int) and e.type_hint is None:
                    idx = e.value - 1
                    if not (0 <= idx < len(select_cols)):
                        raise BindError(f"ORDER BY position {e.value} out of range")
                    keys.append(L.SortKey(select_cols[idx].cid, o.ascending, o.nulls_first))
                    continue
                # alias
                if isinstance(e, A.ColumnRef) and len(e.parts) == 1:
                    hit = [c for c in select_cols if c.name == e.parts[0]]
                    if hit:
                        keys.append(L.SortKey(hit[0].cid, o.ascending, o.nulls_first))
                        continue
                if alias_map:
                    e = self._substitute_alias_deep(e, alias_map, scope)
                b = self.bind_post_agg(e, scope, group_repl, agg_collect)
                if isinstance(b, ColRef):
                    keys.append(L.SortKey(b.cid, o.ascending, o.nulls_first))
                else:
                    c = self.fresh("__sortkey", b.type)
                    computed.append((c, b))
                    keys.append(L.SortKey(c.cid, o.ascending, o.nulls_first))
            if computed:
                plan = L.Map(plan, computed)
            if stmt.limit is not None:
                return L.TopK(plan, keys, self.const_int(stmt.limit),
                              offset), out_cols
            plan = L.Sort(plan, keys)
        if stmt.limit is not None or offset:
            # an OFFSET without a LIMIT skips rows and keeps all the rest
            plan = L.Limit(plan, NO_LIMIT if stmt.limit is None
                           else self.const_int(stmt.limit), offset)
        return plan, out_cols

    def _substitute_alias_deep(self, e: A.Expr, alias_map, scope) -> A.Expr:
        """Replace select-aliases nested anywhere inside an ORDER BY expression
        with their select expression — but only where the name does not
        resolve as a real column (real columns shadow aliases, as in the
        reference's analyzer). Needed for TPC-DS patterns like
        `order by case when lochierarchy = 0 then i_category end`."""
        import copy

        if isinstance(e, A.ColumnRef) and len(e.parts) == 1 and e.parts[0] in alias_map:
            try:
                scope.resolve(list(e.parts))
                return e
            except BindError:
                return copy.deepcopy(alias_map[e.parts[0]])
        if not hasattr(e, "__dataclass_fields__"):
            return e
        out = copy.copy(e)
        for f in e.__dataclass_fields__:
            v = getattr(e, f)
            if isinstance(v, A.Expr):
                setattr(out, f, self._substitute_alias_deep(v, alias_map, scope))
            elif isinstance(v, list):
                nl = []
                for i in v:
                    if isinstance(i, A.Expr):
                        nl.append(self._substitute_alias_deep(i, alias_map, scope))
                    elif isinstance(i, tuple):
                        nl.append(tuple(
                            self._substitute_alias_deep(j, alias_map, scope)
                            if isinstance(j, A.Expr) else j for j in i))
                    else:
                        nl.append(i)
                setattr(out, f, nl)
        return out

    # ----------------------------------------------------------- aggregation
    def _substitute_alias(self, g: A.Expr, alias_map, items):
        if isinstance(g, A.Literal) and isinstance(g.value, int) and g.type_hint is None:
            idx = g.value - 1
            exprs = [e for e, _, c in items]
            if 0 <= idx < len(exprs) and exprs[idx] is not None:
                return exprs[idx]
            raise BindError(f"GROUP BY position {g.value} out of range")
        if isinstance(g, A.ColumnRef) and len(g.parts) == 1 and g.parts[0] in alias_map:
            return alias_map[g.parts[0]]
        return g

    def _contains_agg(self, e: A.Expr) -> bool:
        found = False

        def visit(x):
            nonlocal found
            if isinstance(x, A.FuncCall):
                if (x.name in AGG_FNS or (x.name == "count" and x.star)) and x.over is None:
                    found = True
                    return  # don't recurse into agg args
            for f in getattr(x, "__dataclass_fields__", {}):
                v = getattr(x, f)
                if isinstance(v, A.Expr):
                    visit(v)
                elif isinstance(v, list):
                    for i in v:
                        if isinstance(i, A.Expr):
                            visit(i)
                        elif isinstance(i, tuple):
                            for j in i:
                                if isinstance(j, A.Expr):
                                    visit(j)

        visit(e)
        return found

    def _bind_aggregation(self, plan, scope, group_exprs_ast, stmt, alias_map, items):
        """Insert pre-Map + Aggregate. Returns (plan, group_repl, agg_collect):
        group_repl maps serialized AST -> ColRef of the group column;
        agg_collect is a callable that registers an aggregate and returns its
        output ColRef."""
        # ROLLUP/CUBE expand to a union of per-grouping-set aggregates
        # (reference: not in LingoDB's grammar surface, but required by the
        # TPC-DS suite it ships; the classic expansion mirrors how engines
        # without native grouping-set operators lower it)
        rollup_exprs: list[A.Expr] = []
        cube_exprs: list[A.Expr] = []
        plain_exprs: list[A.Expr] = []
        for g in group_exprs_ast:
            if isinstance(g, A.FuncCall) and g.over is None and g.name == "rollup":
                rollup_exprs.extend(g.args)
            elif isinstance(g, A.FuncCall) and g.over is None and g.name == "cube":
                cube_exprs.extend(g.args)
            else:
                plain_exprs.append(g)
        variadic_exprs = rollup_exprs + cube_exprs
        group_exprs_ast = plain_exprs + variadic_exprs

        pre_computed: list[tuple[ColInfo, BExpr]] = []
        group_cids: list[int] = []
        group_cols: list[ColInfo] = []
        group_repl: dict[str, ColRef] = {}

        for gi, g in enumerate(group_exprs_ast):
            b = self.bind_scalar(g, scope)
            key = _ast_key(g)
            if isinstance(b, ColRef):
                info = ColInfo(b.cid, self._default_name(g), b.type)
            else:
                info = self.fresh(self._default_name(g), b.type)
                pre_computed.append((info, b))
            group_cids.append(info.cid)
            group_cols.append(info)
            is_variadic = gi >= len(plain_exprs)
            group_repl[key] = ColRef(
                info.cid, info.type.as_nullable() if is_variadic else info.type)

        aggs: list[L.AggSpec] = []
        agg_cache: dict[tuple, ColRef] = {}
        subq_agg_cache: dict[tuple, BExpr] = {}

        def agg_collect(fn: str, arg_ast: Optional[A.Expr], distinct: bool) -> BExpr:
            # bind the argument in pre-aggregation space; subqueries inside the
            # argument (SUM((SELECT ...)), SUM(CASE WHEN EXISTS ...)) attach
            # their joins BELOW the aggregation so the subquery value exists
            # per input row (reference: sql_analyzer.cpp translates these via
            # the same map-before-aggregate scheme). AST-keyed cache: post-agg
            # binding re-requests the same aggregate and must not re-attach.
            if arg_ast is None:
                arg_b = None
            else:
                akey = (fn, _ast_key(arg_ast), distinct)
                if akey in subq_agg_cache:
                    return subq_agg_cache[akey]
                p0 = plan_holder[0]
                p, arg_b = self.bind_scalar_with_subqueries(arg_ast, scope, p0)
                if p is not p0:
                    plan_holder[0] = p
                ref = self._register_agg(
                    fn, arg_b, distinct, pre_computed, aggs, agg_cache)
                subq_agg_cache[akey] = ref
                return ref
            return self._register_agg(fn, arg_b, distinct, pre_computed, aggs, agg_cache)

        # Pre-scan: bind all aggregate calls appearing anywhere so that the
        # Aggregate node knows its full output before post-agg binding.
        plan_holder = [plan]

        def finish():
            p = plan_holder[0]
            if pre_computed:
                p = L.Map(p, pre_computed)
            if not variadic_exprs:
                return L.Aggregate(p, group_cids, aggs, group_cols)
            return build_grouping_sets(p)

        def build_grouping_sets(p):
            from ..sql.types import Type as _T

            n_plain = len(plain_exprs)
            var_cols = group_cols[n_plain:]
            # grouping sets over the variadic keys: rollup = prefixes
            # (full..empty), cube = all subsets
            k = len(var_cols)
            if cube_exprs and not rollup_exprs:
                sets = [frozenset(i for i in range(k) if (m >> i) & 1)
                        for m in range((1 << k) - 1, -1, -1)]
            else:
                sets = [frozenset(range(j)) for j in range(k, -1, -1)]
            # grouping() flag columns: one per variadic key, same cid in
            # every branch so the union maps them positionally
            int_t = _T.int_()
            flag_cols = [self.fresh(f"grouping_{c.name}", int_t) for c in var_cols]
            for ge, fc in zip(variadic_exprs, flag_cols):
                gkey = _ast_key(A.FuncCall("grouping", [ge]))
                group_repl[gkey] = ColRef(fc.cid, int_t)

            branches = []
            for s in sets:
                keys = group_cids[:n_plain] + [var_cols[i].cid for i in range(k) if i in s]
                cols = group_cols[:n_plain] + [var_cols[i] for i in range(k) if i in s]
                br = L.Aggregate(p, keys, aggs, cols)
                entries: list[tuple[ColInfo, BExpr]] = []
                for i in range(k):
                    if i not in s:
                        nt = var_cols[i].type.as_nullable()
                        entries.append((ColInfo(var_cols[i].cid, var_cols[i].name, nt),
                                        Const(None, nt)))
                    entries.append((flag_cols[i], Const(0 if i in s else 1, int_t)))
                branches.append(L.Map(br, entries))

            out_cols = (
                [ColInfo(c.cid, c.name, c.type) for c in group_cols[:n_plain]]
                + [ColInfo(c.cid, c.name, c.type.as_nullable()) for c in var_cols]
                + [ColInfo(a.out.cid, a.out.name, a.out.type) for a in aggs]
                + list(flag_cols)
            )
            cid_list = [c.cid for c in out_cols]
            u = branches[0]
            for br in branches[1:]:
                u = L.SetOp("union", True, u, br, out_cols, cid_list, cid_list)
            return u

        self._agg_finish = finish  # used by bind_select_core via closure
        # We finish lazily: bind_post_agg registers aggregates; but the plan
        # node must be created before post-agg Select/Map nodes. Strategy:
        # collect all aggregate calls from the statement now.
        for e, alias, direct in items:
            if e is not None:
                self._collect_aggs(e, agg_collect)
        if stmt.having is not None:
            self._collect_aggs(stmt.having, agg_collect)
        for o in stmt.order_by:
            self._collect_aggs(o.expr, agg_collect)

        plan = finish()
        return plan, group_repl, agg_collect

    def _register_agg(self, fn, arg_b, distinct, pre_computed, aggs, agg_cache):
        ckey = (fn, None if arg_b is None else _bexpr_key(arg_b), distinct)
        if ckey in agg_cache:
            return agg_cache[ckey]
        if fn == "avg" and arg_b is not None:
            # decompose into sum/count (reference: sql_analyzer.cpp:1319-1447)
            s = self._register_agg("sum", arg_b, distinct, pre_computed, aggs, agg_cache)
            c = self._register_agg("count", arg_b, distinct, pre_computed, aggs, agg_cache)
            t = self._avg_type(arg_b.type)
            if t.kind == K.DECIMAL:
                # divide at the operands' natural scales; the div kernel
                # rescales exactly (chunked long division, ops/scalar.py)
                den = Cast(c, Type.decimal(19, 0, c.type.nullable))
                res = Call("div", [s, den], t)
            else:
                res = Call("div", [Cast(s, t), Cast(c, t.as_nullable(c.type.nullable))], t)
            agg_cache[ckey] = res
            return res
        arg_cid = None
        if arg_b is not None:
            if isinstance(arg_b, ColRef):
                arg_cid = arg_b.cid
            else:
                info = self.fresh("__aggarg", arg_b.type)
                pre_computed.append((info, arg_b))
                arg_cid = info.cid
        out_t = self._agg_type(fn, None if arg_b is None else arg_b.type)
        out = self.fresh(fn, out_t)
        aggs.append(L.AggSpec(out, fn, arg_cid, distinct))
        ref = ColRef(out.cid, out_t)
        agg_cache[ckey] = ref
        return ref

    def _agg_type(self, fn: str, arg_t: Optional[Type]) -> Type:
        if fn in ("count", "count_star"):
            return Type.bigint(False)
        if arg_t is None:
            raise BindError(f"aggregate {fn} requires an argument")
        if fn == "sum":
            return _sum_type(arg_t)
        if fn in ("min", "max", "any_value"):
            return arg_t.as_nullable()
        if fn in ("stddev_samp", "var_samp"):
            return Type.double(True)
        if fn in ("bool_and", "bool_or"):
            return Type.bool_(True)
        if fn == "string_agg":
            return Type.string(True)
        raise BindError(f"unknown aggregate {fn}")

    def _avg_type(self, arg_t: Type) -> Type:
        # reference: sql_analyzer.cpp:2636-2642
        if arg_t.kind == K.INT or arg_t.kind == K.BIGINT:
            return self._decimal_div_type(Type.decimal(19, 0), Type.decimal(19, 0)).as_nullable()
        if arg_t.kind == K.DECIMAL:
            return self._decimal_div_type(arg_t, Type.decimal(19, 0)).as_nullable()
        return Type.double(True)

    def _decimal_div_type(self, a: Type, b: Type) -> Type:
        # reference: sql_analyzer.cpp:3083-3098 + getAdaptedDecimalPAndSAfterMulDiv
        s = max(6, a.s + b.p)
        p = (a.p - a.s) + b.s + s
        p, s = _adapt_decimal(p, s)
        return Type.decimal(p, s)

    def _collect_aggs(self, e: A.Expr, agg_collect):
        if isinstance(e, A.FuncCall) and e.over is None and (
            e.name in AGG_FNS or (e.name == "count" and e.star)
        ):
            if e.star or not e.args:
                agg_collect("count_star" if e.name == "count" else e.name, None, e.distinct)
            else:
                agg_collect(e.name, e.args[0], e.distinct)
            return
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, A.Expr):
                self._collect_aggs(v, agg_collect)
            elif isinstance(v, list):
                for i in v:
                    if isinstance(i, A.Expr):
                        self._collect_aggs(i, agg_collect)
                    elif isinstance(i, tuple):
                        for j in i:
                            if isinstance(j, A.Expr):
                                self._collect_aggs(j, agg_collect)

    # ------------------------------------------------------------- windows
    def _bind_windows(self, plan, scope, stmt, items, group_repl, agg_collect):
        """Detect OVER(...) calls, build Window nodes, and register id-keyed
        replacements so select binding maps each call to its output column
        (reference: window translation sql_mlir_translator.cpp + relalg.window)."""
        calls: list[A.FuncCall] = []

        def visit(x):
            if isinstance(x, A.FuncCall) and x.over is not None:
                calls.append(x)
            for f in getattr(x, "__dataclass_fields__", {}):
                v = getattr(x, f)
                if isinstance(v, A.Expr):
                    visit(v)
                elif isinstance(v, list):
                    for i in v:
                        if isinstance(i, A.Expr):
                            visit(i)
                        elif isinstance(i, tuple):
                            for j in i:
                                if isinstance(j, A.Expr):
                                    visit(j)

        for e, _a, _d in items:
            if e is not None:
                visit(e)
        for o in stmt.order_by:
            visit(o.expr)
        if not calls:
            return plan
        if not hasattr(self, "_expr_repl"):
            self._expr_repl = {}
        # group calls by identical window spec
        groups: dict[str, tuple[A.WindowSpec, list[A.FuncCall]]] = {}
        for c in calls:
            ws = c.over
            key = (
                tuple(_ast_key(p) for p in ws.partition_by),
                tuple((_ast_key(o.expr), o.ascending, o.nulls_first) for o in ws.order_by),
                repr(ws.frame),
            )
            groups.setdefault(repr(key), (ws, []))[1].append(c)
        post_agg = (group_repl, agg_collect) if (group_repl is not None or agg_collect is not None) else None
        for ws, group_calls in groups.values():
            pre: list[tuple[ColInfo, BExpr]] = []

            def as_cid(b: BExpr, name: str) -> int:
                if isinstance(b, ColRef):
                    return b.cid
                info = self.fresh(name, b.type)
                pre.append((info, b))
                return info.cid

            part = [
                as_cid(self.bind_post_agg(p, scope, group_repl, agg_collect), "__part")
                for p in ws.partition_by
            ]
            order = [
                L.SortKey(
                    as_cid(self.bind_post_agg(o.expr, scope, group_repl, agg_collect), "__word"),
                    o.ascending, o.nulls_first,
                )
                for o in ws.order_by
            ]
            funcs = []
            for c in group_calls:
                fn = c.name
                arg = None
                arg_t = None
                extra = None
                default = None
                b = None
                if fn == "count" and c.star:
                    fn = "count_star"
                elif fn in ("nth_value", "lead", "lag"):
                    b = self.bind_post_agg(c.args[0], scope, group_repl, agg_collect)
                    if fn == "nth_value":
                        extra = self._window_int_arg(c.args[1])
                    else:
                        extra = (self._window_int_arg(c.args[1])
                                 if len(c.args) > 1 else 1)
                    if len(c.args) > 2:
                        b, default = self._leadlag_default(b, c.args[2])
                elif fn == "ntile":
                    extra = self._window_int_arg(c.args[0])
                elif c.args:
                    b = self.bind_post_agg(c.args[0], scope, group_repl, agg_collect)
                if b is not None:
                    arg_t = b.type
                out_t = self._window_type(fn, arg_t)
                if fn in ("nth_value", "lead", "lag", "ntile") and extra is None:
                    # a NULL offset, position or bucket count: NULL on
                    # every row, as PostgreSQL gives
                    self._expr_repl[id(c)] = Const(None, out_t.as_nullable())
                    continue
                if b is not None:
                    arg = as_cid(b, "__warg")
                out = self.fresh(fn, out_t)
                funcs.append(L.WindowFn(out, fn, arg, extra, default))
                self._expr_repl[id(c)] = ColRef(out.cid, out_t)
            if not funcs:
                continue
            if pre:
                plan = L.Map(plan, pre)
            fs, fe, mode = self._translate_frame(ws.frame)
            plan = L.Window(plan, part, order, funcs, fs, fe, mode)
        return plan

    def _window_int_arg(self, e: A.Expr) -> Optional[int]:
        """A window function's constant integer argument (lag / lead's
        offset, nth_value's position, ntile's bucket count); None for NULL."""
        from ..ops.consteval import eval_const

        v = eval_const(self.bind_scalar(e, Scope()), Type.bigint())
        return None if v is None else int(v)

    def _leadlag_default(self, b: BExpr, e: A.Expr):
        """lag / lead's default: a constant, coerced with the argument to
        their common type by the rule coalesce uses. Returns the argument
        (coerced) and the default (None where it is NULL)."""
        from ..ops.consteval import ConstEvalError, eval_const

        d = self.bind_scalar(e, Scope())
        if d.type.kind == K.NULL:
            return b, None
        t = self.common_type(b.type, d.type)
        d = self.coerce(d, t.as_nullable(d.type.nullable))
        try:
            value = eval_const(d, t)
        except ConstEvalError:
            raise BindError("lag / lead default must be a constant") from None
        b = self.coerce(b, t.as_nullable(b.type.nullable))
        return b, (None if value is None else d)

    def _window_type(self, fn: str, arg_t: Optional[Type]) -> Type:
        if fn in ("row_number", "rank", "dense_rank", "ntile", "count", "count_star"):
            return Type.bigint(False)
        if fn in ("percent_rank", "cume_dist"):
            return Type.double(False)
        if fn == "avg":
            return Type.double(True)
        if fn == "sum":
            return _sum_type(arg_t)
        if fn in ("min", "max", "first_value", "last_value", "nth_value",
                  "lead", "lag"):
            return arg_t.as_nullable()
        raise BindError(f"unknown window function {fn}")

    def _translate_frame(self, frame):
        if frame is None:
            return None, None, "rows"
        mode, start, end = frame

        def tr(b):
            if b == "unbounded_preceding" or b == "unbounded_following":
                return "unbounded"
            if b == "current_row":
                return 0
            n, d = b
            from ..ops.consteval import eval_const

            k = int(eval_const(self.bind_scalar(n, Scope()), Type.bigint()))
            return -k if d == "preceding" else k

        return tr(start), tr(end), mode

    def bind_post_agg(self, e: A.Expr, scope, group_repl, agg_collect) -> BExpr:
        """Bind an expression in post-aggregation space: aggregate calls map to
        Aggregate outputs, group expressions map to group columns."""
        if group_repl is None and agg_collect is None:
            return self.bind_scalar(e, scope)
        key = _ast_key(e)
        if group_repl is not None and key in group_repl:
            return group_repl[key]
        if isinstance(e, A.FuncCall) and e.over is None and (
            e.name in AGG_FNS or (e.name == "count" and e.star)
        ):
            if e.star or not e.args:
                return agg_collect("count_star" if e.name == "count" else e.name, None, e.distinct)
            return agg_collect(e.name, e.args[0], e.distinct)
        # recurse structurally, rebuilding through bind_scalar machinery
        return self.bind_scalar(e, scope, post_agg=(group_repl, agg_collect))

    # ------------------------------------------------------------ WHERE
    def bind_where(self, where: A.Expr, scope: Scope, plan: L.LogicalOp) -> L.LogicalOp:
        parts = self._split_conjuncts(where)
        simple: list[BExpr] = []
        for p in parts:
            plan, bexpr = self.bind_conjunct(p, scope, plan)
            if bexpr is not None:
                simple.append(bexpr)
        if simple:
            plan = L.Select(plan, E.make_and(simple))
        return plan

    def _split_conjuncts(self, e: A.Expr) -> list[A.Expr]:
        if isinstance(e, A.BinaryOp) and e.op == "and":
            return self._split_conjuncts(e.left) + self._split_conjuncts(e.right)
        return [e]

    def bind_conjunct(self, e: A.Expr, scope: Scope, plan: L.LogicalOp):
        """Bind one WHERE conjunct; subquery constructs become joins.
        Returns (plan, bexpr-or-None)."""
        if isinstance(e, A.Exists):
            sub, preds = self.bind_subquery_join(e.subquery, scope, plan)
            kind = "anti" if e.negated else "semi"
            return L.Join(kind, plan, sub.plan, E.make_and(preds)), None
        if isinstance(e, A.UnaryOp) and e.op == "not" and isinstance(e.operand, A.Exists):
            inner = e.operand
            sub, preds = self.bind_subquery_join(inner.subquery, scope, plan)
            kind = "semi" if inner.negated else "anti"
            return L.Join(kind, plan, sub.plan, E.make_and(preds)), None
        if isinstance(e, A.InSubquery):
            outer_b = self.bind_scalar(e.expr, scope)
            sub, preds = self.bind_subquery_join(e.subquery, scope, plan)
            if len(sub.cols) != 1:
                raise BindError("IN subquery must return one column")
            inner_col = sub.cols[0]
            cmp = self.make_cmp("eq", outer_b, ColRef(inner_col.cid, inner_col.type))
            if e.negated:
                # null-aware anti join (NOT IN semantics): handled by executor
                j = L.Join("anti", plan, sub.plan, E.make_and([cmp] + preds),
                           null_aware=(outer_b, ColRef(inner_col.cid, inner_col.type)))
                return j, None
            return L.Join("semi", plan, sub.plan, E.make_and([cmp] + preds)), None
        if isinstance(e, A.QuantifiedComparison):
            outer_b = self.bind_scalar(e.expr, scope)
            sub, preds = self.bind_subquery_join(e.subquery, scope, plan)
            inner_col = sub.cols[0]
            inner_ref = ColRef(inner_col.cid, inner_col.type)
            if e.quantifier == "any":
                cmp = self.make_cmp(_CMP_OPS[e.op], outer_b, inner_ref)
                return L.Join("semi", plan, sub.plan, E.make_and([cmp] + preds)), None
            else:  # ALL: no row violates -> anti join on negated comparison
                cmp = self.make_cmp(_NEGATED_CMP[_CMP_OPS[e.op]], outer_b, inner_ref)
                return L.Join("anti", plan, sub.plan, E.make_and([cmp] + preds)), None
        # generic: may still contain scalar subqueries inside
        plan, b = self.bind_scalar_with_subqueries(e, scope, plan)
        return plan, b

    @dataclass
    class BoundSub:
        plan: L.LogicalOp
        cols: list[ColInfo]

    def bind_subquery_join(self, sub_stmt: A.SelectStmt, scope: Scope, plan):
        """Bind a subquery in a child scope and decorrelate it. Returns
        (BoundSub, correlation_predicates)."""
        sub_scope = Scope(scope)
        sub_plan, sub_cols = self.bind_select(sub_stmt, sub_scope)
        outer_cids = {c.cid for c in self._all_outer_cols(scope)}
        sub_plan, preds = self.decorrelate(sub_plan, outer_cids)
        free = plan_free_cols(sub_plan) & outer_cids
        if free and not _is_trivial_chain(sub_plan):
            # only correlations the immediate outer plan can supply form the
            # domain; references to still-deeper query blocks stay free and
            # are unnested when THAT enclosing subquery is bound (multi-level
            # nesting, reference: recursive Unnesting.cpp pushdown)
            avail = {c.cid for node in L.walk_plan(plan)
                     for c in node.output_cols()}
            local = free & avail
            if local:
                sub_plan, extra = self.general_unnest(plan, sub_plan, local)
                preds = preds + extra
        return Binder.BoundSub(sub_plan, sub_cols), preds

    def general_unnest(self, outer_plan: L.LogicalOp, sub_plan: L.LogicalOp,
                       corr: set[int]):
        """Domain-based dependent-join pushdown (Neumann/Kemper unnesting;
        reference: Transforms/Unnesting.cpp). Builds D = DISTINCT projection
        of the outer plan on the correlated columns (fresh copies), replaces
        correlated references inside the subquery with the copies, pushes the
        D-join down until no correlation remains, and returns null-safe
        equality predicates linking outer originals to the copies."""
        mapping: dict[int, int] = {}
        d_plan = self.clone_plan(outer_plan, mapping)
        d_corr = {c: mapping[c] for c in corr if c in mapping}
        missing = corr - set(d_corr)
        if missing:
            raise BindError(f"cannot build correlation domain for columns {sorted(missing)}")
        D = L.Distinct(d_plan, sorted(d_corr.values()))
        sub2 = self._remap_exprs(sub_plan, d_corr)
        pushed = self._push_dj(D, set(d_corr.values()), sub2)
        preds = []
        for c, dc in sorted(d_corr.items()):
            t = self._col_info[c].type
            preds.append(Call("nseq", [ColRef(c, t), ColRef(dc, t)], Type.bool_(False)))
        return pushed, preds

    def _remap_exprs(self, op: L.LogicalOp, m: dict[int, int]) -> L.LogicalOp:
        """Rewrite free column references in every expression of the plan;
        defined columns keep their ids."""

        def f(e: BExpr) -> BExpr:
            return E.map_cols(e, m)

        if isinstance(op, L.Scan):
            return L.Scan(op.table, op.cols, [f(r) for r in op.restrictions])
        if isinstance(op, L.ConstRel):
            return op
        ch = [self._remap_exprs(c, m) for c in op.children()]
        if isinstance(op, L.Select):
            return L.Select(ch[0], f(op.predicate))
        if isinstance(op, L.Map):
            return L.Map(ch[0], [(c, f(e)) for c, e in op.computed])
        if isinstance(op, L.Join):
            na = op.null_aware
            if na is not None:
                na = (f(na[0]), f(na[1]))
            return L.Join(op.kind, ch[0], ch[1],
                          None if op.predicate is None else f(op.predicate),
                          op.mark_col, na)
        if isinstance(op, L.Aggregate):
            def mcid(c):
                return m.get(c, c)

            def minfo(ci):
                if ci.cid in m:
                    nc = self._col_info[m[ci.cid]]
                    return ColInfo(nc.cid, ci.name, ci.type)
                return ci
            aggs = [L.AggSpec(a.out, a.fn,
                              None if a.arg is None else mcid(a.arg), a.distinct)
                    for a in op.aggs]
            agg = L.Aggregate(ch[0], [mcid(c) for c in op.group_by], aggs,
                              [minfo(c) for c in op.group_cols])
            if hasattr(op, "_domain_cids"):
                agg._domain_cids = {mcid(c) for c in op._domain_cids}
            return agg
        if isinstance(op, L.Window):
            funcs = [L.WindowFn(w.out, w.fn,
                                None if w.arg is None else m.get(w.arg, w.arg),
                                w.extra, w.default) for w in op.funcs]
            new = op.replace_children(ch)
            new.partition_by = [m.get(c, c) for c in op.partition_by]
            new.order_by = [L.SortKey(m.get(k.cid, k.cid), k.ascending,
                                      k.nulls_first) for k in op.order_by]
            new.funcs = funcs
            return new
        if isinstance(op, (L.Sort, L.TopK)):
            new = op.replace_children(ch)
            new.keys = [L.SortKey(m.get(k.cid, k.cid), k.ascending,
                                  k.nulls_first) for k in op.keys]
            return new
        if isinstance(op, L.Distinct):
            return L.Distinct(ch[0], [m.get(c, c) for c in op.cids])
        return op.replace_children(ch)

    def _push_dj(self, D: L.LogicalOp, dcols: set[int], node: L.LogicalOp) -> L.LogicalOp:
        """Push the dependent join with domain D below `node` until the
        subtree no longer references the domain columns."""
        if not (plan_free_cols(node) & dcols):
            return L.Join("cross", D, node)
        if isinstance(node, L.Select):
            return L.Select(self._push_dj(D, dcols, node.child), node.predicate)
        if isinstance(node, L.Map):
            return L.Map(self._push_dj(D, dcols, node.child), node.computed)
        if isinstance(node, L.Aggregate):
            child = self._push_dj(D, dcols, node.child)
            extra = [self._col_info[c] for c in sorted(dcols)
                     if c not in node.group_by]
            agg = L.Aggregate(
                child,
                node.group_by + [c.cid for c in extra],
                node.aggs,
                node.group_cols + extra,
            )
            # track machinery-added group keys: COUNT over an otherwise
            # global aggregate still coalesces empty groups to 0, while a
            # user-written GROUP BY yields no row (NULL) — see
            # _is_count_output (reference: useZeroInsteadOfNull)
            agg._domain_cids = (set(getattr(node, "_domain_cids", set()))
                                | {c.cid for c in extra})
            return agg
        if isinstance(node, L.Join):
            lfree = plan_free_cols(node.left) & dcols
            rfree = plan_free_cols(node.right) & dcols
            pfree = (E.used_cols(node.predicate) & dcols) if node.predicate is not None else set()
            if lfree and rfree:
                raise BindError("correlation on both sides of a join is not yet unnestable")
            if rfree and node.kind in ("single", "mark", "left", "semi", "anti"):
                # dependent RIGHT side of a left-preserving join: the left
                # side must carry the domain too (each left row pairs with
                # the right rows of ITS domain value, and unmatched left rows
                # must keep the domain link for the outer equality preds).
                # Give the right side a fresh domain copy and equate the two
                # copies in the join predicate (Neumann/Kemper dependent-join
                # pushdown through preserving joins, Unnesting.cpp analogue).
                m2: dict[int, int] = {}
                D2 = self.clone_plan(D, m2)
                d2cols = {m2[c] for c in dcols}
                right = self._push_dj(D2, d2cols,
                                      self._remap_exprs(node.right,
                                                        {c: m2[c] for c in dcols}))
                left = self._push_dj(D, dcols, node.left)  # cross(D, left)
                link = [Call("nseq",
                             [ColRef(c, self._col_info[c].type),
                              ColRef(m2[c], self._col_info[c].type)],
                             Type.bool_(False)) for c in sorted(dcols)]
                pred = E.make_and(
                    ([node.predicate] if node.predicate is not None else [])
                    + link)
                j = L.Join(node.kind, left, right, pred, node.mark_col, node.null_aware)
            elif rfree:
                j = L.Join(node.kind, node.left, self._push_dj(D, dcols, node.right), node.predicate, node.mark_col, node.null_aware)
            elif lfree or pfree:
                j = L.Join(node.kind, self._push_dj(D, dcols, node.left), node.right, node.predicate, node.mark_col, node.null_aware)
            else:
                j = node
            return j
        if isinstance(node, L.Distinct):
            return L.Distinct(self._push_dj(D, dcols, node.child), node.cids + sorted(dcols))
        if isinstance(node, L.Sort):
            return L.Sort(self._push_dj(D, dcols, node.child), node.keys)
        raise BindError(
            f"correlated subquery through {type(node).__name__} is not yet unnestable"
        )

    def _all_outer_cols(self, scope: Scope) -> list[ColInfo]:
        out = []
        s = scope
        while s is not None:
            out.extend(s.all_cols())
            s = s.parent
        return out

    # -------------------------------------------------------- decorrelation
    def decorrelate(self, plan: L.LogicalOp, outer_cids: set[int]):
        """Pull predicates referencing outer columns up and out of the plan
        (reference: Transforms/Unnesting.cpp — we implement the equality-
        hoisting subset that covers EXISTS/IN and scalar-agg subqueries)."""
        if isinstance(plan, L.Select):
            child, preds = self.decorrelate(plan.child, outer_cids)
            local, corr = [], []
            for c in E.conjuncts(plan.predicate):
                if E.used_cols(c) & outer_cids:
                    corr.append(c)
                else:
                    local.append(c)
            new = L.Select(child, E.make_and(local)) if local else child
            return new, preds + corr
        if isinstance(plan, L.Map):
            child, preds = self.decorrelate(plan.child, outer_cids)
            return L.Map(child, plan.computed), preds
        if isinstance(plan, L.Join) and plan.kind in ("cross", "inner"):
            l, lp = self.decorrelate(plan.left, outer_cids)
            r, rp = self.decorrelate(plan.right, outer_cids)
            preds = lp + rp
            if plan.predicate is not None:
                local, corr = [], []
                for c in E.conjuncts(plan.predicate):
                    if E.used_cols(c) & outer_cids:
                        corr.append(c)
                    else:
                        local.append(c)
                preds += corr
                return L.Join(plan.kind, l, r, E.make_and(local)), preds
            return L.Join(plan.kind, l, r, None), preds
        if isinstance(plan, L.Aggregate):
            child, preds = self.decorrelate(plan.child, outer_cids)
            if not preds:
                return plan.replace_children([child]), []
            # hoist equality predicates through the aggregate: inner side must
            # be a column; add it to the group-by keys
            new_group = list(plan.group_by)
            new_group_cols = list(plan.group_cols)
            child_cols = {c.cid: c for c in child.output_cols()}
            out_preds, unhoistable = [], []
            for p in preds:
                inner_used = E.used_cols(p) - outer_cids
                ok = (
                    isinstance(p, Call)
                    and p.op == "eq"
                    and len(inner_used) == 1
                    and next(iter(inner_used)) in child_cols
                )
                if not ok:
                    # leave it below; general_unnest handles it via the domain
                    unhoistable.append(p)
                    continue
                icid = next(iter(inner_used))
                if icid not in new_group:
                    new_group.append(icid)
                    new_group_cols.append(child_cols[icid])
                out_preds.append(p)
            if unhoistable:
                child = L.Select(child, E.make_and(unhoistable))
            agg = L.Aggregate(child, new_group, plan.aggs, new_group_cols)
            agg._domain_cids = (set(getattr(plan, "_domain_cids", set()))
                                | (set(new_group) - set(plan.group_by)))
            return agg, out_preds
        if isinstance(plan, (L.Sort, L.Limit, L.TopK, L.Distinct)):
            child, preds = self.decorrelate(plan.children()[0], outer_cids)
            if preds and isinstance(plan, (L.Limit, L.TopK)):
                raise BindError("correlated subquery with LIMIT not supported")
            return plan.replace_children([child]), preds
        # leaf or unsupported: ensure no correlation remains below
        for node in L.walk_plan(plan):
            pass
        return plan, []

    def bind_scalar_with_subqueries(self, e: A.Expr, scope: Scope, plan, post_agg=None):
        """Bind an expression that may contain subquery constructs in scalar
        positions: ScalarSubquery -> single join; EXISTS/IN -> mark join;
        quantified comparisons -> mark join (reference: mark-join translation
        in ImplicitToExplicitJoins + Unnesting)."""
        # find scalar subqueries
        found: list[A.Expr] = []

        def visit(x):
            if isinstance(x, A.ScalarSubquery):
                found.append(x)
                return
            if isinstance(x, (A.Exists, A.InSubquery, A.QuantifiedComparison)):
                found.append(x)
                return
            if (post_agg is not None and isinstance(x, A.FuncCall)
                    and x.over is None
                    and (x.name in AGG_FNS or (x.name == "count" and x.star))):
                # subqueries inside aggregate arguments bind below the
                # Aggregate via agg_collect — don't re-attach them here
                return
            for f in getattr(x, "__dataclass_fields__", {}):
                v = getattr(x, f)
                if isinstance(v, A.Expr):
                    visit(v)
                elif isinstance(v, list):
                    for i in v:
                        if isinstance(i, A.Expr):
                            visit(i)
                        elif isinstance(i, tuple):
                            for j in i:
                                if isinstance(j, A.Expr):
                                    visit(j)

        visit(e)
        if not found:
            return plan, self.bind_scalar(e, scope, post_agg=post_agg)
        repl: dict[int, BExpr] = {}
        for sq in found:
            if isinstance(sq, A.ScalarSubquery):
                # LIMIT 0: statically empty -> scalar subquery is NULL (bind
                # once in a throwaway scope only to recover the result type)
                lim = sq.subquery.limit
                if (isinstance(lim, A.Literal) and lim.value == 0
                        and sq.subquery.set_op is None):
                    _p, cols0 = self.bind_select(sq.subquery, Scope(scope))
                    if len(cols0) != 1:
                        raise BindError("scalar subquery must return one column")
                    repl[id(sq)] = Const(None, cols0[0].type.as_nullable())
                    continue
                sub, preds = self.bind_subquery_join(sq.subquery, scope, plan)
                if len(sub.cols) != 1:
                    raise BindError("scalar subquery must return one column")
                col = sub.cols[0]
                inline = _try_inline_trivial(sub.plan, col.cid)
                if inline is not None and not preds:
                    repl[id(sq)] = inline
                    continue
                plan = L.Join("single", plan, sub.plan, E.make_and(preds))
                ref: BExpr = ColRef(col.cid, col.type.as_nullable())
                # COUNT subqueries yield 0, not NULL, for empty groups
                # (reference: useZeroInsteadOfNull, sql_analyzer.cpp:2674)
                if _is_count_output(sub.plan, col.cid):
                    ref = Call("coalesce", [ref, Const(0, Type.bigint())], Type.bigint(False))
                repl[id(sq)] = ref
            elif isinstance(sq, (A.Exists, A.InSubquery)):
                # nested in a general expression: mark join
                if isinstance(sq, A.Exists):
                    sub, preds = self.bind_subquery_join(sq.subquery, scope, plan)
                    mark = self.fresh("__mark", Type.bool_(False))
                    plan = L.Join("mark", plan, sub.plan, E.make_and(preds), mark)
                    r: BExpr = ColRef(mark.cid, mark.type)
                    if sq.negated:
                        r = Call("not", [r], mark.type)
                    repl[id(sq)] = r
                else:
                    outer_b = self.bind_scalar(sq.expr, scope)
                    sub, preds = self.bind_subquery_join(sq.subquery, scope, plan)
                    inner_col = sub.cols[0]
                    cmp = self.make_cmp("eq", outer_b, ColRef(inner_col.cid, inner_col.type))
                    mark = self.fresh("__mark", Type.bool_(False))
                    plan = L.Join("mark", plan, sub.plan, E.make_and([cmp] + preds), mark)
                    r = ColRef(mark.cid, mark.type)
                    if sq.negated:
                        r = Call("not", [r], mark.type)
                    repl[id(sq)] = r
            elif isinstance(sq, A.QuantifiedComparison):
                outer_b = self.bind_scalar(sq.expr, scope, post_agg=post_agg)
                sub, preds = self.bind_subquery_join(sq.subquery, scope, plan)
                inner_col = sub.cols[0]
                inner_ref = ColRef(inner_col.cid, inner_col.type)
                mark = self.fresh("__mark", Type.bool_(False))
                if sq.quantifier == "any":
                    cmp = self.make_cmp(_CMP_OPS[sq.op], outer_b, inner_ref)
                    plan = L.Join("mark", plan, sub.plan, E.make_and([cmp] + preds), mark)
                    repl[id(sq)] = ColRef(mark.cid, mark.type)
                else:  # ALL: true iff no row violates
                    cmp = self.make_cmp(_NEGATED_CMP[_CMP_OPS[sq.op]], outer_b, inner_ref)
                    plan = L.Join("mark", plan, sub.plan, E.make_and([cmp] + preds), mark)
                    repl[id(sq)] = Call("not", [ColRef(mark.cid, mark.type)], mark.type)
            else:
                raise BindError(f"unsupported subquery construct {type(sq).__name__}")
        b = self.bind_scalar(e, scope, post_agg=post_agg, subquery_repl=repl)
        return plan, b

    # ----------------------------------------------------- scalar expressions
    def bind_scalar(self, e: A.Expr, scope: Scope, post_agg=None, subquery_repl=None) -> BExpr:
        repl = dict(getattr(self, "_expr_repl", {}))  # window-call replacements
        if subquery_repl:
            repl.update(subquery_repl)
        return self._bind(e, scope, post_agg, repl)

    def _bind(self, e: A.Expr, scope: Scope, post_agg, subq) -> BExpr:
        if post_agg is not None:
            group_repl, agg_collect = post_agg
            key = _ast_key(e)
            if group_repl is not None and key in group_repl:
                return group_repl[key]
            if isinstance(e, A.FuncCall) and e.over is None and (
                e.name in AGG_FNS or (e.name == "count" and e.star)
            ):
                if e.star or not e.args:
                    return agg_collect("count_star" if e.name == "count" else e.name, None, e.distinct)
                return agg_collect(e.name, e.args[0], e.distinct)
        if id(e) in subq:
            return subq[id(e)]

        if isinstance(e, A.Literal):
            return self.bind_literal(e)
        if isinstance(e, A.ColumnRef):
            info, _corr = scope.resolve(e.parts)
            return ColRef(info.cid, info.type)
        if isinstance(e, A.BinaryOp):
            l = self._bind(e.left, scope, post_agg, subq)
            r = self._bind(e.right, scope, post_agg, subq)
            return self.bind_binary(e.op, l, r)
        if isinstance(e, A.UnaryOp):
            v = self._bind(e.operand, scope, post_agg, subq)
            if e.op == "-":
                return Call("neg", [v], v.type)
            if e.op == "not":
                if v.type.kind == K.NULL:
                    return Const(None, Type.bool_(True))
                if v.type.kind != K.BOOL:
                    raise BindError("NOT requires boolean")
                return Call("not", [v], v.type)
            raise BindError(f"unary op {e.op}")
        if isinstance(e, A.IsNull):
            v = self._bind(e.operand, scope, post_agg, subq)
            op = "isnotnull" if e.negated else "isnull"
            return Call(op, [v], Type.bool_(False))
        if isinstance(e, A.Between):
            v = self._bind(e.expr, scope, post_agg, subq)
            lo = self._bind(e.low, scope, post_agg, subq)
            hi = self._bind(e.high, scope, post_agg, subq)
            b = Call(
                "and",
                [self.make_cmp("gte", v, lo), self.make_cmp("lte", v, hi)],
                Type.bool_(v.type.nullable or lo.type.nullable or hi.type.nullable),
            )
            if e.negated:
                b = Call("not", [b], b.type)
            return b
        if isinstance(e, A.InList):
            v = self._bind(e.expr, scope, post_agg, subq)
            items = [self._bind(i, scope, post_agg, subq) for i in e.items]
            # coerce all to common type
            t = v.type
            for i in items:
                t = self.common_type(t, i.type)
            v = self.coerce(v, t)
            items = [self.coerce(i, t) for i in items]
            nullable = v.type.nullable or any(i.type.nullable for i in items)
            b = Call("in", [v] + items, Type.bool_(nullable))
            if e.negated:
                b = Call("not", [b], b.type)
            return b
        if isinstance(e, A.Like):
            v = self._bind(e.expr, scope, post_agg, subq)
            p = self._bind(e.pattern, scope, post_agg, subq)
            op = "ilike" if e.case_insensitive else "like"
            b = Call(op, [v, p], Type.bool_(v.type.nullable or p.type.nullable))
            if e.negated:
                b = Call("not", [b], b.type)
            return b
        if isinstance(e, A.Case):
            whens = []
            else_b = None
            if e.operand is not None:
                op_b = self._bind(e.operand, scope, post_agg, subq)
                for c, v in e.whens:
                    cb = self.make_cmp("eq", op_b, self._bind(c, scope, post_agg, subq))
                    whens.append((cb, self._bind(v, scope, post_agg, subq)))
            else:
                for c, v in e.whens:
                    cb = self._bind(c, scope, post_agg, subq)
                    whens.append((cb, self._bind(v, scope, post_agg, subq)))
            if e.else_ is not None:
                else_b = self._bind(e.else_, scope, post_agg, subq)
            # result type = common of branches
            ts = [v.type for _, v in whens] + ([else_b.type] if else_b else [])
            ts_nonnull = [t for t in ts if t.kind != K.NULL]
            t = ts_nonnull[0] if ts_nonnull else Type.int_(True)
            for x in ts_nonnull[1:]:
                t = self.common_type(t, x)
            nullable = else_b is None or any(x.nullable or x.kind == K.NULL for x in ts)
            t = t.as_nullable(nullable)
            whens = [(c, self.coerce(v, t)) for c, v in whens]
            if else_b is not None:
                else_b = self.coerce(else_b, t)
            return CaseExpr(whens, else_b, t)
        if isinstance(e, A.Cast):
            v = self._bind(e.expr, scope, post_agg, subq)
            t = e.target.as_nullable(v.type.nullable)
            return Cast(v, t)
        if isinstance(e, A.ExtractExpr):
            v = self._bind(e.expr, scope, post_agg, subq)
            return Call(f"extract_{e.part}", [v], Type.bigint(v.type.nullable))
        if isinstance(e, A.SubstringExpr):
            v = self._bind(e.expr, scope, post_agg, subq)
            s = self._bind(e.start, scope, post_agg, subq)
            ln = self._bind(e.length, scope, post_agg, subq) if e.length else Const(1 << 30, Type.int_())
            return Call("substring", [v, s, ln], Type.string(
                v.type.nullable or s.type.nullable or ln.type.nullable))
        if isinstance(e, A.FuncCall):
            return self.bind_func(e, scope, post_agg, subq)
        if isinstance(e, A.ScalarSubquery):
            raise BindError("scalar subquery in unsupported position")
        if isinstance(e, (A.Exists, A.InSubquery)):
            raise BindError("subquery predicate in unsupported position")
        raise BindError(f"cannot bind {type(e).__name__}")

    def bind_literal(self, e: A.Literal) -> BExpr:
        v = e.value
        if v is None:
            return Const(None, Type.null())
        if e.type_hint is not None:
            t = e.type_hint
            if t.kind == K.DATE:
                return Const(v, Type.date())
            if t.kind == K.TIMESTAMP:
                return Const(v, Type.timestamp())
            if t.is_string:
                return Const(v, Type.string())
            return Const(v, t)
        if isinstance(v, bool):
            return Const(v, Type.bool_())
        if isinstance(v, int):
            if -(2**31) <= v < 2**31:
                return Const(v, Type.int_())
            return Const(v, Type.bigint())
        if isinstance(v, str):
            # unhinted numeric literal string like '1.1' from the lexer
            if _looks_numeric(v):
                ip, _, fp = v.partition(".")
                fp = fp.split("e")[0].split("E")[0]
                if "e" in v.lower():
                    return Const(float(v), Type.double())
                p = len(ip.lstrip("-+").lstrip("0") or "0") + len(fp)
                return Const(v, Type.decimal(max(p, 1), len(fp)))
            return Const(v, Type.string())
        if isinstance(v, float):
            return Const(v, Type.double())
        if isinstance(v, tuple) and v and v[0] == "interval":
            return self.bind_interval(v[1], v[2])
        raise BindError(f"bad literal {v!r}")

    def bind_interval(self, text: str, unit: Optional[str]) -> BExpr:
        text = str(text).strip()
        if unit is None:
            # e.g. '90 days' / '1 year'
            parts = text.split()
            if len(parts) == 2:
                text, unit = parts[0], parts[1]
            else:
                raise BindError(f"bad interval literal {text!r}")
        unit = unit.rstrip("s").lower()
        n = int(text)
        if unit in ("year", "month"):
            months = n * 12 if unit == "year" else n
            return Const(months, Type.interval(IntervalUnit.MONTH))
        mult = {
            "day": 86_400_000_000,
            "hour": 3_600_000_000,
            "minute": 60_000_000,
            "second": 1_000_000,
        }[unit]
        return Const(n * mult, Type.interval(IntervalUnit.DAYTIME))

    def bind_binary(self, op: str, l: BExpr, r: BExpr) -> BExpr:
        if op in ("and", "or"):
            return Call(op, [l, r], Type.bool_(l.type.nullable or r.type.nullable))
        if op in _CMP_OPS:
            return self.make_cmp(_CMP_OPS[op], l, r)
        if op == "||":
            l = self.coerce(l, Type.string(l.type.nullable))
            r = self.coerce(r, Type.string(r.type.nullable))
            return Call("concat", [l, r], Type.string(l.type.nullable or r.type.nullable))
        if op in ("+", "-", "*", "/", "%"):
            return self.bind_arith(op, l, r)
        raise BindError(f"binary op {op}")

    def bind_arith(self, op: str, l: BExpr, r: BExpr) -> BExpr:
        nullable = l.type.nullable or r.type.nullable
        lk, rk = l.type.kind, r.type.kind
        if K.NULL in (lk, rk) and {lk, rk} & {K.DATE, K.TIMESTAMP}:
            # a NULL beside a date is typed as PostgreSQL types an unknown:
            # as the other side's type where that operator exists (date -
            # date -> integer), else date + integer -> date, timestamp +
            # interval -> timestamp
            other = lk if rk == K.NULL else rk
            if op == "-" and other == K.DATE:
                return Const(None, Type.int_(True))
            if op == "+":
                return Const(None, Type.date(True) if other == K.DATE
                             else Type.timestamp(True))
        # date/timestamp/interval arithmetic
        if lk in (K.DATE, K.TIMESTAMP) and rk == K.INTERVAL:
            opname = "date_add" if op == "+" else "date_sub"
            return Call(opname, [l, r], l.type.as_nullable(nullable))
        if lk == K.INTERVAL and rk in (K.DATE, K.TIMESTAMP) and op == "+":
            return Call("date_add", [r, l], r.type.as_nullable(nullable))
        if lk == K.DATE and rk == K.DATE and op == "-":
            return Call("sub", [l, r], Type.int_(nullable))  # day difference
        if lk == K.INTERVAL and rk == K.INTERVAL:
            if l.type.unit != r.type.unit:
                raise BindError("mixed interval units")
            return Call("add" if op == "+" else "sub", [l, r], l.type.as_nullable(nullable))
        # numeric
        opname = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod"}[op]
        if not (l.type.is_numeric or lk == K.NULL) or not (r.type.is_numeric or rk == K.NULL):
            raise BindError(f"cannot {opname} {l.type} and {r.type}")
        lt = Type.decimal(19, 0, l.type.nullable) if (lk in (K.INT, K.BIGINT) and rk == K.DECIMAL) else l.type
        rt = Type.decimal(19, 0, r.type.nullable) if (rk in (K.INT, K.BIGINT) and lk == K.DECIMAL) else r.type
        if lt.kind == K.DECIMAL and rt.kind == K.DECIMAL:
            if opname == "mul":
                p, s = _adapt_decimal(lt.p + rt.p, lt.s + rt.s)
                t = Type.decimal(p, s, nullable)
            elif opname == "div":
                t = self._decimal_div_type(lt, rt).as_nullable(nullable)
            elif opname == "mod":
                t = Type.decimal(max(lt.p, rt.p), max(lt.s, rt.s), nullable)
            else:
                s = max(lt.s, rt.s)
                p = min(max(lt.p - lt.s, rt.p - rt.s) + s + 1, 38)
                t = Type.decimal(p, s, nullable)
            return Call(opname, [self.coerce(l, lt), self.coerce(r, rt)], t)
        t = common_numeric(l.type, r.type)
        if opname == "div" and t.is_integer:
            pass  # integer division semantics (truncating) kept
        return Call(opname, [self.coerce(l, t), self.coerce(r, t)], t.as_nullable(nullable))

    def make_cmp(self, op: str, l: BExpr, r: BExpr) -> BExpr:
        t = self.common_type(l.type, r.type)
        nullable = l.type.nullable or r.type.nullable or l.type.kind == K.NULL or r.type.kind == K.NULL
        return Call(op, [self.coerce(l, t), self.coerce(r, t)], Type.bool_(nullable))

    def common_type(self, a: Type, b: Type) -> Type:
        if a.kind == K.NULL:
            return b.as_nullable()
        if b.kind == K.NULL:
            return a.as_nullable()
        if a.base_eq(b):
            return a.as_nullable(a.nullable or b.nullable)
        if a.is_string and b.is_string:
            return Type.string(a.nullable or b.nullable)
        if a.is_numeric and b.is_numeric:
            return common_numeric(a, b)
        if a.kind in (K.DATE, K.TIMESTAMP) and b.is_string:
            return a
        if b.kind in (K.DATE, K.TIMESTAMP) and a.is_string:
            return b
        if a.kind == K.DATE and b.kind == K.TIMESTAMP:
            return b
        if a.kind == K.TIMESTAMP and b.kind == K.DATE:
            return a
        if a.kind == K.BOOL and b.kind == K.BOOL:
            return Type.bool_(a.nullable or b.nullable)
        # string vs numeric: cast string to the numeric type
        if a.is_string and b.is_numeric:
            return b
        if b.is_string and a.is_numeric:
            return a
        raise BindError(f"no common type for {a} and {b}")

    def coerce(self, e: BExpr, t: Type) -> BExpr:
        if e.type.base_eq(t):
            return e
        if e.type.kind == K.NULL:
            return Const(None, t.as_nullable())
        return Cast(e, t.as_nullable(e.type.nullable))

    def bind_func(self, e: A.FuncCall, scope: Scope, post_agg, subq) -> BExpr:
        if e.over is not None:
            raise BindError("window function in unsupported position (handled in select binding)")
        if e.name in AGG_FNS or (e.name == "count" and e.star):
            raise BindError(f"aggregate {e.name} not allowed here")
        args = [self._bind(a, scope, post_agg, subq) for a in e.args]
        return self.bind_runtime_fn(e.name, args)

    def bind_runtime_fn(self, name: str, args: list[BExpr]) -> BExpr:
        """Scalar function registry (reference: RuntimeFunctions.cpp)."""
        nullable = any(a.type.nullable for a in args)
        n = name
        if n in ("upper", "lower", "ltrim", "rtrim", "trim", "reverse"):
            return Call(n, [self.coerce(args[0], Type.string(args[0].type.nullable))], Type.string(nullable))
        if n in ("length", "char_length", "character_length"):
            return Call("length", args, Type.bigint(nullable))
        if n == "concat":
            # PostgreSQL's concat() skips NULL arguments (|| gives NULL)
            parts = []
            for a in args:
                if a.type.kind == K.NULL:
                    continue
                a = self.coerce(a, Type.string(a.type.nullable))
                if a.type.nullable:
                    a = Call("coalesce", [a, Const("", Type.string())],
                             Type.string(False))
                parts.append(a)
            if not parts:
                return Const("", Type.string())
            return Call("concat", parts, Type.string(False))
        if n == "substr" or n == "substring":
            ln = args[2] if len(args) > 2 else Const(1 << 30, Type.int_())
            return Call("substring", [args[0], args[1], ln], Type.string(nullable))
        if n == "replace":
            return Call("replace", args, Type.string(nullable))
        if n == "coalesce":
            t = args[0].type
            for a in args[1:]:
                t = self.common_type(t, a.type) if a.type.kind != K.NULL else t
            t = t.as_nullable(all(a.type.nullable or a.type.kind == K.NULL for a in args))
            return Call("coalesce", [self.coerce(a, t.as_nullable(a.type.nullable)) for a in args], t)
        if n == "nullif":
            t = self.common_type(args[0].type, args[1].type)
            return Call("nullif", [self.coerce(a, t) for a in args], t.as_nullable(True))
        if n in ("abs", "round", "floor", "ceil", "ceiling", "sqrt", "exp", "ln", "log10", "sin", "cos", "pow", "power"):
            n = {"ceiling": "ceil", "power": "pow"}.get(n, n)
            a0 = args[0]
            if n == "round" and a0.type.kind == K.DECIMAL:
                digits = args[1] if len(args) > 1 else Const(0, Type.int_())
                return Call("round", [a0, digits], a0.type.as_nullable(nullable))
            if n in ("abs", "floor", "ceil", "round") and a0.type.kind in (K.INT, K.BIGINT, K.DECIMAL):
                if n == "round" and len(args) > 1:
                    return Call("round", [a0, args[1]], a0.type.as_nullable(nullable))
                return Call(n, [a0], a0.type)
            t = Type.double(nullable)
            return Call(n, [self.coerce(a, Type.double(a.type.nullable)) for a in args], t)
        if n in ("date_part",):
            part = args[0]
            if not isinstance(part, Const):
                raise BindError("date_part requires constant part")
            if part.value is None:
                return Const(None, Type.bigint(True))
            return Call(f"extract_{str(part.value).lower()}", [args[1]], Type.bigint(nullable))
        if n == "date_trunc":
            part = args[0]
            return Call("date_trunc", args, args[1].type.as_nullable(nullable))
        if n == "datediff":
            part = args[0]
            if not isinstance(part, Const):
                raise BindError("datediff requires constant unit")
            return Call(f"datediff_{str(part.value).lower()}", args[1:],
                        Type.bigint(nullable))
        if n == "hash":
            return Call("hash", args, Type.bigint(False))
        if n == "regexp_replace":
            return Call("regexp_replace", args, args[0].type.as_nullable(nullable))
        if n in ("starts_with", "startswith"):
            return Call("startswith", args, Type.bool_(nullable))
        if n in ("ends_with", "endswith"):
            return Call("endswith", args, Type.bool_(nullable))
        if n == "row":
            raise BindError("row constructor not supported here")
        # user-defined function?
        f = getattr(self.catalog, "get_function", lambda _n: None)(n)
        if f is not None:
            if len(args) != len(f.arg_types):
                raise BindError(f"UDF {n} expects {len(f.arg_types)} arguments")
            args = [
                self.coerce(a, at.as_nullable(a.type.nullable))
                for a, at in zip(args, f.arg_types)
            ]
            return Call(f"udf:{n}", args, f.return_type.as_nullable(nullable))
        raise BindError(f"unknown function {name}")

    def _default_name(self, e: A.Expr) -> str:
        if isinstance(e, A.ColumnRef):
            return e.parts[-1]
        if isinstance(e, A.FuncCall):
            return e.name
        if isinstance(e, A.ExtractExpr):
            return e.part
        if isinstance(e, A.Cast):
            return self._default_name(e.expr)
        return "?column?"


def plan_free_cols(plan: L.LogicalOp) -> set[int]:
    """Column ids referenced by expressions in the plan but not produced by
    any node inside it (i.e. correlated references to outer queries)."""
    defined: set[int] = set()
    used: set[int] = set()
    for node in L.walk_plan(plan):
        if isinstance(node, L.Aggregate):
            # group columns pass through (same cid): they are definitions
            # only if some node below defines them — a correlated GROUP BY
            # outer-column must stay visible as free
            defined |= {a.out.cid for a in node.aggs}
        else:
            for c in node.output_cols():
                defined.add(c.cid)
        if isinstance(node, L.Scan):
            for r in node.restrictions:
                used |= E.used_cols(r)
        elif isinstance(node, L.Select):
            used |= E.used_cols(node.predicate)
        elif isinstance(node, L.Map):
            for _c, e in node.computed:
                used |= E.used_cols(e)
        elif isinstance(node, L.Join) and node.predicate is not None:
            used |= E.used_cols(node.predicate)
        # cid-carrying (non-expression) references: aggregate args, group-by
        # keys, window specs, sort keys, distinct keys — an aggregate over a
        # bare outer column (SELECT SUM(i1.i)) references the outer cid here
        if isinstance(node, L.Aggregate):
            used |= set(node.group_by)
            used |= {a.arg for a in node.aggs if a.arg is not None}
        elif isinstance(node, L.Window):
            used |= set(node.partition_by)
            used |= {k.cid for k in node.order_by}
            used |= {f.arg for f in node.funcs if f.arg is not None}
        elif isinstance(node, (L.Sort, L.TopK)):
            used |= {k.cid for k in node.keys}
        elif isinstance(node, L.Distinct):
            used |= set(node.cids)
    return used - defined


def _is_count_output(plan: L.LogicalOp, cid: int) -> bool:
    """COUNT subqueries coalesce empty results to 0 — but only when every
    group key was added by the unnesting machinery; a user-written GROUP BY
    that produces no group yields NULL (no row), matching the reference."""
    for node in L.walk_plan(plan):
        if isinstance(node, L.Aggregate):
            for a in node.aggs:
                if a.out.cid == cid and a.fn in ("count", "count_star"):
                    machine = getattr(node, "_domain_cids", set())
                    return set(node.group_by) <= set(machine)
    return False


def _ast_has_subquery(e) -> bool:
    if isinstance(e, (A.ScalarSubquery, A.Exists, A.InSubquery,
                      A.QuantifiedComparison)):
        return True
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, A.Expr) and _ast_has_subquery(v):
            return True
        if isinstance(v, list):
            for i in v:
                if isinstance(i, A.Expr) and _ast_has_subquery(i):
                    return True
                if isinstance(i, tuple) and any(
                        isinstance(j, A.Expr) and _ast_has_subquery(j) for j in i):
                    return True
    return False


def _is_trivial_chain(plan: L.LogicalOp) -> bool:
    node = plan
    while isinstance(node, (L.Map, L.Select)):
        node = node.children()[0]
    return isinstance(node, L.ConstRel) and len(node.rows) == 1 and not node.cols


def _try_inline_trivial(plan: L.LogicalOp, cid: int):
    """If a subquery plan is just Map/Select over a one-row dummy relation
    (SELECT <expr> without FROM), return the defining expression so it can be
    inlined into the outer query — this is how correlated no-FROM subqueries
    like (SELECT 42+t.i) execute without a dependent join."""
    computed: dict[int, BExpr] = {}
    selects: list[BExpr] = []
    node = plan
    while True:
        if isinstance(node, L.Map):
            for c, e in node.computed:
                computed[c.cid] = e
            node = node.child
        elif isinstance(node, L.Select):
            selects.append(node.predicate)
            node = node.child
        elif isinstance(node, L.ConstRel) and len(node.rows) == 1 and not node.cols:
            break
        else:
            return None

    def resolve(e: BExpr) -> BExpr:
        if isinstance(e, ColRef) and e.cid in computed:
            return resolve(computed[e.cid])
        if isinstance(e, Call):
            return Call(e.op, [resolve(a) for a in e.args], e.type)
        if isinstance(e, Cast):
            return Cast(resolve(e.arg), e.type)
        if isinstance(e, CaseExpr):
            return CaseExpr(
                [(resolve(c), resolve(v)) for c, v in e.whens],
                None if e.else_ is None else resolve(e.else_), e.type,
            )
        return e

    if cid not in computed:
        return None
    out = resolve(computed[cid])
    if selects:
        cond = E.make_and([resolve(s) for s in selects])
        out = CaseExpr([(cond, out)], None, out.type.as_nullable())
    return out


# ------------------------------------------------------------------- helpers
_CMP_OPS = {
    "=": "eq", "==": "eq", "<>": "neq", "!=": "neq",
    "<": "lt", "<=": "lte", ">": "gt", ">=": "gte",
    "eq": "eq", "neq": "neq", "lt": "lt", "lte": "lte", "gt": "gt", "gte": "gte",
}
_NEGATED_CMP = {
    "eq": "neq", "neq": "eq", "lt": "gte", "lte": "gt", "gt": "lte", "gte": "lt",
}


def _sum_type(arg_t: Type) -> Type:
    """sum's type, as PostgreSQL's: an INT sums to a BIGINT, a BIGINT to a
    numeric (here DECIMAL(38, 0): exact past int64), a decimal keeps its
    scale with ten more digits (the reference keeps the argument's type)."""
    if arg_t.kind == K.INT:
        return Type.bigint(True)
    if arg_t.kind == K.BIGINT:
        return Type.decimal(38, 0, True)
    if arg_t.kind == K.DECIMAL:
        return Type.decimal(min(arg_t.p + 10, 38), arg_t.s, True)
    return arg_t.as_nullable()


def _adapt_decimal(p: int, s: int) -> tuple[int, int]:
    # reference: sql_analyzer.cpp getAdaptedDecimalPAndSAfterMulDiv
    before = p - s
    if before > 32 and s > 6:
        return 38, 6
    if before > 32:
        return 38, s
    return min(p, 38), min(s, 38 - before)


def _looks_numeric(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _ast_key(e: A.Expr) -> str:
    """Structural key for AST expressions (used to match GROUP BY exprs with
    identical select expressions)."""
    if isinstance(e, A.ColumnRef):
        return "col:" + ".".join(e.parts)
    if isinstance(e, A.Literal):
        return f"lit:{e.value!r}:{e.type_hint}"
    parts = [type(e).__name__]
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, A.Expr):
            parts.append(_ast_key(v))
        elif isinstance(v, list):
            for i in v:
                if isinstance(i, A.Expr):
                    parts.append(_ast_key(i))
                elif isinstance(i, tuple):
                    parts.extend(_ast_key(j) for j in i if isinstance(j, A.Expr))
        else:
            parts.append(repr(v))
    return "(" + " ".join(parts) + ")"


def _bexpr_key(e: BExpr) -> str:
    return repr(e)
