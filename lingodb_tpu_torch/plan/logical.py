"""Logical relational plan IR.

Equivalent of the reference's RelAlg dialect
(reference: include/lingodb/compiler/Dialect/RelAlg/IR/RelAlgOps.td:108-536 —
const_relation, basetable, selection, map, limit, topk, crossproduct,
aggregation, groupjoin, window, sort, join variants, projection, set ops,
materialize). Columns are identified by integer ids issued by the binder; each
operator reports its output schema as a list of ColInfo.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..sql.types import Type
from .exprs import BExpr


@dataclass(frozen=True)
class ColInfo:
    cid: int
    name: str
    type: Type


class LogicalOp:
    """Base class. Subclasses define `children` and `output_cols()`."""

    def children(self) -> list["LogicalOp"]:
        return []

    def output_cols(self) -> list[ColInfo]:
        raise NotImplementedError

    def replace_children(self, new: list["LogicalOp"]) -> "LogicalOp":
        raise NotImplementedError

    # pretty printer --------------------------------------------------------
    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        head = pad + self._describe()
        lines = [head]
        for c in self.children():
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def _describe(self) -> str:
        return type(self).__name__


@dataclass
class Scan(LogicalOp):
    """Base-table scan (reference: relalg.basetable, RelAlgOps.td:120)."""

    table: str
    cols: list[ColInfo]  # one per selected column; name = storage column name
    # scan-time restrictions pushed down by the optimizer
    # (reference: runtime/storage/Restrictions.cpp)
    restrictions: list[BExpr] = field(default_factory=list)

    def output_cols(self):
        return list(self.cols)

    def replace_children(self, new):
        assert not new
        return self

    def _describe(self):
        r = f" where {self.restrictions}" if self.restrictions else ""
        return f"Scan {self.table}{r}"


@dataclass
class ConstRel(LogicalOp):
    """Inline VALUES (reference: relalg.const_relation, RelAlgOps.td:108)."""

    cols: list[ColInfo]
    rows: list[list]  # python values, already coerced to col types

    def output_cols(self):
        return list(self.cols)

    def replace_children(self, new):
        assert not new
        return self


@dataclass
class Select(LogicalOp):
    """Filter (reference: relalg.selection, RelAlgOps.td:136)."""

    child: LogicalOp
    predicate: BExpr

    def children(self):
        return [self.child]

    def output_cols(self):
        return self.child.output_cols()

    def replace_children(self, new):
        return Select(new[0], self.predicate)

    def _describe(self):
        return f"Select {self.predicate!r}"


@dataclass
class Map(LogicalOp):
    """Compute new columns (reference: relalg.map, RelAlgOps.td:155)."""

    child: LogicalOp
    computed: list[tuple[ColInfo, BExpr]]

    def children(self):
        return [self.child]

    def output_cols(self):
        return self.child.output_cols() + [c for c, _ in self.computed]

    def replace_children(self, new):
        return Map(new[0], self.computed)

    def _describe(self):
        return "Map " + ", ".join(f"#{c.cid}={e!r}" for c, e in self.computed)


JOIN_KINDS = ("cross", "inner", "left", "full", "semi", "anti", "single", "mark")


@dataclass
class Join(LogicalOp):
    """All join variants (reference: RelAlgOps.td:195,280-391).

    - cross/inner/left/full: tuple-combining joins (right is normalized to
      left by the binder via operand swap)
    - semi/anti: filter left by existence in right
    - single: scalar-subquery join — left outer, at most one match expected
    - mark: adds a boolean column `mark_col` indicating match existence
    """

    kind: str
    left: LogicalOp
    right: LogicalOp
    predicate: Optional[BExpr] = None
    mark_col: Optional[ColInfo] = None
    # NOT IN semantics: (outer_expr, inner_colref) whose NULLs make the anti
    # join null-aware (reference: null-aware anti join in RelAlgToSubOp.cpp).
    # A proper field so rewrites (reorder_joins, decorrelation) preserve it.
    null_aware: Optional[tuple] = None

    def children(self):
        return [self.left, self.right]

    def output_cols(self):
        lcols = self.left.output_cols()
        if self.kind in ("semi", "anti"):
            return lcols
        if self.kind == "mark":
            return lcols + [self.mark_col]
        rcols = self.right.output_cols()
        if self.kind in ("left", "single", "full"):
            rcols = [ColInfo(c.cid, c.name, c.type.as_nullable()) for c in rcols]
        if self.kind == "full":
            lcols = [ColInfo(c.cid, c.name, c.type.as_nullable()) for c in lcols]
        return lcols + rcols

    def replace_children(self, new):
        return Join(self.kind, new[0], new[1], self.predicate, self.mark_col,
                    self.null_aware)

    def _describe(self):
        return f"Join[{self.kind}] {self.predicate!r}"


@dataclass
class AggSpec:
    """One aggregate: out = fn(arg). fn in sum,count,min,max,avg,
    count_star, any_value, stddev_samp, var_samp, bool_and, bool_or,
    string_agg; distinct applies to the arg."""

    out: ColInfo
    fn: str
    arg: Optional[int]  # cid of the (pre-computed) argument column
    distinct: bool = False


@dataclass
class Aggregate(LogicalOp):
    """Group-by aggregation (reference: relalg.aggregation, RelAlgOps.td:223).
    With empty group_by this is a global aggregate producing exactly one row."""

    child: LogicalOp
    group_by: list[int]  # cids
    aggs: list[AggSpec]
    # group columns pass through under these infos (same cid as input)
    group_cols: list[ColInfo] = field(default_factory=list)

    def children(self):
        return [self.child]

    def output_cols(self):
        return list(self.group_cols) + [a.out for a in self.aggs]

    def replace_children(self, new):
        return Aggregate(new[0], self.group_by, self.aggs, self.group_cols)

    def _describe(self):
        return (
            f"Aggregate by={self.group_by} "
            + ", ".join(f"#{a.out.cid}={a.fn}({a.arg})" for a in self.aggs)
        )


@dataclass
class SortKey:
    cid: int
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = SQL default (last asc / first desc)


@dataclass
class Sort(LogicalOp):
    """reference: relalg.sort, RelAlgOps.td:268"""

    child: LogicalOp
    keys: list[SortKey]

    def children(self):
        return [self.child]

    def output_cols(self):
        return self.child.output_cols()

    def replace_children(self, new):
        return Sort(new[0], self.keys)

    def _describe(self):
        return "Sort " + ", ".join(
            f"#{k.cid}{'' if k.ascending else ' desc'}" for k in self.keys
        )


@dataclass
class Limit(LogicalOp):
    """reference: relalg.limit, RelAlgOps.td:171"""

    child: LogicalOp
    n: int
    offset: int = 0

    def children(self):
        return [self.child]

    def output_cols(self):
        return self.child.output_cols()

    def replace_children(self, new):
        return Limit(new[0], self.n, self.offset)

    def _describe(self):
        return f"Limit {self.n} offset {self.offset}"


@dataclass
class TopK(LogicalOp):
    """Fused sort+limit (reference: relalg.topk, RelAlgOps.td:179)."""

    child: LogicalOp
    keys: list[SortKey]
    n: int
    offset: int = 0

    def children(self):
        return [self.child]

    def output_cols(self):
        return self.child.output_cols()

    def replace_children(self, new):
        return TopK(new[0], self.keys, self.n, self.offset)

    def _describe(self):
        return f"TopK {self.n}"


@dataclass
class SetOp(LogicalOp):
    """union/intersect/except, with bag (ALL) or set semantics
    (reference: RelAlgOps.td:409-444). Output columns are fresh cids with types
    coerced across the two inputs."""

    kind: str  # union, intersect, except
    all: bool
    left: LogicalOp
    right: LogicalOp
    cols: list[ColInfo]
    # positional mapping: cols[i] <- left cid lmap[i], right cid rmap[i]
    lmap: list[int] = field(default_factory=list)
    rmap: list[int] = field(default_factory=list)

    def children(self):
        return [self.left, self.right]

    def output_cols(self):
        return list(self.cols)

    def replace_children(self, new):
        return SetOp(self.kind, self.all, new[0], new[1], self.cols, self.lmap, self.rmap)


@dataclass
class WindowFn:
    out: ColInfo
    fn: str  # rank, dense_rank, row_number, sum, min, max, count, avg, count_star, lead, lag, first_value, last_value, ntile
    arg: Optional[int]  # cid
    extra: Optional[object] = None  # lead/lag offset, nth_value / ntile argument
    default: Optional[object] = None  # lead/lag default: a constant BExpr


@dataclass
class Window(LogicalOp):
    """Window functions over one (partition, order, frame) spec
    (reference: relalg.window, RelAlgOps.td:254; lowering uses sorted views +
    segment trees, RelAlgToSubOp.cpp:2193)."""

    child: LogicalOp
    partition_by: list[int]
    order_by: list[SortKey]
    funcs: list[WindowFn]
    # frame: (start, end) in rows, None = unbounded; follows reference semantics
    frame_start: Optional[int] = None
    frame_end: Optional[int] = None
    frame_mode: str = "rows"  # rows | range | groups

    def children(self):
        return [self.child]

    def output_cols(self):
        return self.child.output_cols() + [f.out for f in self.funcs]

    def replace_children(self, new):
        return Window(
            new[0], self.partition_by, self.order_by, self.funcs,
            self.frame_start, self.frame_end, self.frame_mode,
        )


@dataclass
class Materialize(LogicalOp):
    """Final projection to the user-visible result
    (reference: relalg.materialize, RelAlgOps.td:493)."""

    child: LogicalOp
    cids: list[int]
    names: list[str]

    def children(self):
        return [self.child]

    def output_cols(self):
        types = {c.cid: c.type for c in self.child.output_cols()}
        return [ColInfo(cid, n, types[cid]) for cid, n in zip(self.cids, self.names)]

    def replace_children(self, new):
        return Materialize(new[0], self.cids, self.names)

    def _describe(self):
        return f"Materialize {self.names}"


@dataclass
class Distinct(LogicalOp):
    """SELECT DISTINCT / set-semantics dedup (lowered like a keyed aggregation
    without aggregates)."""

    child: LogicalOp
    cids: list[int]  # columns forming the distinct key (usually all)

    def children(self):
        return [self.child]

    def output_cols(self):
        return self.child.output_cols()

    def replace_children(self, new):
        return Distinct(new[0], self.cids)


class TmpHolder:
    """Shared-subtree holder: every Tmp reference to one shared subtree
    points at the same holder, so optimization and execution through it
    happen exactly once (reference: relalg.tmp materialization target,
    RelAlgOps.td:499)."""

    __slots__ = ("plan", "optimized", "seq")
    _counter = 0

    def __init__(self, plan: Optional[LogicalOp]):
        self.plan = plan
        self.optimized = False
        TmpHolder._counter += 1
        self.seq = TmpHolder._counter


@dataclass
class Tmp(LogicalOp):
    """Reference to a materialized shared subtree (reference: relalg.tmp,
    RelAlgOps.td:499; IntroduceTmp + CommonSubtreeElimination passes).
    Presents as a LEAF to rewrite passes (children() == []) so per-reference
    rewrites cannot diverge the shared plan; each reference renames the
    holder's output columns to fresh cids via `mapping`."""

    holder: TmpHolder
    mapping: list[tuple[int, ColInfo]]  # (cid in holder plan, output col)

    def children(self):
        return []

    def output_cols(self):
        return [c for _s, c in self.mapping]

    def replace_children(self, new):
        assert not new
        return self

    def _describe(self):
        return (f"Tmp@{self.holder.seq} "
                f"{[(s, c.cid) for s, c in self.mapping]}")

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [pad + self._describe()]
        if self.holder.plan is not None:
            lines.append(self.holder.plan.pretty(indent + 1))
        return "\n".join(lines)


class IterateHolder:
    """Identity object linking IterRef leaves to their enclosing Iterate
    (the analogue of the loop region's block argument in the reference's
    subop.loop, SubOperatorOps.td:937-953)."""

    __slots__ = ("seq",)
    _counter = 0

    def __init__(self):
        IterateHolder._counter += 1
        self.seq = IterateHolder._counter


@dataclass
class IterRef(LogicalOp):
    """Reference to the iteration working table inside an Iterate step plan
    (reference: the subop.loop region argument; in SQL terms, the recursive
    CTE's self-reference). Positionally aligned with Iterate.cols; a leaf so
    rewrite passes treat it as an opaque relation."""

    holder: IterateHolder
    cols: list[ColInfo]  # fresh cids per reference, positional vs Iterate.cols

    def children(self):
        return []

    def output_cols(self):
        return list(self.cols)

    def replace_children(self, new):
        assert not new
        return self

    def _describe(self):
        return f"IterRef@{self.holder.seq} {[c.cid for c in self.cols]}"


@dataclass
class Iterate(LogicalOp):
    """Iterate-until-fixpoint program (reference: subop.loop +
    subop.loop_continue, SubOperatorOps.td:937-953, lowered in
    SubOpToControlFlow; exercised by test/lit/SubOp/kmeans.mlir,
    pagerank.mlir, loop.mlir). Also the lowering target for SQL
    WITH RECURSIVE.

    Semantics: evaluate `base` once; then repeatedly evaluate `step` with
    every IterRef of this holder bound to the previous iteration's rows.
      distinct=True  (UNION):     semi-naive — the working table is only the
                                  rows not seen before; stop when empty.
      distinct=False (UNION ALL): working table = previous step output; stop
                                  when the step produces no rows.
      emit="all":  output all accumulated rows (recursive CTE semantics).
      emit="last": output only the final iteration's rows (the subop.loop
                   state-replacement analogue, e.g. kmeans centroids).
    """

    holder: IterateHolder
    base: LogicalOp
    step: LogicalOp
    cols: list[ColInfo]   # output/working columns (fresh cids)
    distinct: bool
    lmap: list[int]       # base-plan cid per output col
    smap: list[int]       # step-plan cid per output col
    emit: str = "all"     # "all" | "last"
    max_iters: int = 10_000

    def children(self):
        return [self.base, self.step]

    def output_cols(self):
        return list(self.cols)

    def replace_children(self, new):
        return Iterate(self.holder, new[0], new[1], self.cols, self.distinct,
                       self.lmap, self.smap, self.emit, self.max_iters)

    def _describe(self):
        return (f"Iterate@{self.holder.seq} "
                f"{'distinct' if self.distinct else 'all'} emit={self.emit}")


def walk_plan(op: LogicalOp):
    yield op
    for c in op.children():
        yield from walk_plan(c)
