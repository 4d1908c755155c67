"""Cardinality estimation from table samples and statistics.

Equivalent of the reference's estimator
(reference: queryopt/QueryGraph.cpp:264-299 + estimateSelectivity:418+ —
selectivity from evaluating predicates over the catalog's stored 1024-row
sample with Arrow compute; join selectivity from HLL distinct counts). Here
predicates evaluate over the sample with the engine's own expression
kernels on the local CPU backend."""

from __future__ import annotations

import numpy as np

from ..plan import exprs as E
from ..plan import logical as L
from ..plan.exprs import BExpr, Call, ColRef


_SEL_CACHE: dict = {}


def scan_selectivity(entry, scan: L.Scan, preds: list[BExpr]) -> float:
    """Evaluate predicates on the table sample; fraction of surviving rows.
    Memoized per (table, version, predicate set)."""
    if not preds or entry is None or entry.storage is None or entry.num_rows == 0:
        return 1.0
    if entry.num_rows < 2048:
        s = 1.0
        for p in preds:
            s *= default_selectivity(p)
        return s
    ck = (entry.name, entry.storage.version, tuple(repr(p) for p in preds))
    hit = _SEL_CACHE.get(ck)
    if hit is not None:
        return hit
    sel = _scan_selectivity_uncached(entry, scan, preds)
    if len(_SEL_CACHE) > 4096:
        _SEL_CACHE.clear()
    _SEL_CACHE[ck] = sel
    return sel


def _scan_selectivity_uncached(entry, scan: L.Scan, preds: list[BExpr]) -> float:
    try:
        import numpy as np

        from ..ops import scalar as sc
        from ..runtime.vtable import SCol

        # the sample is evaluated on the host numpy tier: no device work
        storage = entry.storage
        idx = storage.sample_indices()
        env = {}
        for info in scan.cols:
            col = storage.column(info.name)
            data = col.data[idx]
            valid = None if col.valid is None else col.valid[idx]
            env[info.cid] = SCol(
                col.type, np.asarray(data),
                None if valid is None else np.asarray(valid),
                col.dictionary,
            )
        n = max(len(idx), 1)
        # evaluate the CONJUNCTION on the sample (one combined mask), not
        # the product of per-predicate marginals — range predicates
        # (two one-sided bounds on the same column) and correlated
        # predicates are wildly overestimated otherwise
        combined = None
        for p in preds:
            m = sc.truth_mask(sc.eval_expr(p, env))
            combined = m if combined is None else (combined & m)
        frac = float(np.mean(np.asarray(combined).astype(np.float32)))
        return max(frac, 0.5 / n)
    except Exception:
        s = 1.0
        for p in preds:
            s *= default_selectivity(p)
        return s


def default_selectivity(p: BExpr) -> float:
    if isinstance(p, Call):
        if p.op in ("eq", "nseq"):
            return 0.1
        if p.op in ("lt", "lte", "gt", "gte"):
            return 0.35
        if p.op == "neq":
            return 0.9
        if p.op == "and":
            s = 1.0
            for a in p.args:
                s *= default_selectivity(a)
            return s
        if p.op == "or":
            s = 1.0
            for a in p.args:
                s *= 1.0 - default_selectivity(a)
            return 1.0 - s
        if p.op in ("like", "ilike"):
            return 0.25
        if p.op == "in":
            return min(0.1 * (len(p.args) - 1), 0.9)
    return 0.5


class ColumnOrigins:
    """Map column ids to (table entry, column name) for base-table columns."""

    def __init__(self, rels: list[L.LogicalOp], catalog):
        self.origin: dict[int, tuple] = {}
        for r in rels:
            for node in L.walk_plan(r):
                if isinstance(node, L.Scan):
                    entry = catalog.get_table(node.table)
                    for c in node.cols:
                        self.origin[c.cid] = (entry, c.name)

    def distinct(self, cid: int, fallback: float) -> float:
        o = self.origin.get(cid)
        if o is None or o[0] is None:
            return fallback
        return max(o[0].distinct_count(o[1]), 1)


def join_selectivity(pred: BExpr, origins: ColumnOrigins, lcard: float, rcard: float) -> float:
    """Equi-join: 1/max(d_l, d_r) with distinct counts from the catalog
    (reference: QueryGraph.cpp uses HLL counts the same way)."""
    if isinstance(pred, Call) and pred.op in ("eq", "nseq"):
        ds = []
        for arg in pred.args:
            cols = E.used_cols(arg)
            if len(cols) == 1:
                ds.append(origins.distinct(next(iter(cols)), max(min(lcard, rcard), 1)))
        if len(ds) == 2:
            return 1.0 / max(max(ds), 1.0)
        return 1.0 / max(min(lcard, rcard), 1.0)
    return default_selectivity(pred)
