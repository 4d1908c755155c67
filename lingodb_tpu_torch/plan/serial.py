"""Canonical plan serialization for compilation caching.

Analogue of the reference's query compilation cache
(reference: the ORC JIT object cache, LLVMBackends.cpp:81-460). Two
executions of the same SQL bind to identical plans (the binder's cid counter
is deterministic), so a stable string key over the plan identifies a
compiled stage; the session keeps plan_key -> jitted-function maps.
"""

from __future__ import annotations

from . import logical as L
from .exprs import BExpr


def expr_key(e: BExpr) -> str:
    return repr(e)


def plan_key(op: L.LogicalOp) -> str:
    parts = [type(op).__name__]
    if isinstance(op, L.Scan):
        parts.append(op.table)
        parts.append(",".join(f"{c.cid}:{c.name}" for c in op.cols))
        parts.extend(expr_key(r) for r in op.restrictions)
    elif isinstance(op, L.ConstRel):
        parts.append(repr(op.rows))
    elif isinstance(op, L.Select):
        parts.append(expr_key(op.predicate))
    elif isinstance(op, L.Map):
        parts.extend(f"{c.cid}={expr_key(e)}" for c, e in op.computed)
    elif isinstance(op, L.Join):
        parts.append(op.kind)
        parts.append(expr_key(op.predicate) if op.predicate else "-")
    elif isinstance(op, L.Aggregate):
        parts.append(repr(op.group_by))
        parts.extend(f"{a.out.cid}={a.fn}({a.arg}){'d' if a.distinct else ''}" for a in op.aggs)
    elif isinstance(op, (L.Sort, L.TopK)):
        parts.extend(f"{k.cid}{k.ascending}{k.nulls_first}" for k in op.keys)
        if isinstance(op, L.TopK):
            parts.append(f"n={op.n},o={op.offset}")
    elif isinstance(op, L.Limit):
        parts.append(f"n={op.n},o={op.offset}")
    elif isinstance(op, L.Distinct):
        parts.append(repr(op.cids))
    elif isinstance(op, L.SetOp):
        parts.append(f"{op.kind}{op.all}{op.lmap}{op.rmap}")
    elif isinstance(op, L.Window):
        parts.append(repr(op.partition_by))
        parts.extend(f"{k.cid}{k.ascending}" for k in op.order_by)
        parts.extend(f"{f.out.cid}={f.fn}({f.arg},{f.extra},{f.default!r})"
                     for f in op.funcs)
    elif isinstance(op, L.Materialize):
        parts.append(repr(op.cids))
    elif isinstance(op, L.Tmp):
        parts.append(plan_key(op.holder.plan))
        parts.append(repr([(s, c.cid) for s, c in op.mapping]))
    elif isinstance(op, L.Iterate):
        parts.append(f"{op.distinct}{op.emit}{op.lmap}{op.smap}")
    elif isinstance(op, L.IterRef):
        parts.append(repr([c.cid for c in op.cols]))
    children = ";".join(plan_key(c) for c in op.children())
    return "(" + " ".join(parts) + (("|" + children) if children else "") + ")"


# -------------------------------------------------- JSON plan serialization
# The analogue of the reference's plan import/export surface (run-mlir reads
# serialized IR, tools/ct/mlir-relalg-to-json.cpp exports relalg as JSON for
# the web tooling). Reflective over the plan/expr dataclasses.

import dataclasses
import json as _json

from ..sql.types import IntervalUnit, Type
from . import exprs as E


def _enc(v, memo=None):
    if isinstance(v, Type):
        from ..catalog.catalog import type_to_json

        return {"$type": type_to_json(v)}
    if isinstance(v, IntervalUnit):
        return {"$unit": v.value}
    if isinstance(v, L.TmpHolder):
        # shared holders serialize once; later references point back by index
        if memo is None:
            memo = {}
        if id(v) in memo:
            return {"$tmpref": memo[id(v)]}
        idx = len(memo)
        memo[id(v)] = idx
        return {"$tmpholder": idx, "plan": _enc(v.plan, memo)}
    if isinstance(v, L.IterateHolder):
        # pure identity: same instance encodes to the same tag
        if memo is None:
            memo = {}
        key = ("it", id(v))
        if key not in memo:
            memo[key] = f"it{len(memo)}"
        return {"$iterholder": memo[key]}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        d = {"$cls": type(v).__name__}
        for f in dataclasses.fields(v):
            d[f.name] = _enc(getattr(v, f.name), memo)
        return d
    if isinstance(v, tuple):
        return {"$tuple": [_enc(i, memo) for i in v]}
    if isinstance(v, list):
        return [_enc(i, memo) for i in v]
    if hasattr(v, "item") and not isinstance(v, (bool, int, float, str)):
        return v.item()  # numpy scalar
    return v


def _registry():
    reg = {}
    for mod in (L, E):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                reg[name] = obj
    return reg


_REG = None


def _dec(v, memo=None):
    global _REG
    if isinstance(v, dict):
        if "$type" in v:
            from ..catalog.catalog import type_from_json

            return type_from_json(v["$type"])
        if "$unit" in v:
            return IntervalUnit(v["$unit"])
        if "$tmpholder" in v:
            if memo is None:
                memo = {}
            holder = L.TmpHolder(None)
            memo[v["$tmpholder"]] = holder
            holder.plan = _dec(v["plan"], memo)
            return holder
        if "$tmpref" in v:
            return memo[v["$tmpref"]]
        if "$iterholder" in v:
            if memo is None:
                memo = {}
            tag = v["$iterholder"]
            if tag not in memo:
                memo[tag] = L.IterateHolder()
            return memo[tag]
        if "$tuple" in v:
            return tuple(_dec(i, memo) for i in v["$tuple"])
        if "$cls" in v:
            if _REG is None:
                _REG = _registry()
            cls = _REG[v["$cls"]]
            kwargs = {k: _dec(x, memo) for k, x in v.items() if k != "$cls"}
            return cls(**kwargs)
        return {k: _dec(x, memo) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(i, memo) for i in v]
    return v


def plan_to_json(op: L.LogicalOp) -> str:
    return _json.dumps(_enc(op, {}))


def plan_from_json(s: str) -> L.LogicalOp:
    return _dec(_json.loads(s), {})
