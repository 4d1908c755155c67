"""A query's time through Session.prepare + execute_prepared against
Session.sql on the card, and what each run did besides its kernels.

    python3 -m lingodb_tpu_torch.tools.prepared_split --sf 1 \\
        --queries 6,1,14,3,4,2,10,18,21,8,9,11,16,17,20 \\
        --out out/prepared_split.json

Tables are generated once; each query runs three times through
`Session.sql` (calibration, capture, replay). Then, in this order, each
timed on the host's clock and ended by a synchronize:

  sql            one more run through Session.sql
  split          Session.prepare (front) then execute_prepared (execution)
                 with nothing special before it
  split_again    the same, right after
  after_syncs    the same, right after one run under
                 tools.gpu_profile.syncs_and_peak (sync debug mode)
  after_profile  the same, right after tools.gpu_profile.profile_query (a
                 torch.profiler trace, then a syncs_and_peak run)

and for every run the compilestats delta of its execution (captures,
replays, calibrations, uploads, evictions) and the card's free memory
share before it. Then the 22 TPC-H queries through sql_many(overlap=True)
against sequential sql, each from evicted device memory, as chip_smoke.py
phase 9 (e) runs them, twice in alternating order. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

KEPT = ("captures", "replays", "calibrations", "uploads", "evictions")


def _free_share(torch) -> float:
    free, total = torch.cuda.mem_get_info()
    return free / total


def _timed_sql(torch, session, sql: str) -> dict:
    from ..utils import compilestats

    torch.cuda.synchronize()
    free = _free_share(torch)
    cs0 = compilestats.snapshot()
    t0 = time.perf_counter()
    rows = session.sql(sql).format_rows()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    d = compilestats.delta(cs0)
    return {"ms": ms, "free_share": free, "rows": rows,
            **{k: d[k] for k in KEPT}}


def _timed_split(torch, session, sql: str) -> dict:
    """front ms (prepare), execution ms (execute_prepared + format_rows),
    and the execution's compilestats delta."""
    from ..utils import compilestats

    torch.cuda.synchronize()
    free = _free_share(torch)
    cs0 = compilestats.snapshot()
    t0 = time.perf_counter()
    prepared = session.prepare(sql)
    t1 = time.perf_counter()
    cs1 = compilestats.snapshot()
    rows = session.execute_prepared(prepared).format_rows()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    front = compilestats.delta(cs0)
    d = compilestats.delta(cs1)
    return {"front_ms": (t1 - t0) * 1e3, "execution_ms": (t2 - t1) * 1e3,
            "free_share": free, "rows": rows,
            "front_uploads": front["uploads"] - d["uploads"],
            **{k: d[k] for k in KEPT}}


def split_report(torch, session, sql: str) -> dict:
    """The runs listed in the module docstring, for one query whose
    programs are already captured."""
    from . import gpu_profile

    out = {"sql": _timed_sql(torch, session, sql),
           "split": _timed_split(torch, session, sql),
           "split_again": _timed_split(torch, session, sql)}
    gpu_profile.syncs_and_peak(torch,
                               lambda: session.sql(sql).format_rows())
    out["after_syncs"] = _timed_split(torch, session, sql)
    gpu_profile.profile_query(torch, session, sql)
    out["after_profile"] = _timed_split(torch, session, sql)
    want = out["sql"]["rows"]
    for name, run in out.items():
        if run.pop("rows") != want:
            raise RuntimeError(f"{name}: rows differ from Session.sql's")
    return out


def sql_many_report(torch, session, rounds: int = 2) -> dict:
    """The 22 queries through sql_many(overlap=True) and through sequential
    sql, each from evicted device memory, in the order sequential, many,
    many, sequential (rounds=2)."""
    here = os.path.dirname(os.path.abspath(__file__))
    qdir = os.path.join(os.path.dirname(os.path.dirname(here)), "queries",
                        "tpch")
    qs = [open(os.path.join(qdir, f"{i}.sql")).read() for i in range(1, 23)]
    out = {"sequential_ms": [], "sql_many_ms": []}
    order = ["sequential", "many", "many", "sequential"][:2 * rounds]
    want = None
    for kind in order:
        session._evict_device_memory()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "sequential":
            got = [session.sql(q).format_rows() for q in qs]
        else:
            got = [r.format_rows() for r in session.sql_many(qs, overlap=True)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out["sequential_ms" if kind == "sequential" else "sql_many_ms"].append(ms)
        if want is None:
            want = got
        elif got != want:
            raise RuntimeError(f"{kind}: rows differ from the first round")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--queries", default="6,1,14,3,4,2,10,18,21,8,9,11,16,17,20")
    ap.add_argument("--no-sql-many", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("prepared_split: no CUDA device", file=sys.stderr)
        return 1
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import tpchgen

    here = os.path.dirname(os.path.abspath(__file__))
    qdir = os.path.join(os.path.dirname(os.path.dirname(here)), "queries",
                        "tpch")
    s = ldb.create_in_memory()
    tpchgen.install(s, tpchgen.generate(args.sf, args.seed))
    report = {"device": torch.cuda.get_device_name(0), "sf": args.sf,
              "queries": {}}
    for q in [x for x in args.queries.split(",") if x]:
        sql = open(os.path.join(qdir, f"{q}.sql")).read()
        for _ in range(3):
            s.sql(sql).format_rows()
        r = split_report(torch, s, sql)
        report["queries"][q] = r
        print(f"q{q}: sql {r['sql']['ms']:.2f} ms; " + "; ".join(
            f"{k} {v['front_ms']:.2f}/{v['execution_ms']:.2f} ms "
            f"(cap {v['captures']} rep {v['replays']} cal "
            f"{v['calibrations']} up {v['uploads']} ev {v['evictions']} "
            f"free {v['free_share']:.3f})"
            for k, v in r.items() if k != "sql"), flush=True)
    if not args.no_sql_many:
        report["sql_many"] = sql_many_report(torch, s)
        print(f"sql_many: {json.dumps(report['sql_many'])}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
