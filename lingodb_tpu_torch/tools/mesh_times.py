"""Statements of chip_smoke.py's phase 12 (its MESH_STATEMENTS, and TPC-H
queries named qN) on a mesh: wall ms (median and least of 5 runs after
two, the result's rows formatted on the host inside each), host syncs,
device ms and kernel launches of one run (torch.profiler), for the tree it
is run from.

Run from the root of a checkout (the package and chip_smoke.py imported
are the ones in the current directory, so one copy of this file times two
trees in one call):

    python3 -m lingodb_tpu_torch.tools.mesh_times LABEL      # SF1
    SF=0.5 ONLY=q1,q6,semi MESH=cards python3 /path/to/mesh_times.py LABEL

MESH=one (the default) is 8 positions of the session's card, MESH=cards
one position on each card; ONLY picks statements by name (a name the
tree's chip_smoke.py lacks is skipped). Prints one line a statement:
LABEL, its name and a JSON object; the statement's rows, as a digest,
tell two trees apart.
"""

import hashlib
import json
import os
import statistics
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.parallel.mesh import Mesh
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.tools import gpu_profile, tpchgen

    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    stmts = {name: sql for name, (sql, _moves)
             in chip_smoke.MESH_STATEMENTS.items()}
    only = os.environ.get("ONLY")
    names = only.split(",") if only else (
        [f"q{q}" for q in chip_smoke.MESH_QUERIES] + list(stmts))
    t = tpchgen.generate(float(os.environ.get("SF", "1")), 19920601)
    s = ldb.create_in_memory()
    tpchgen.install(s, t)
    if os.environ.get("MESH", "one") == "cards":
        cards = torch.cuda.device_count()
        mesh = Mesh([torch.device("cuda", i) for i in range(cards)])
    else:
        cards = 1
        mesh = Mesh([s.device] * 8)

    def sync():
        for i in range(cards):
            torch.cuda.synchronize(i)

    for name in names:
        if name in stmts:
            sql = stmts[name]
        elif name.startswith("q"):
            sql = open(f"queries/tpch/{name[1:]}.sql").read()
        else:
            continue
        dv._MESH, dv._MESH_INIT = mesh, True
        s.sql(sql)
        s.sql(sql)
        walls = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            rows = s.sql(sql).format_rows()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        syncs, _peak, _ = gpu_profile.syncs_and_peak(
            torch, lambda: s.sql(sql).format_rows())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s.sql(sql).format_rows()
            sync()
        ev = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in ev
                     if e.self_device_time_total > 0)
        launches = sum(e.count for e in ev
                       if e.key in gpu_profile.LAUNCH_CALLS)
        dv._MESH = None
        out = {"median_ms": statistics.median(walls),
               "min_ms": min(walls), "syncs": syncs,
               "device_ms": dev_us / 1e3, "launches": launches,
               "rows": len(rows), "digest": hashlib.sha1(
                   json.dumps(rows).encode()).hexdigest()[:12]}
        print(label, name, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
