"""The engine's two gathers (K1 gather_chunked, K2 gather_sorted) as
chip_smoke.py's phase 3 times them, and the eager TPC-H queries of its
phase 4, for the tree it is run from.

Run from the root of a checkout: the package and chip_smoke.py imported are
the ones in the current directory, so one copy of this file times two trees
in one call, in turns (parent, change, change, parent):

    python3 /path/to/gather_times.py LABEL [--sf 1] [--reps 5]

Phase 3's cases (its check_sorted and check_chunked at lineitem's length
at SF1, on the mask that its check_compact hands check_sorted): per case
the call ms (CUDA events around 10 calls), card ms (torch.profiler), the
bytes bound, the sector floor where the tree's chip_smoke.py computes it,
and index_select's call and card ms on the same stacked table. Then each
query over TPC-H at --sf with the fused programs declined (the eager
operators): the wall ms of --reps runs after two (median and least), and
from tools/gpu_profile.py's profile of one more run the device ms and the
kernels the card ran (all of them, the library's too), and the engine
kernels' launches of one run, counted by their wrappers. One line a case and a query:
LABEL, then a JSON object. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

LINEITEM_SF1 = 5_997_593


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--queries", default="6,1,14,3,4")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("gather_times: FAILED: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.ops import cuda_build
    from lingodb_tpu_torch.ops import pgather as pg
    from lingodb_tpu_torch.tools import gpu_profile, tpchgen

    cuda_build.build_all()
    label = args.label
    n = LINEITEM_SF1
    gen = torch.Generator(device="cuda").manual_seed(3)
    mask = torch.rand(n, device="cuda", generator=gen) < 0.5
    cases: list = []
    chip_smoke.check_sorted(torch, pg, n, mask, cases)
    chip_smoke.check_chunked(torch, pg, n, cases)
    del mask
    for c in cases:
        if "ms" in c:
            print(label, json.dumps({"case": f"{c['name']} {c['shape']}",
                                     **{k: c.get(k) for k in (
                                         "ms", "device_ms", "bound_ms",
                                         "floor_ms", "library_ms",
                                         "library_device_ms",
                                         "max_abs_err")}}), flush=True)

    s = ldb.create_in_memory()
    tpchgen.install(s, tpchgen.generate(args.sf, args.seed))
    with gpu_profile.eager_path():
        for q in args.queries.split(","):
            sql = open(os.path.join("queries", "tpch", f"{q}.sql")).read()
            s.sql(sql).format_rows()
            s.sql(sql).format_rows()
            walls = []
            for _ in range(args.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = s.sql(sql).format_rows()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            pg.reset_counters()
            s.sql(sql).format_rows()
            torch.cuda.synchronize()
            launches = dict(pg.LAUNCHES)
            prof = gpu_profile.profile_query(torch, s, sql)
            print(label, json.dumps({
                "query": f"q{q}", "rows": len(rows),
                "wall_median_ms": statistics.median(walls),
                "wall_min_ms": min(walls), "walls_ms": walls,
                "device_ms": prof["device_ms"],
                "device_kernels": prof["device_kernels"],
                "launch_calls": prof["launch_calls"],
                "engine_launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
