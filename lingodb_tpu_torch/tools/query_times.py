"""Wall time per TPC-H query on the card, over repeated runs.

    python3 -m lingodb_tpu_torch.tools.query_times --sf 1 --reps 15 \\
        --out out/query_times.json

Tables are generated once and uploaded by a first run of each query; then
each query runs `--reps` times, each run timed on the host's clock from
`Session.sql` to the formatted rows and ended by a synchronize. Reports the
median and the least time per query. To compare two trees on one card, run
the script by its path from the root of each tree in one session (it imports
the package of the directory it is started from). Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--queries", default="6,1,14,3,4")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("query_times: no CUDA device", file=sys.stderr)
        return 1
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import tpchgen

    s = ldb.create_in_memory()
    tpchgen.install(s, tpchgen.generate(args.sf, args.seed))
    report = {"device": torch.cuda.get_device_name(0), "sf": args.sf,
              "label": args.label, "package": os.path.dirname(ldb.__file__),
              "queries": {}}
    for q in args.queries.split(","):
        sql = open(os.path.join("queries", "tpch", f"{q}.sql")).read()
        s.sql(sql).format_rows()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            s.sql(sql).format_rows()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        report["queries"][q] = {"median_ms": statistics.median(times),
                                "min_ms": min(times), "ms": times}
        print(f"{args.label} q{q}: median {statistics.median(times):.2f} ms, "
              f"min {min(times):.2f} ms over {args.reps} runs", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
