"""What a data-error code costs where no row raises: statements over TPC-H's
lineitem whose expressions can fail (INT arithmetic, a decimal cast to INT)
but stay in range, timed fused and eager, for the tree it is run from.

Run from the root of a checkout: the package imported is the one in the
current directory, so one copy of this file times two trees in one call, in
turns (parent, change, change, parent):

    python3 /path/to/error_cost.py LABEL [--sf 1] [--reps 7]

Per statement and path (the fused programs, or with them declined: the
eager operators, tools/gpu_profile.py's eager_path): the wall ms of --reps
runs after two (median and least); from tools/gpu_profile.py's
profile_query of one more run the device ms and the kernels the card ran,
and the host syncs (CUDA's sync debug mode); and the rows' digest, so two
trees' answers can be compared. One line a statement and path: LABEL, then a JSON object. Needs a
CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import sys
import time

# each stays in range on TPC-H's data (l_linenumber 1..7, l_partkey and
# l_suppkey below 2^31 / 8 up to SF 100, l_extendedprice below 10^6; the
# BIGINT product at SF 1). Where the columns' bounds prove an operator
# fits, the port builds no code for it (ops/bounds.py); the rest go through
# its checked kernel, one launch an operator (ops/checked.py)
STATEMENTS = {
    "int_mul_grouped": (
        "SELECT l_returnflag, sum(l_linenumber * 1000000000) FROM lineitem "
        "WHERE l_linenumber < 3 GROUP BY l_returnflag ORDER BY l_returnflag"),
    "int_arith_grouped": (
        "SELECT l_linestatus, sum(l_partkey * 2 + l_suppkey - l_linenumber) "
        "FROM lineitem GROUP BY l_linestatus ORDER BY l_linestatus"),
    "decimal_to_int_grouped": (
        "SELECT l_returnflag, sum(CAST(l_extendedprice AS INT)) FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "int_arith_filter": (
        "SELECT count(*) FROM lineitem WHERE l_partkey * 4 + l_linenumber "
        "> l_suppkey * 40"),
    # a BIGINT product the column's bounds cannot prove (l_partkey up to
    # 200,000 at SF 1) that the rows the filter keeps hold
    "bigint_mul_grouped": (
        "SELECT l_returnflag, max(CAST(l_partkey AS BIGINT) * 80000000000000) "
        "FROM lineitem WHERE l_partkey < 100000 GROUP BY l_returnflag "
        "ORDER BY l_returnflag"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("error_cost: FAILED: no CUDA device", file=sys.stderr)
        return 1
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.ops import cuda_build
    from lingodb_tpu_torch.tools import gpu_profile, tpchgen

    cuda_build.build_all()
    s = ldb.create_in_memory()
    tpchgen.install(s, tpchgen.generate(args.sf, args.seed))

    def run(sql):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = s.sql(sql).format_rows()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, rows

    for name, sql in STATEMENTS.items():
        for path in ("fused", "eager"):
            ctx = (gpu_profile.eager_path() if path == "eager"
                   else contextlib.nullcontext())
            with ctx:
                for _ in range(2):
                    run(sql)
                ms = [run(sql)[0] for _ in range(args.reps)]
                rows = run(sql)[1]
                prof = gpu_profile.profile_query(torch, s, sql)
            digest = hashlib.sha256(repr(rows).encode()).hexdigest()[:16]
            print(args.label, json.dumps({
                "statement": name, "path": path, "sf": args.sf,
                "median_ms": statistics.median(ms), "min_ms": min(ms),
                "syncs": prof["syncs"], "device_ms": prof["device_ms"],
                "device_kernels": prof["device_kernels"],
                "rows": digest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
