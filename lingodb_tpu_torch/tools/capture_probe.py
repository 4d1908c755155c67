"""Whether statements run as captured CUDA graphs on the card, run by run.

    python3 lingodb_tpu_torch/tools/capture_probe.py --sf 1 --label change \\
        --out chiprun_out/capture_probe_change.json

Generates TPC-H at `--sf`, then runs each statement `--runs` times on the
card. For each run it records whether it raised (and what), its wall time on
the host's clock (from Session.sql to the rows, ended by a synchronize), the
counters of utils/compilestats.py it moved (captures, replays, calibration
runs), and whether the plan's fused programs were marked to run eagerly.
Then one more run under torch's sync debug mode counts its host syncs, and
one under runtime/exestore.py's switch off (the programs run uncaptured)
gives the same counts for comparison. The default statements call round
with digits inside the fused aggregate and its TopK epilogue.

To compare two trees on one card, start the script by its path from the
root of each tree in one call: it imports the package of the directory it
is started from. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STATEMENTS = {
    "round_grouped": "SELECT l_returnflag, sum(round(l_extendedprice, 1)) "
                     "FROM lineitem GROUP BY l_returnflag",
    "round_filtered": "SELECT sum(round(l_extendedprice, 2)) FROM lineitem "
                      "WHERE l_orderkey > 10",
    "round_topk": "SELECT l_partkey, round(sum(l_extendedprice), 1) AS r "
                  "FROM lineitem GROUP BY l_partkey ORDER BY l_partkey "
                  "LIMIT 3",
}


def _run(torch, s, sql):
    from lingodb_tpu_torch.utils import compilestats

    cs0 = compilestats.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rows = s.sql(sql).to_pylist()
        err = None
    except Exception as exc:  # what the statement does is the reading
        rows, err = None, f"{type(exc).__name__}: {str(exc)[:300]}"
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    d = compilestats.delta(cs0)
    eager = sorted(str(k[0]) for k, v in s.stage_cache.items()
                   if v == "eager" and isinstance(k, tuple))
    return {"ms": ms, "error": err, "captures": d.get("captures", 0),
            "replays": d.get("replays", 0),
            "calibrations": d.get("calibrations", 0),
            "marked_eager": eager}, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--only", default="", help="comma-separated names")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("capture_probe: no CUDA device", file=sys.stderr)
        return 1
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import gpu_profile, tpchgen

    s = ldb.create_in_memory()
    tpchgen.install(s, tpchgen.generate(args.sf, args.seed))
    names = args.only.split(",") if args.only else list(STATEMENTS)
    report = {"device": torch.cuda.get_device_name(0), "sf": args.sf,
              "label": args.label, "package": os.path.dirname(ldb.__file__),
              "statements": {}}
    for name in names:
        sql = STATEMENTS[name]
        runs, rows = [], []
        for _ in range(args.runs):
            r, got = _run(torch, s, sql)
            runs.append(r)
            rows.append(got)
        out = {"sql": sql, "runs": runs,
               "rows_equal_across_runs": all(r == rows[0] for r in rows),
               "rows": rows[-1][:5] if rows[-1] is not None else None}
        try:
            out["syncs"] = gpu_profile.syncs_and_peak(
                torch, lambda: s.sql(sql).to_pylist())[0]
        except Exception as exc:
            out["syncs"] = f"{type(exc).__name__}: {str(exc)[:200]}"
        with gpu_profile.uncaptured_path():
            r, got = _run(torch, s, sql)
            r["rows_equal_captured"] = got == rows[-1]
            try:
                r["syncs"] = gpu_profile.syncs_and_peak(
                    torch, lambda: s.sql(sql).to_pylist())[0]
            except Exception as exc:
                r["syncs"] = f"{type(exc).__name__}: {str(exc)[:200]}"
            out["uncaptured"] = r
        report["statements"][name] = out
        print(f"{args.label} {name}: "
              + "; ".join(f"run {i + 1}: {r['ms']:.2f} ms captures "
                          f"{r['captures']} replays {r['replays']} "
                          f"calibrations {r['calibrations']} "
                          f"eager {r['marked_eager']} error {r['error']}"
                          for i, r in enumerate(runs))
              + f"; syncs {out['syncs']}; uncaptured {out['uncaptured']}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
