"""q1 and q6 over the lineitem subset (tools/tpchbig.py), streamed by the
out-of-core aggregate and resident on the card, at one scale factor.

    python3 -m lingodb_tpu_torch.tools.outofcore_bench --sf 100 \\
        --budgets 10737418240,68719476736 --out out/outofcore.json

For each query and each system.device_byte_budget (the default 10 GiB makes
an SF100 table stream in 9 chunks of 2^26 rows; a budget above the table's
bytes keeps it resident, and the fused aggregate runs) it reports the chunk
layout (None when resident), the wall time of a first and a second run
(host clock around Session.sql + format_rows, ended by a synchronize; the
first resident run includes the upload), the bytes copied host -> device by
the stream, the share of those copies' time that lay under kernels
(tools/gpu_profile.py's trace of a third run), and the peak of allocated
device memory. The rows of every run of a query must be equal. A run that
runs out of device memory is reported as such. Needs a CUDA device; fails
without one. Prints the card's name and power limit and the host's memory
(free -g) first.

`--paths graphs,uncaptured` runs each streamed budget twice more, with the
chunk program replayed from its two graphs (one a staging slot) and run as
it is called (stream_runs): wall ms of a first and a second run, the
captures and replays of each, the host's launches of a third run and per
chunk, and the host's fill ms of the pinned buffers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time


def stream_runs(torch, session, sql, captured: bool,
                trace: bool = True) -> dict:
    """Two or three runs of `sql` streamed at the current budget, from a
    session that has captured nothing for it: the chunk program replayed
    from its graphs (`captured`) or run as it is called. The first run
    captures one graph a staging slot; the second is timed; with `trace`
    the host's launches are counted over a third (a replay counts one;
    torch.profiler's trace costs about 0.7 ms a launch)."""
    from lingodb_tpu_torch.tools import gpu_profile
    from lingodb_tpu_torch.utils import compilestats

    ctx = (contextlib.nullcontext() if captured
           else gpu_profile.uncaptured_path())
    out = {"path": "graphs" if captured else "uncaptured"}
    rows = []
    with ctx:
        for run in ("first", "second"):
            session.executor.last_chunked = None
            c0 = compilestats.snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows.append(session.sql(sql).format_rows())
            torch.cuda.synchronize()
            d = compilestats.delta(c0)
            out[f"wall_ms_{run}"] = (time.perf_counter() - t0) * 1e3
            out[f"captures_{run}"] = d["captures"]
            out[f"replays_{run}"] = d["replays"]
        plan = session.executor.last_chunked
        if plan is None:
            raise RuntimeError("the chunked aggregate did not engage")
        out["host_fill_ms"] = plan["host_fill_ms"]
        out["launches"] = None
        if trace:
            out["launches"] = gpu_profile.host_launches(
                torch, lambda: session.sql(sql).format_rows())
    out.update(chunks=plan["chunks"], chunk_rows=plan["chunk_rows"],
               launches_per_chunk=None if out["launches"] is None
               else out["launches"] / plan["chunks"],
               rows=rows[0], same=rows[0] == rows[1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--budgets", default=str(10 << 30),
                    help="comma-separated system.device_byte_budget values")
    ap.add_argument("--queries", default="1,6")
    ap.add_argument("--no-cache", action="store_true",
                    help="generate in memory instead of through .cache/")
    ap.add_argument("--out", default=None)
    ap.add_argument("--paths", default="",
                    help="graphs,uncaptured: also time each streamed budget "
                         "with the chunk program captured and uncaptured")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("outofcore_bench: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"# device: {smi}\n# host memory (free -g):\n{free}", flush=True)

    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import gpu_profile, tpchbig
    from lingodb_tpu_torch.utils import settings

    t0 = time.perf_counter()
    table = (tpchbig.generate(args.sf, args.seed) if args.no_cache
             else tpchbig.generate_cached(args.sf, args.seed))
    gen_s = time.perf_counter() - t0
    print(f"# lineitem subset sf={args.sf:g}: {table.num_rows} rows in "
          f"{gen_s:.1f}s", flush=True)
    s = ldb.create_in_memory()
    tpchbig.install(s, table)
    default_budget = settings.DEVICE_BYTE_BUDGET.get()
    runs = []
    try:
        for q in args.queries.split(","):
            sql = open(os.path.join("queries", "tpch", f"{q}.sql")).read()
            rows_seen = None
            for budget in (int(b) for b in args.budgets.split(",")):
                settings.DEVICE_BYTE_BUDGET.set(str(budget))
                s._evict_device_memory()
                s._device_cache.clear()
                rec = {"query": q, "budget": budget, "sf": args.sf,
                       "rows_in_table": table.num_rows}
                try:
                    walls = []
                    for _ in range(2):
                        s.executor.last_chunked = None
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        t0 = time.perf_counter()
                        rows = s.sql(sql).format_rows()
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
                    plan = s.executor.last_chunked
                    rec["wall_ms_first"], rec["wall_ms_second"] = walls
                    rec["chunked"] = plan is not None
                    if plan is not None:
                        rec.update({k: plan[k] for k in (
                            "width", "chunk_rows", "chunks", "bytes_copied")})
                        ov = gpu_profile.copy_overlap(
                            torch, lambda: s.sql(sql).format_rows())
                        rec["copy_ms_on_card"] = ov["copy_ms"]
                        rec["copy_hidden_share"] = ov["hidden_share"]
                        for path in filter(None, args.paths.split(",")):
                            s._evict_device_memory()
                            got = stream_runs(torch, s, sql,
                                              path == "graphs")
                            if got.pop("rows") != rows or not got["same"]:
                                print(f"outofcore_bench: q{q} rows differ on "
                                      f"the {path} path", file=sys.stderr)
                                return 1
                            rec[path] = got
                    if rows_seen is not None and rows != rows_seen:
                        print(f"outofcore_bench: q{q} rows differ between "
                              "budgets", file=sys.stderr)
                        return 1
                    rows_seen = rows
                    rec["rows"] = len(rows)
                except torch.cuda.OutOfMemoryError as e:
                    rec["error"] = f"out of device memory: {str(e)[:200]}"
                runs.append(rec)
                print(json.dumps(rec), flush=True)
    finally:
        settings.DEVICE_BYTE_BUDGET.set(str(default_budget))
    out = {"device": smi, "host_free_g": free, "generate_s": gen_s,
           "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"ok": True, "runs": len(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
