"""Where the gather/compaction kernels stand against plain PyTorch indexing
at small sizes and sparse index sets, and what shapes the TPC-H queries hand
to each kernel.

    python3 -m lingodb_tpu_torch.tools.threshold_bench --sf 1 \\
        --out out/threshold_bench.json

Three sweeps over a table of `--rows` rows (one int64 and one int32 column,
as a filtered scan fetches them), each timing the dispatcher's kernel route
against the plain route for the same inputs:

  size    n sorted indices, n from 1K to 4M          (take_fast_multi)
          a mask of n rows, half of them set         (nonzero_positions)
  gap     rows / n from 2 to 65536, sorted indices   (take_fast_multi)
  random  n unsorted indices through the direct-read gather kernel against
          plain indexing                             (gather_sorted_planes)
  route   the reference's sort route (lingodb_tpu/ops/pgather.py:801-816)
          against plain indexing one plane at a time, at the engine's
          shapes: n unsorted indices from 1M to 60M into a table of
          s = 1.5M or 15M rows (orders at SF1 and SF10), 1, 2 and 8 int32
          planes sharing the indices                 (sort_route)

A time is the host's clock around 50 calls ended by a synchronize, divided by
50 ("call": what a query pays, host launch cost included), and the device's
own time per call from torch.profiler ("card"); the route's sweep runs only
with `--only route` (about a minute), alone, and takes fewer calls at its
larger shapes (`reps`). Otherwise, with --sf > 0, the five
smoke queries run once over generated TPC-H tables and every kernel wrapper
call is listed with its shape. Needs a CUDA device; fails without one."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

QUERIES = ["6", "1", "14", "3", "4"]


ROUTE_N = (1 << 20, 1 << 22, 1 << 24, 60_000_000)
ROUTE_S = (1_500_000, 15_000_000)
ROUTE_PLANES = (1, 2, 8)


def call_ms(torch, fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def card_ms(torch, fn, reps: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return us / 1e3 / reps


def plain_take(torch, tables, idx):
    j = idx.to(torch.int64).clamp(0, tables[0].shape[0] - 1)
    return [t[j] for t in tables]


def both(torch, kernel_fn, plain_fn) -> dict:
    return {"kernel_call_ms": call_ms(torch, kernel_fn),
            "plain_call_ms": call_ms(torch, plain_fn),
            "kernel_card_ms": card_ms(torch, kernel_fn),
            "plain_card_ms": card_ms(torch, plain_fn)}


def sweeps(torch, pg, rows: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(11)
    wide = torch.randint(-(1 << 62), 1 << 62, (rows,), device="cuda", generator=gen)
    narrow = torch.randint(0, 1 << 30, (rows,), device="cuda", generator=gen).to(torch.int32)
    tables = [wide, narrow]
    out = {"rows": rows, "size_gather": [], "size_compact": [], "gap": [],
           "random": []}

    def sorted_idx(n):
        r = torch.randint(0, rows, (n,), device="cuda", generator=gen)
        return r.sort().values.to(torch.int32)

    for n in (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22):
        idx = sorted_idx(n)
        got = pg.take_fast_multi(tables, idx, monotone=True)
        want = plain_take(torch, tables, idx)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"take_fast_multi differs from plain at n={n}")
        r = both(torch, lambda: pg.take_fast_multi(tables, idx, monotone=True),
                 lambda: plain_take(torch, tables, idx))
        out["size_gather"].append({"n": n, **r})
        mask = torch.rand(n, device="cuda", generator=gen) < 0.5
        k = int(mask.sum())
        cnt, pos = pg.nonzero_positions(mask, k)
        cnt_p, pos_p = pg.compact_positions_plain(mask, k)
        if int(cnt) != int(cnt_p) or not torch.equal(pos, pos_p):
            raise SystemExit(f"nonzero_positions differs from plain at n={n}")
        r = both(torch, lambda: pg.nonzero_positions(mask, k),
                 lambda: pg.compact_positions_plain(mask, k))
        out["size_compact"].append({"n": n, "k": k, **r})
    for gap in (2, 16, 128, 1024, 8192, 65536):
        idx = sorted_idx(max(rows // gap, 1))
        r = both(torch, lambda: pg.take_fast_multi(tables, idx, monotone=True),
                 lambda: plain_take(torch, tables, idx))
        out["gap"].append({"gap": gap, "n": int(idx.numel()), **r})
    for n in (1 << 12, 1 << 16, 1 << 20, 1 << 22):
        idx = torch.randint(0, rows, (n,), device="cuda", generator=gen).to(torch.int32)
        r = both(torch, lambda: pg.gather_sorted_planes(tables, idx),
                 lambda: plain_take(torch, tables, idx))
        out["random"].append({"n": n, **r})
    return out


def sort_route(torch, pg, tables, idx):
    """[t[clip(idx)] for t in tables] for any 1-D int32 idx through the
    sorted gather: one stable sort of the indices with their positions,
    gather_sorted_planes (K2) of every group of up to 8 planes (each of its
    own dtype) at the sorted indices, and one unsort (each gathered plane
    scattered back by the positions): the reference's sort route, timed here
    against plain indexing. The engine does not take it
    (ops/pgather.py::_planes_gather says why)."""
    n = int(idx.shape[0])
    sidx, perm = torch.sort(idx, stable=True)
    outs = [torch.empty((n,), dtype=t.dtype, device=idx.device)
            for t in tables]
    for g0 in range(0, len(tables), 8):
        got = pg.gather_sorted_planes(tables[g0:g0 + 8], sidx)
        for o, v in zip(outs[g0:g0 + 8], got):
            o.index_copy_(0, perm, v)
    return outs


def route_sweep(torch, pg) -> list:
    """The sort route (one sort, K2 at the sorted indices, one unsort)
    against plain indexing of each plane, at every (n, s, planes) of
    ROUTE_N x ROUTE_S x ROUTE_PLANES; each pair first checked bit-equal
    on indices with duplicates and out-of-bounds entries."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = []
    for s in ROUTE_S:
        table = torch.randint(-(1 << 31), (1 << 31) - 1, (max(ROUTE_PLANES), s),
                              device="cuda", generator=gen, dtype=torch.int32)
        for n in ROUTE_N:
            idx = torch.randint(-8, s + 8, (n,), device="cuda",
                                generator=gen).to(torch.int32)
            for c in ROUTE_PLANES:
                planes = [table[i] for i in range(c)]
                got = sort_route(torch, pg, planes, idx)
                want = plain_take(torch, planes, idx)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"sort route differs from plain at "
                                     f"n={n} s={s} planes={c}")
                del got, want
                reps = max(3, min(50, (1 << 28) // (n * c)))
                r = {"n": n, "s": s, "planes": c, "reps": reps,
                     "route_call_ms": call_ms(
                         torch, lambda: sort_route(torch, pg, planes, idx),
                         reps),
                     "plain_call_ms": call_ms(
                         torch, lambda: plain_take(torch, planes, idx), reps),
                     "route_card_ms": card_ms(
                         torch, lambda: sort_route(torch, pg, planes, idx), 3),
                     "plain_card_ms": card_ms(
                         torch, lambda: plain_take(torch, planes, idx), 3)}
                out.append(r)
                print(f"route n={n} s={s} planes={c}: call route "
                      f"{r['route_call_ms']:.4f} plain {r['plain_call_ms']:.4f}"
                      f" ms; card route {r['route_card_ms']:.4f} plain "
                      f"{r['plain_card_ms']:.4f} ms", flush=True)
            del idx
        del table
    return out


def query_shapes(torch, pg, sf: float, seed: int) -> dict:
    """Every kernel wrapper call of the five smoke queries, with its shape."""
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import tpchgen

    s = ldb.create_in_memory()
    tpchgen.install(s, tpchgen.generate(sf, seed))
    calls: list = []
    orig = {n: getattr(pg, n) for n in
            ("compact_positions", "gather_sorted_planes", "gather_chunked_planes")}

    def spy(name):
        def wrapped(a, b, *rest, **kw):
            if name == "compact_positions":
                calls.append({"kernel": name, "n": int(a.shape[0]), "k": int(b)})
            else:
                calls.append({"kernel": name, "C": len(a), "s": int(a[0].shape[0]),
                              "n": int(b.numel())})
            return orig[name](a, b, *rest, **kw)
        return wrapped

    out = {}
    for q in QUERIES:
        sql = open(os.path.join("queries", "tpch", f"{q}.sql")).read()
        s.sql(sql).format_rows()  # first run uploads the columns
        for name in orig:
            setattr(pg, name, spy(name))
        try:
            del calls[:]
            s.sql(sql).format_rows()
            out[q] = list(calls)
        finally:
            for name, fn in orig.items():
                setattr(pg, name, fn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=6_000_000)
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor for the shape listing; 0 skips it")
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--out", default="")
    ap.add_argument("--only", choices=["route"], default=None,
                    help="run one sweep alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("threshold_bench: no CUDA device", file=sys.stderr)
        return 1
    from lingodb_tpu_torch.ops import cuda_build
    from lingodb_tpu_torch.ops import pgather as pg

    cuda_build.build_all()
    report = {"device": torch.cuda.get_device_name(0)}
    if args.only == "route":
        report["route"] = route_sweep(torch, pg)
        args.sf = 0
    else:
        report.update(sweeps(torch, pg, args.rows))
    for key in ("size_gather", "size_compact", "gap", "random"):
        if key not in report:
            continue
        for r in report[key]:
            head = " ".join(f"{k}={v}" for k, v in r.items() if not k.endswith("_ms"))
            print(f"{key} {head}: call kernel {r['kernel_call_ms']:.4f} plain "
                  f"{r['plain_call_ms']:.4f} ms; card kernel "
                  f"{r['kernel_card_ms']:.4f} plain {r['plain_card_ms']:.4f} ms",
                  flush=True)
    if args.sf > 0:
        report["query_shapes"] = query_shapes(torch, pg, args.sf, args.seed)
        for q, calls in report["query_shapes"].items():
            for c in calls:
                print(f"q{q} {json.dumps(c)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
