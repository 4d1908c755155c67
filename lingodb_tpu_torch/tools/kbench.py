"""Correctness and timing of the four hand-written CUDA kernels on the card,
case by case, at stream sizes beyond one query's (the port's counterpart of
the JAX package's kernel bench, benchtools/tools_kbench2.py).

    python3 -m lingodb_tpu_torch.tools.kbench [--quick]

N = 60,000,000 rows (6,000,000 with --quick). Cases:

  k1_chunked_S1024, _S8192  gather_chunked_i32: random idx into a small table
  k1_chunked_q3, _S16384_n1000
                            gather_chunked_planes with few rows against the
                            table (q3's 10 rows of an 11,268-entry table, 6
                            planes): the direct form
  k1_chunked_wide_bool      an int64 and a bool plane of an 8,192-entry
                            table in one launch
  k3_compact_p0.01, _p0.5   compact_positions: random mask, capacity 1.5x
  k3_compact_q14, _q3_lead, _q3_boundary, _q4
                            compact_positions at the shapes the fused
                            queries pass at TPC-H SF1 (mask length,
                            capacity and count; the same in both modes)
  k2_sorted_dense           gather_sorted_i32: monotone idx, steps of 0 or 1
  k2_sorted_sparse1pct      gather_sorted_i32: 1 % of the rows, sorted
  k2_sorted_sparse_q6       gather_sorted_planes, 7 int32 planes at 1.92 % of
                            the rows (q6's survivors of lineitem), with the
                            sector floor beside the bound and index_select
                            of the stacked (7, N) table as the yardstick
  k2_sorted_wide_bool       an int64 and a bool plane at dense monotone idx
  k4_segscan_w2             segscan_i32: runs of 4, two planes
  k4_segscan_w8             the same with eight planes (one launch)
  k4_segscan_onerun         two planes, one run over the whole array (the
                            worst case: every tile's carry comes through
                            the look-back)
  torch_index_sorted        plain torch indexing of the dense case (baseline)
  torch_cumsum_*, torch_cummax_*
                            the fused grouping's prefix sum and running max
                            over N int64: one flat torch call against the
                            blocked form (1,024-wide rows, then the row
                            totals); runtime/fused.py keeps the faster of
                            the two for each

Each kernel case is checked bit for bit against the wrapper's plain PyTorch
version on the same inputs. Per case it prints the check, ms per call by CUDA
events around 10 calls ("call", host launch cost included), the kernels' own
time per call from torch.profiler ("card"), the plain version's call time
("plain") and the bytes bound: each input read once and each output written
once, over the H100 SXM data-sheet rate of 3.35 TB/s; where indices are
sparse also the sector floor (each 32-byte sector that holds a requested
entry read whole), and where one PyTorch call computes the same function its
call and card time ("library"). The last line is one JSON object with every
case. Any failed check exits non-zero. Needs a CUDA
device: without one it fails and never runs on the CPU."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12


def call_ms(torch, fn, reps: int = 10) -> float:
    """Mean time of fn() in ms over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_ms(torch, fn, reps: int = 5) -> float:
    """Mean time per fn() that the card spent in kernels and copies
    (torch.profiler, device rows only): unlike call_ms it leaves out the gaps
    in which the card waits for the host to launch."""
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


def blocked_cumsum(v, width: int = 1024):
    """Inclusive prefix sum of 1-D v in the reference's hierarchical form
    (sums within `width`-wide rows, the row totals scanned recursively),
    timed here against the flat torch.cumsum that runtime/fused.py keeps."""
    import torch

    n = v.shape[0]
    if n <= 4 * width:
        return torch.cumsum(v, 0, dtype=v.dtype)
    pad = (-n) % width
    if pad:
        v = torch.cat([v, v.new_zeros((pad,))])
    within = torch.cumsum(v.view(-1, width), 1, dtype=v.dtype)
    tot = blocked_cumsum(within[:, -1].contiguous(), width)
    offs = torch.cat([tot.new_zeros((1,)), tot[:-1]])
    return (within + offs[:, None]).reshape(-1)[:n]


def sector_count(torch, idx, width: int) -> int:
    """32-byte sectors of a plane of `width`-byte elements (32-byte aligned)
    that hold an entry idx requests: idx sorted."""
    return int(torch.unique_consecutive(idx.to(torch.int64) * width // 32)
               .numel())


def _equal(torch, got, want) -> bool:
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="N = 6,000,000 instead of 60,000,000")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kbench: FAILED: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import pgather as pg

    pg.reset_counters()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    n = 6_000_000 if args.quick else 60_000_000
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"# kbench: {smi.stdout.strip() or torch.cuda.get_device_name(0)} "
          f"N={n}", flush=True)
    cases = []

    def rep(name, ok, fn, nbytes, rows, plain=None, floor_bytes=None,
            library=None):
        ms = call_ms(torch, fn)
        card = card_ms(torch, fn)
        plain_ms = None if plain is None else call_ms(torch, plain, 3)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        case = {"name": name, "correct": bool(ok), "rows": rows, "ms": ms,
                "card_ms": card, "plain_ms": plain_ms, "bound_ms": bound,
                "bytes": nbytes}
        extra = ""
        if plain is not None:
            extra += f" plain={plain_ms:.4f}ms"
        if floor_bytes is not None:
            case["floor_ms"] = floor_bytes / HBM_BYTES_PER_S * 1e3
            extra += (f" floor={case['floor_ms']:.4f}ms "
                      f"card/floor={card / case['floor_ms']:.2f}")
        if library is not None:
            case["library_ms"] = call_ms(torch, library)
            case["library_card_ms"] = card_ms(torch, library)
            extra += (f" library={case['library_ms']:.4f}ms "
                      f"(card {case['library_card_ms']:.4f}ms)")
        cases.append(case)
        print(f"{name}: call={ms:.4f}ms card={card:.4f}ms{extra} "
              f"bound={bound:.4f}ms card/bound={card / max(bound, 1e-9):.2f} "
              f"rate={rows / ms / 1e6:.2f}Ge/s correct={bool(ok)}", flush=True)

    def rand_i32(lo, hi, size):
        return torch.randint(lo, hi, (size,), device=dev, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    # K1 gather_chunked
    for s in (1024, 8192):
        table = rand_i32(0, 1 << 30, s)
        idx = rand_i32(0, s, n)
        ok = _equal(torch, [pg.gather_chunked_i32(table, idx)],
                    pg.gather_chunked_planes_plain([table], idx))
        rep(f"k1_chunked_S{s}", ok, lambda t=table, i=idx: pg.gather_chunked_i32(t, i),
            4 * n + 4 * n + 4 * s, n,
            lambda t=table, i=idx: pg.gather_chunked_planes_plain([t], i))
        del idx
    # few rows against the table: q3's shape, and 1,000 rows of 16,384
    for name, s, c, rows in (("k1_chunked_q3", 11_268, 6, 10),
                             ("k1_chunked_S16384_n1000", 16_384, 1, 1000)):
        planes = [rand_i32(-(1 << 31), (1 << 31) - 1, s) for _ in range(c)]
        idx = rand_i32(0, s, rows)
        ok = _equal(torch, pg.gather_chunked_planes(planes, idx),
                    pg.gather_chunked_planes_plain(planes, idx))
        stacked, idx64 = torch.stack(planes), idx.to(torch.int64)
        rep(name, ok, lambda p=planes, i=idx: pg.gather_chunked_planes(p, i),
            4 * rows + 4 * c * rows + 4 * c * s, rows,
            lambda p=planes, i=idx: pg.gather_chunked_planes_plain(p, i),
            library=lambda t=stacked, i=idx64: torch.index_select(t, 1, i))
    # an int64 and a bool plane in one launch
    wide = [torch.randint(-(1 << 62), 1 << 62, (8192,), device=dev,
                          generator=gen),
            torch.rand(8192, device=dev, generator=gen) < 0.5]
    idx = rand_i32(0, 8192, n)
    ok = _equal(torch, pg.gather_chunked_planes(wide, idx),
                pg.gather_chunked_planes_plain(wide, idx))
    rep("k1_chunked_wide_bool", ok, lambda: pg.gather_chunked_planes(wide, idx),
        4 * n + 9 * n + 9 * 8192, n,
        lambda: pg.gather_chunked_planes_plain(wide, idx))
    del idx, wide

    # K3 compact_positions
    u = torch.rand(n, device=dev, generator=gen)
    for p in (0.01, 0.5):
        mask = u < p
        k = int(n * p * 1.5) + 8192
        cnt, pos = pg.compact_positions(mask, k)
        pcnt, ppos = pg.compact_positions_plain(mask, k)
        ok = int(cnt) == int(pcnt) and torch.equal(pos, ppos)
        rep(f"k3_compact_p{p}", ok, lambda m=mask, kk=k: pg.compact_positions(m, kk),
            n + 4 * k + 4, n,
            lambda m=mask, kk=k: pg.compact_positions_plain(m, kk))
    # the fused queries' compactions at SF1: (mask rows, k, set rows)
    for name, rows, k, cnt in (("q14", 5_997_593, 262_144, 75_029),
                               ("q3_lead", 5_997_593, 65_536, 29_754),
                               ("q3_boundary", 65_536, 65_536, 11_268),
                               ("q4", 1_500_000, 196_608, 57_371)):
        mask = torch.zeros(rows, dtype=torch.bool, device=dev)
        mask[torch.randperm(rows, device=dev, generator=gen)[:cnt]] = True
        cnt_k, pos = pg.compact_positions(mask, k)
        pcnt, ppos = pg.compact_positions_plain(mask, k)
        ok = int(cnt_k) == int(pcnt) == cnt and torch.equal(pos, ppos)
        rep(f"k3_compact_{name}", ok, lambda m=mask, kk=k: pg.compact_positions(m, kk),
            rows + 4 * k + 4, rows,
            lambda m=mask, kk=k: pg.compact_positions_plain(m, kk))
    del u, mask

    # K2 gather_sorted: dense monotone (FK probe shape), table as long as
    # the stream
    table = rand_i32(0, 1 << 30, n)
    steps = torch.randint(0, 2, (n,), device=dev, generator=gen)
    idx = torch.cumsum(steps, 0).clamp(max=n - 1).to(torch.int32)
    del steps
    distinct = int(torch.unique_consecutive(idx).numel())
    ok = _equal(torch, [pg.gather_sorted_i32(table, idx)],
                pg.gather_sorted_planes_plain([table], idx))
    rep("k2_sorted_dense", ok, lambda: pg.gather_sorted_i32(table, idx),
        4 * n + 4 * n + 4 * distinct, n,
        lambda: pg.gather_sorted_planes_plain([table], idx))

    # K2 sparse monotone: post-filter positions at 1 % selectivity
    nsel = n // 100
    sel = torch.sort(torch.randperm(n, device=dev, generator=gen)[:nsel]).values
    sel = sel.to(torch.int32)
    ok = _equal(torch, [pg.gather_sorted_i32(table, sel)],
                pg.gather_sorted_planes_plain([table], sel))
    rep("k2_sorted_sparse1pct", ok, lambda: pg.gather_sorted_i32(table, sel),
        4 * nsel * 3, nsel, lambda: pg.gather_sorted_planes_plain([table], sel),
        floor_bytes=8 * nsel + 32 * sector_count(torch, sel, 4))

    # q6's survivors: 7 planes at 1.92 % of the rows, sorted
    nq6 = n * 115_405 // 5_997_593
    sel = torch.sort(torch.randperm(n, device=dev, generator=gen)[:nq6]).values
    sel = sel.to(torch.int32)
    planes = [table] + [rand_i32(-(1 << 31), (1 << 31) - 1, n)
                        for _ in range(6)]
    ok = _equal(torch, pg.gather_sorted_planes(planes, sel),
                pg.gather_sorted_planes_plain(planes, sel))
    stacked, sel64 = torch.stack(planes), sel.to(torch.int64)
    rep("k2_sorted_sparse_q6", ok, lambda: pg.gather_sorted_planes(planes, sel),
        4 * nq6 + 2 * 7 * 4 * nq6, nq6,
        lambda: pg.gather_sorted_planes_plain(planes, sel),
        floor_bytes=4 * nq6 + 7 * (4 * nq6 + 32 * sector_count(torch, sel, 4)),
        library=lambda: torch.index_select(stacked, 1, sel64))
    del planes, stacked, sel64

    # an int64 and a bool plane at the dense monotone indices
    wide = [torch.randint(-(1 << 62), 1 << 62, (n,), device=dev, generator=gen),
            torch.rand(n, device=dev, generator=gen) < 0.5]
    ok = _equal(torch, pg.gather_sorted_planes(wide, idx),
                pg.gather_sorted_planes_plain(wide, idx))
    rep("k2_sorted_wide_bool", ok, lambda: pg.gather_sorted_planes(wide, idx),
        4 * n + 9 * n + 9 * distinct, n,
        lambda: pg.gather_sorted_planes_plain(wide, idx))
    del wide

    # K4 segscan: runs of 4, two planes
    gid = (torch.arange(n, device=dev, dtype=torch.int32) // 4)
    v1 = rand_i32(-1000, 1000, n)
    ones = torch.ones(n, device=dev, dtype=torch.int32)
    ok = _equal(torch, pg.segscan_i32(gid, [v1, ones]),
                pg.segscan_i32_plain(gid, [v1, ones]))
    rep("k4_segscan_w2", ok, lambda: pg.segscan_i32(gid, [v1, ones]),
        4 * n + 2 * 4 * n * 2, n, lambda: pg.segscan_i32_plain(gid, [v1, ones]))
    planes = [v1, ones] + [rand_i32(-(1 << 31), (1 << 31) - 1, n) for _ in range(6)]
    ok = _equal(torch, pg.segscan_i32(gid, planes), pg.segscan_i32_plain(gid, planes))
    rep("k4_segscan_w8", ok, lambda: pg.segscan_i32(gid, planes),
        4 * n + 2 * 4 * n * 8, n, lambda: pg.segscan_i32_plain(gid, planes))
    one_run = torch.zeros(n, device=dev, dtype=torch.int32)
    ok = _equal(torch, pg.segscan_i32(one_run, [v1, ones]),
                pg.segscan_i32_plain(one_run, [v1, ones]))
    rep("k4_segscan_onerun", ok, lambda: pg.segscan_i32(one_run, [v1, ones]),
        4 * n + 2 * 4 * n * 2, n,
        lambda: pg.segscan_i32_plain(one_run, [v1, ones]))
    del gid, v1, ones, planes, one_run

    # baseline: plain torch indexing of the dense monotone case
    idx64 = idx.to(torch.int64)
    rep("torch_index_sorted", True, lambda: table[idx64], 8 * n + 4 * n + 4 * distinct, n)

    # the fused grouping's scans over n int64 (its packed running maximum
    # and its prefix sums), flat against blocked
    from ..runtime import fused

    vals = torch.randint(-(1 << 40), 1 << 40, (n,), device=dev, generator=gen)
    forms = {"sum": (lambda: torch.cumsum(vals, 0), lambda: blocked_cumsum(vals)),
             "max": (lambda: torch.cummax(vals, 0).values,
                     lambda: fused.cummax1d(vals))}
    for op, (flat, blocked) in forms.items():
        ok = torch.equal(flat(), blocked())
        rep(f"torch_cum{op}_flat", ok, flat, 16 * n, n)
        rep(f"torch_cum{op}_blocked", ok, blocked, 16 * n, n)

    print(json.dumps({"device": torch.cuda.get_device_name(0), "n": n,
                      "cases": cases, "launches": dict(pg.LAUNCHES)}),
          flush=True)
    bad = [c["name"] for c in cases if not c["correct"]]
    if bad:
        print(f"kbench: FAILED: {bad} differ from their plain versions",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
