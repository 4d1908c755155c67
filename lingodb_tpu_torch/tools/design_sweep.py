"""The measurements behind five kernels' design constants, and a breakdown
of the cases where each reads furthest from its bound, on the card.

    python3 -m lingodb_tpu_torch.tools.design_sweep
    python3 -m lingodb_tpu_torch.tools.design_sweep --only gather_shift
    python3 -m lingodb_tpu_torch.tools.design_sweep --only gathers
    python3 -m lingodb_tpu_torch.tools.design_sweep --counters   # only those

A variant is the kept source with one constant rewritten, compiled by nvcc
into build/kernels/sweep/ and bound in place of the kept library for its
cases; the kept sources are not changed. The kept build runs first and
again last, so that drift over the run shows. Variants:

  compact_positions (csrc/compact_positions.cu): tiles of 4, 8 or 16 KB at
      every mask length (kMidRows, kWideRows), against the kept rule (4 KB
      below 2^20 rows, 8 KB below 2^22, 16 KB from there)
  sublane_gather (csrc/tile_gather.cu): a 128 KB shared-memory budget
      (kMaxSmem) against the kept 227 KB, and no partial band
      (kPartialRows = 0: tables taller than a band of 8 columns holds take
      the direct form)
  gather_shift (csrc/table_gather.cu): the L2 form for every table
      (kStagedMaxEntries = 0: the first design); the staged form up to 16
      blocks' worth of entries (kStagedMaxEntries); staging by 16-byte
      loads (kStageBulk) against the kept bulk copies. At S = 2^16 and
      2^21, n = 6M and 60M, at 6M on each side of each edge (the whole
      table held, the staged form's last table), and over the range of
      tables held in part at 6M and 60M
  gathers, the engine's K1 and K2 (csrc/gather_planes.cuh, shared by
      csrc/gather_sorted.cu and csrc/gather_chunked.cu): K2 with quads of
      rows in the one-plane kernel (kStridedOne = false: the first
      design), 4 rows strided by the block in the all-planes kernel too
      (kStridedAll), a thread for all planes at every grid
      (kSplitBlocksPerSM = 0; with strided rows too) and a block a plane
      at every grid; K1 with blocks of 512 threads against the kept 1024
      (kStagedThreads), quads in its direct form, the direct form only for
      few rows (kDirectTableBytes = 0), at every shape and at none
      (kDirectRowBytes). At chip_smoke.py phase 3's shapes (TPC-H SF1) and
      K1's few rows against its table, with index_select of the stacked
      planes beside them (int32 planes)

Breakdowns, with the kept kernels: compact_positions with k = 0 (the mask
read, counted, scanned and looked back over, no position written) beside
k = count and beside torch.count_nonzero of the same mask (one read of it);
sublane_gather at R = 16,384 beside the two forms it mixes, the band of 8
columns at R = 7,264 (every lookup from shared memory) and the direct form
at R = 16,384 (every lookup an L2 sector); gather_shift's staging alone,
the staged form at n = 4,096 beside the L2 form there. Hardware counters (DRAM bytes and
L2 sectors a kernel) are asked of CUPTI through torch.profiler, where the
machine allows it; otherwise the line says so.

Each case is checked bit for bit against the plain version. Per case: card
ms by torch.profiler, call ms by CUDA events, the bytes bound over 3.35
TB/s. The last line is one JSON object with every case. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

from .kbench import HBM_BYTES_PER_S, call_ms, card_ms

# (library, variant) -> {constant: value}; "kept" is the source as it is
VARIANTS = {
    ("compact_positions", "tile4k"): {"kMidRows": "INT64_MAX",
                                      "kWideRows": "INT64_MAX"},
    ("compact_positions", "tile8k"): {"kMidRows": "0",
                                      "kWideRows": "INT64_MAX"},
    ("compact_positions", "tile16k"): {"kMidRows": "0", "kWideRows": "0"},
    ("tile_gather", "smem128k"): {"kMaxSmem": "131072"},
    ("tile_gather", "no_partial"): {"kPartialRows": "0"},
    ("table_gather", "l2"): {"kStagedMaxEntries": "0"},
    ("table_gather", "partial_wide"): {"kStagedMaxEntries": "16 * kPartMax"},
    ("table_gather", "stage_loads"): {"kStageBulk": "false"},
    ("gather_sorted", "quad_one"): {"kStridedOne": "false"},
    ("gather_sorted", "strided_all"): {"kStridedAll": "true"},
    ("gather_sorted", "no_split"): {"kSplitBlocksPerSM": "0"},
    ("gather_sorted", "no_split_strided"): {"kSplitBlocksPerSM": "0",
                                            "kStridedAll": "true"},
    ("gather_sorted", "all_split"): {"kSplitBlocksPerSM": "1 << 20"},
    ("gather_chunked", "threads512"): {"kStagedThreads": "512"},
    ("gather_chunked", "quad_one"): {"kStridedOne": "false"},
    ("gather_chunked", "no_l1_rule"): {"kDirectTableBytes": "0"},
    ("gather_chunked", "all_direct"): {"kDirectRowBytes": "0"},
    ("gather_chunked", "no_direct"): {"kDirectRowBytes": "1 << 20",
                                      "kDirectTableBytes": "0"},
}
SECTIONS = ("compact_positions", "sublane_gather", "gather_shift", "gathers",
            "counters")
METRICS = ("dram__bytes_read.sum", "dram__bytes_write.sum",
           "lts__t_sectors_op_read.sum")


def variant_source(text: str, consts: dict) -> str:
    """`text` with each `constexpr <type> <name> = ...;` given a new value."""
    for name, value in consts.items():
        text, hits = re.subn(rf"(constexpr \w+ {name} = )[^;]*;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise ValueError(f"design_sweep: no single constant {name}")
    return text


def kernel_source(name: str) -> str:
    """csrc/<name>.cu with the shared headers it includes inlined, so that
    a variant can rewrite their constants too."""
    from ..ops import cuda_build

    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    for head in sorted(cuda_build.CSRC.glob("*.cuh")):
        text = text.replace(f'#include "{head.name}"', head.read_text()
                            .replace("#pragma once", ""))
    return text


def build_variants(libraries) -> dict:
    """Compile every variant of the named libraries, all nvcc processes at
    once; returns (library, variant) -> CDLL."""
    from ..ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for (name, variant), consts in VARIANTS.items():
        if name not in libraries:
            continue
        src = out_dir / f"{name}_{variant}.cu"
        src.write_text(variant_source(kernel_source(name), consts))
        lib = out_dir / f"lib{name}_{variant}.so"
        procs.append(((name, variant), lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise cuda_build.KernelBuildError(f"{key}: {log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


_kept: dict = {}  # the kept libraries, as first built


def use(name: str, lib) -> None:
    """Bind `lib` (None: the kept build) as kernel library `name`."""
    from ..ops import cuda_build
    from ..ops import pgather

    pgather._KERNEL_FN.clear()  # the gathers' entry points, bound anew
    if not _kept:
        _kept.update(cuda_build.build_all())
    libs = dict(_kept)
    if lib is not None:
        libs[name] = lib
    cuda_build._declare(libs)
    cuda_build._LIBS[name] = libs[name]


def counters(torch, fn, trace_path) -> dict:
    """CUPTI's counters for one fn() through torch.profiler, summed over the
    events of its trace, or {"unavailable": reason}."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    try:
        cfg = _ExperimentalConfig(profiler_metrics=list(METRICS),
                                  profiler_measure_per_kernel=True)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     experimental_config=cfg) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace_path))
        events = json.loads(trace_path.read_text()).get("traceEvents", [])
    except Exception as exc:  # the machine may refuse the counters
        return {"unavailable": f"{type(exc).__name__}: {exc}"[:200]}
    found = {}
    for e in events:
        for metric in METRICS:
            v = (e.get("args") or {}).get(metric)
            if isinstance(v, (int, float)):
                found[metric] = found.get(metric, 0.0) + float(v)
    cats = sorted({str(e.get("cat")) for e in events})
    return found or {"unavailable": "no counter in the profiler's trace",
                     "categories": cats}


def counters_main() -> int:
    """The counters of the two cases furthest from their bound, printed as
    one JSON line: compact_positions at 6M sel 0.5, sublane_gather at R =
    16,384 (run in a child process: CUPTI's profiler mode may fail hard)."""
    import torch

    from ..ops import cuda_build
    from ..ops import pgather as pg
    from ..ops import substrate as sb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    mask = torch.rand(5_997_593, device=dev, generator=gen) < 0.5
    k = int(mask.sum())
    r = 16_384
    m = 60_000_000 // (r * 128) * r
    tab = torch.randint(0, 1 << 30, (r, 128), device=dev, generator=gen,
                        dtype=torch.int32)
    ridx = torch.randint(0, r, (m, 128), device=dev, generator=gen,
                         dtype=torch.int32)
    trace = cuda_build.BUILD_DIR / "sweep" / "counters.json"
    got = {}
    for label, fn in (
            ("compact_positions n=5997593 sel=0.5 k=count",
             lambda: pg.compact_positions(mask, k)),
            (f"sublane_gather R={r} m={m}",
             lambda: sb.sublane_gather(tab, ridx))):
        got[label] = counters(torch, fn, trace)
    print(json.dumps(got), flush=True)
    return 0


def sweep_gather_shift(torch, sb, variants, rep, gen) -> None:
    """gather_shift's variants at the bench's shapes, its staging alone, and
    each side of each form edge of the kept build (every case checked bit
    for bit against the plain version; the launch each makes is printed)."""
    dev = torch.device("cuda")

    def data(s, n):
        table = torch.randint(0, 1 << 30, (s,), device=dev, generator=gen,
                              dtype=torch.int32)
        idx = torch.randint(0, s, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        return table, idx

    def run(variant, s, n, table, idx):
        use("table_gather", variants.get(("table_gather", variant)))
        plan = sb.gather_shift_plan(s, n)
        ok = torch.equal(sb.gather_shift(table, idx),
                         sb.table_gather_plain(table, idx))
        rep("gather_shift", variant,
            f"S={s} n={n} {plan['form']} held={plan['held']} "
            f"blocks={plan['blocks']} smem={plan['smem']}", ok,
            lambda: sb.gather_shift(table, idx), n * 8 + s * 4)

    use("table_gather", None)
    edges = sb.gather_shift_edges()
    print(f"# gather_shift edges (kept): {edges}", flush=True)
    for n in (6_000_000, 60_000_000):
        for s, runs in (
                (1 << 16, ("kept", "l2", "stage_loads", "kept")),
                (1 << 21, ("kept", "kept"))):
            table, idx = data(s, n)
            for variant in runs:
                run(variant, s, n, table, idx)
            del table, idx
    # the staging alone: the staged form at n = 4,096, the L2 form beside
    table, idx = data(1 << 16, 4096)
    for variant in ("kept", "stage_loads", "l2"):
        run(variant, 1 << 16, 4096, table, idx)
    # each side of each form edge, against the L2 form
    for s in sorted(set(edges) | {e + 1 for e in edges}):
        table, idx = data(s, 6_000_000)
        for variant in ("kept", "l2"):
            run(variant, s, 6_000_000, table, idx)
        del table, idx
    # tables held in part over a wider range, against the L2 form
    for n in (6_000_000, 60_000_000):
        for s in (1 << 17, 3 << 16, 1 << 18, 1 << 19):
            table, idx = data(s, n)
            for variant in ("partial_wide", "l2"):
                run(variant, s, n, table, idx)
            del table, idx
    use("table_gather", None)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=SECTIONS, nargs="+", default=SECTIONS,
                    help="the sections to run (default: all)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("design_sweep: FAILED: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import pgather as pg
    from ..ops import substrate as sb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"# design_sweep: {smi.stdout.strip()}", flush=True)
    libraries = {"compact_positions": ("compact_positions",),
                 "sublane_gather": ("tile_gather",),
                 "gather_shift": ("table_gather",),
                 "gathers": ("gather_sorted", "gather_chunked")}
    variants = build_variants({lib for s in args.only if s in libraries
                               for lib in libraries[s]})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases, failed = [], []

    def rep(name, variant, shape, ok, fn, nbytes):
        card, call = card_ms(torch, fn), call_ms(torch, fn)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        cases.append({"kernel": name, "variant": variant, "shape": shape,
                      "correct": bool(ok), "card_ms": card, "ms": call,
                      "bound_ms": bound})
        if not ok:
            failed.append(f"{name}[{variant}] {shape}")
        print(f"{name}[{variant}] {shape}: card={card:.4f}ms call={call:.4f}ms "
              f"bound={bound:.4f}ms correct={bool(ok)}", flush=True)

    if "compact_positions" in args.only:
        sweep_compact(torch, pg, variants, rep, gen)
    if "sublane_gather" in args.only:
        sweep_sublane(torch, sb, variants, rep, gen)
    if "gather_shift" in args.only:
        sweep_gather_shift(torch, sb, variants, rep, gen)
    if "gathers" in args.only:
        sweep_gathers(torch, pg, variants, rep, gen)
    if "counters" in args.only:
        cases.append({"counters": run_counters()})

    print(json.dumps({"cases": cases}), flush=True)
    if failed:
        print("design_sweep: FAILED: " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


def sweep_compact(torch, pg, variants, rep, gen) -> None:
    """compact_positions' tile sizes at every mask length, then k = 0 and
    count_nonzero beside the kept build."""
    dev = torch.device("cuda")
    # masks of each size the rule separates
    u = torch.rand(60_000_000, device=dev, generator=gen)
    masks = []
    for rows, sel, k in ((1_024, 0.5, None), (65_536, 11_268 / 65_536, 65_536),
                         (1_500_000, 57_371 / 1_500_000, 196_608),
                         (3_000_000, 0.5, None), (5_997_593, 0.5, None),
                         (5_997_593, 0.02, None),
                         (5_997_593, 75_029 / 5_997_593, 262_144),
                         (60_000_000, 0.5, 45_008_192)):
        mask = u[:rows] < sel
        kk = k if k is not None else int(mask.sum())
        masks.append((f"n={rows} sel={sel:.4f} k={kk}", mask, kk))
    for variant in ("kept", "tile4k", "tile8k", "tile16k", "kept"):
        use("compact_positions", variants.get(("compact_positions", variant)))
        for shape, mask, k in masks:
            cnt, pos = pg.compact_positions(mask, k)
            pcnt, ppos = pg.compact_positions_plain(mask, k)
            ok = int(cnt) == int(pcnt) and torch.equal(pos, ppos)
            rep("compact_positions", variant, shape, ok,
                lambda m=mask, kk=k: pg.compact_positions(m, kk),
                mask.numel() + 4 * k + 4)
    use("compact_positions", None)
    for shape, mask, k in masks[4:6] + masks[7:]:
        cnt0, _ = pg.compact_positions(mask, 0)
        rep("compact_positions", "kept, k=0", shape,
            int(cnt0) == int(mask.sum()),
            lambda m=mask: pg.compact_positions(m, 0), mask.numel() + 4)
        rep("count_nonzero", "library", shape, True,
            lambda m=mask: torch.count_nonzero(m), mask.numel())
    del u, masks


def sweep_sublane(torch, sb, variants, rep, gen) -> None:
    """sublane_gather: an (R, 128) table and 60M row indices, as
    substrate_bench.py's calib_sub cases, under each shared-memory budget
    and without the partial band."""
    dev = torch.device("cuda")
    n_all = 60_000_000
    # the last R of each band width under the kept budget, where the 128 KB
    # budget takes the next narrower band (or, at 7,264, the partial band)
    edges = (454, 908, 1816, 3632, 7264)
    runs = [("kept", r) for r in edges + (4096, 7265, 16384)]
    runs += [("smem128k", r) for r in edges]
    runs += [("no_partial", r) for r in (7265, 16384)]
    runs += [("kept", r) for r in (4096, 16384)]
    for variant, r in runs:
        use("tile_gather", variants.get(("tile_gather", variant)))
        m = max(1, n_all // (r * 128)) * r
        tab = torch.randint(0, 1 << 30, (r, 128), device=dev, generator=gen,
                            dtype=torch.int32)
        ridx = torch.randint(0, r, (m, 128), device=dev, generator=gen,
                             dtype=torch.int32)
        ok = torch.equal(sb.sublane_gather(tab, ridx),
                         sb.sublane_gather_plain(tab, ridx))
        rep("sublane_gather", variant, f"R={r} m={m}", ok,
            lambda t=tab, i=ridx: sb.sublane_gather(t, i),
            m * 128 * 8 + r * 128 * 4)
        del tab, ridx
    use("tile_gather", None)


def sweep_gathers(torch, pg, variants, rep, gen) -> None:
    """K2's and K1's variants at chip_smoke.py phase 3's shapes and at K1's
    few rows against its table; index_select of the stacked planes (int32
    cases) once beside them."""
    dev = torch.device("cuda")
    s = 5_997_593  # lineitem at SF1

    def planes(rows, c, dtype=torch.int32):
        return [torch.randint(-(1 << 31), (1 << 31) - 1, (rows,), device=dev,
                              generator=gen, dtype=torch.int64).to(dtype)
                for _ in range(c)]

    keep = torch.rand(s, device=dev, generator=gen) < 0.5
    (dense,) = torch.nonzero(keep, as_tuple=True)
    dense = dense.to(torch.int32)
    sparse = dense[::26].contiguous()  # q6's survivors: 115,405 rows
    few = dense[::max(int(dense.numel()) // 1024, 1)].contiguous()
    wide = planes(s, 8)
    k2 = [(f"s={s} n={int(dense.numel())} C={c}", wide[:c], dense)
          for c in (1, 2, 8)]
    k2 += [(f"s={s} n={int(sparse.numel())} C=7", wide[:7], sparse),
           (f"s={s} n={int(few.numel())} C=2", wide[:2], few),
           (f"s={s} n={int(dense.numel())} int64+bool",
            [planes(s, 1, torch.int64)[0], keep], dense)]
    for shape, tabs, idx in k2:
        if all(t.dtype == torch.int32 for t in tabs):
            stacked, idx64 = torch.stack(tabs), idx.to(torch.int64)
            rep("index_select", "library", shape, True,
                lambda t=stacked, i=idx64: torch.index_select(t, 1, i),
                4 * idx.numel() * (1 + 2 * len(tabs)))
    for variant in ("kept", "quad_one", "strided_all", "no_split",
                    "no_split_strided", "all_split", "kept"):
        use("gather_sorted", variants.get(("gather_sorted", variant)))
        for shape, tabs, idx in k2:
            n = idx.numel()
            ok = all(torch.equal(a, b) for a, b in zip(
                pg.gather_sorted_planes(tabs, idx),
                pg.gather_sorted_planes_plain(tabs, idx)))
            rep("gather_sorted", variant, shape, ok,
                lambda t=tabs, i=idx: pg.gather_sorted_planes(t, i),
                4 * n + sum(2 * t.dtype.itemsize * n for t in tabs))
    use("gather_sorted", None)
    del wide, dense, sparse, few, keep, k2
    k1 = []
    for tab_rows, c, n in ((25, 1, s), (10_000, 1, s), (16_384, 1, s),
                           (10_000, 2, s), (150, 1, 75_029), (11_268, 6, 10),
                           (16_384, 1, 1_000), (16_384, 1, 16_384),
                           (16_384, 1, 100_000), (16_384, 8, 100_000)):
        tabs = planes(tab_rows, c, torch.int64 if c == 8 else torch.int32)
        idx = torch.randint(0, tab_rows, (n,), device=dev, generator=gen,
                            dtype=torch.int32)
        shape = f"s={tab_rows} n={n} C={c}" + (" int64" if c == 8 else "")
        k1.append((shape, tabs, idx))
        if c < 8:
            stacked, idx64 = torch.stack(tabs), idx.to(torch.int64)
            rep("index_select", "library", shape, True,
                lambda t=stacked, i=idx64: torch.index_select(t, 1, i),
                4 * n * (1 + c))
    for variant in ("kept", "threads512", "quad_one", "no_l1_rule",
                    "all_direct", "no_direct", "kept"):
        use("gather_chunked", variants.get(("gather_chunked", variant)))
        for shape, tabs, idx in k1:
            n = idx.numel()
            ok = all(torch.equal(a, b) for a, b in zip(
                pg.gather_chunked_planes(tabs, idx),
                pg.gather_chunked_planes_plain(tabs, idx)))
            rep("gather_chunked", variant, shape, ok,
                lambda t=tabs, i=idx: pg.gather_chunked_planes(t, i),
                4 * n + sum(t.dtype.itemsize * (n + t.numel()) for t in tabs))
    use("gather_chunked", None)


def run_counters() -> dict:
    """The hardware counters, where CUPTI gives them (a child process)."""
    try:
        child = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--counters"],
            capture_output=True, text=True, timeout=300)
        lines = child.stdout.strip().splitlines()
        got = json.loads(lines[-1]) if child.returncode == 0 and lines else {
            "unavailable": f"exit {child.returncode}: "
                           + child.stderr.strip()[-200:]}
    except subprocess.TimeoutExpired:
        got = {"unavailable": "the counters' run took over 300 s"}
    print(f"counters: {json.dumps(got)}", flush=True)
    return got


if __name__ == "__main__":
    sys.exit(counters_main() if "--counters" in sys.argv[1:] else main())
