"""Where a query's time goes on the card: torch.profiler over TPC-H queries.

    python3 -m lingodb_tpu_torch.tools.gpu_profile --sf 1 --queries 6,1,3 \\
        --paths fused,eager --out out/gpu_profile.json

For each path (the fused programs: the fused aggregate, the fused chain and
the TopK epilogue, replayed from their CUDA graphs; the same programs run as
they are called, "uncaptured"; or the eager operators with all three
declined) and each query (tables already uploaded, one warm run first) it
reports the wall time of `Session.sql` + `format_rows`, the
summed device time of all kernels and copies, the device's idle share of the
wall time, how many kernels were launched, how many host<->device scalar
reads (`aten::item`) the query made, the kernels that took the most device
time, the fused programs captured and replayed in the profiled run
(utils/compilestats.py), and from one more run outside the profiler the host
syncs (torch.cuda.set_sync_debug_mode) and the peak of allocated device
memory.
Needs a CUDA device; fails without one."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time
import warnings


# names of the engine kernels' __global__ functions in lingodb_tpu_torch/csrc/
# (each in an anonymous namespace, which tells them apart from PyTorch's own
# reduce/scan kernels); tests/test_torch_pgather.py holds the list against
# the sources. gather_direct_kernel is the direct form of both gathers (K2,
# and K1 at few rows against its table)
PORT_KERNELS = ("compact_prologue", "compact_kernel", "gather_direct_kernel",
                "gather_chunked_kernel", "segscan_kernel")
_PORT_KERNEL_RE = re.compile(r"\(anonymous namespace\)::(%s)[<(]"
                             % "|".join(PORT_KERNELS))


FUSED_ENTRY_POINTS = ("_try_fused_agg", "_try_fused_chain", "_try_fused_topk")


@contextlib.contextmanager
def eager_path():
    """Within the block, the fused programs (the aggregate, the chain and
    the TopK epilogue) decline and every operator runs eagerly."""
    from ..runtime.executor import Executor

    orig = {name: getattr(Executor, name) for name in FUSED_ENTRY_POINTS}
    for name in FUSED_ENTRY_POINTS:
        setattr(Executor, name, lambda self, op, epi=None: None)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(Executor, name, fn)


@contextlib.contextmanager
def uncaptured_path():
    """Within the block, the fused programs run as they are called: no CUDA
    graph is captured or replayed (runtime/exestore.py's switch)."""
    from ..runtime import exestore

    old = exestore.CAPTURE
    exestore.CAPTURE = False
    try:
        yield
    finally:
        exestore.CAPTURE = old


def path_context(path: str):
    if path not in ("fused", "uncaptured", "eager"):
        raise ValueError(f"unknown path {path!r}")
    if path == "eager":
        return eager_path()
    if path == "uncaptured":
        return uncaptured_path()
    return contextlib.nullcontext()


def syncs_and_peak(torch, fn):
    """(host syncs, peak allocated device bytes, bytes allocated before) of
    one call of fn: every synchronizing CUDA operation warns under sync
    debug mode."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message).lower())
    return syncs, torch.cuda.max_memory_allocated(), before


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch")


def host_launches(torch, fn) -> int:
    """The launches the host made in one call of fn: kernel launches and
    graph launches (a replay counts one), from torch.profiler's runtime
    events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)


def copy_overlap(torch, fn) -> dict:
    """Host -> device copies against kernels in one traced call of fn: the
    copies' summed time on the card and the share of it that lies under
    some kernel (a copy on a side stream while the compute stream runs).
    None where the trace holds no copy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != on_device:
            continue
        span = (e.time_range.start, e.time_range.end)
        if span[1] <= span[0]:
            continue
        name = e.name.lower()
        if "memcpy" in name and "htod" in name:
            copies.append(span)
        elif "memcpy" not in name and "memset" not in name:
            kernels.append(span)
    if not copies:
        return {"copy_ms": None, "hidden_share": None, "copies": 0}
    kernels.sort()
    merged: list = []
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = hidden = 0.0
    for a, b in copies:
        total += b - a
        for ka, kb in merged:
            if kb <= a:
                continue
            if ka >= b:
                break
            hidden += min(b, kb) - max(a, ka)
    return {"copy_ms": total / 1e3, "hidden_share": hidden / total,
            "copies": len(copies)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_query(torch, session, sql: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..utils import compilestats

    session.sql(sql).format_rows()  # warm: uploads, allocator, captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cs0 = compilestats.snapshot()
        t0 = time.perf_counter()
        rows = session.sql(sql).format_rows()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        cs = compilestats.delta(cs0)
    events = prof.key_averages()
    # kernel and copy rows only: operator rows repeat their kernels' time
    on_device = torch.autograd.DeviceType.CUDA
    dev = [(e.key, _device_us(e), e.count) for e in events
           if e.device_type == on_device and _device_us(e) > 0]
    dev.sort(key=lambda x: -x[1])
    own = [d for d in dev if _PORT_KERNEL_RE.search(d[0])]
    device_ms = sum(d[1] for d in dev) / 1e3
    if device_ms > wall_ms:
        raise RuntimeError(
            f"device time {device_ms:.3f} ms exceeds wall time {wall_ms:.3f} ms: "
            "some device rows were counted twice")
    by_name = {e.key: e.count for e in events}
    syncs, peak, before = syncs_and_peak(
        torch, lambda: session.sql(sql).format_rows())
    return {
        "captures": cs["captures"],
        "replays": cs["replays"],
        "syncs": syncs,
        "peak_bytes": peak,
        "resident_bytes": before,
        "rows": len(rows),
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "device_kernels": sum(d[2] for d in dev),
        "scalar_reads": by_name.get("aten::item", 0),
        "launch_calls": by_name.get("cudaLaunchKernel", 0),
        "port_kernels": [{"name": k[:60], "ms": us / 1e3, "count": c}
                         for k, us, c in own],
        "top_device": [{"name": k[:100], "ms": us / 1e3, "count": c}
                       for k, us, c in dev[:10]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920601)
    ap.add_argument("--queries", default="6,1,14,3,4",
                    help="TPC-H query numbers, comma-separated ('' for none)")
    ap.add_argument("--sql", action="append", default=[],
                    help="a query's text, profiled as sql1, sql2, ... "
                         "(repeatable)")
    ap.add_argument("--paths", default="fused,uncaptured,eager")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gpu_profile: no CUDA device", file=sys.stderr)
        return 1
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import tpchgen

    s = ldb.create_in_memory()
    tpchgen.install(s, tpchgen.generate(args.sf, args.seed))
    report = {"device": torch.cuda.get_device_name(0), "sf": args.sf,
              "paths": {}}
    for path in args.paths.split(","):
        report["paths"][path] = {}
        with path_context(path):
            texts = {q: open(os.path.join("queries", "tpch", f"{q}.sql")).read()
                     for q in args.queries.split(",") if q}
            texts.update({f"sql{i}": t for i, t in enumerate(args.sql, 1)})
            for q, sql in texts.items():
                r = profile_query(torch, s, sql)
                report["paths"][path][q] = r
                print(f"[{path}] {q}: wall {r['wall_ms']:.2f} ms, device "
                      f"{r['device_ms']:.2f} ms, idle share "
                      f"{r['device_idle_share']:.3f}, {r['device_kernels']} "
                      f"kernels, {r['captures']} captures, {r['replays']} "
                      f"replays, {r['scalar_reads']} scalar reads, "
                      f"{r['syncs']} syncs, peak {r['peak_bytes'] / 2**20:.1f} MiB "
                      f"({r['resident_bytes'] / 2**20:.1f} resident before)")
                for t in r["top_device"][:6]:
                    print(f"    {t['ms']:.3f} ms x{t['count']}  {t['name']}")
                for t in r["port_kernels"]:
                    print(f"    own: {t['ms']:.4f} ms x{t['count']}  {t['name']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
