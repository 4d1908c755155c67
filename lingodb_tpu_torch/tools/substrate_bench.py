"""The substrate kernel bench on the card: the seven table-gather and tile
kernels of ops/substrate.py, case by case, each held against its plain
version and timed beside one PyTorch library call that computes the same
function (the port of benchtools/tools_kbench.py and the timing run of
benchtools/tools_pallas_gather.py, as one entry point).

    python3 -m lingodb_tpu_torch.tools.substrate_bench [--quick]

N = 60,000,000 elements (6,000,000 with --quick). Cases, at the
reference scripts' shapes:

  calib_lane            T3 lane_gather, (N // 131072 * 1024, 128)
  calib_sub_R{R}        T4 sublane_gather, an (R, 128) table, (nt * R, 128)
                        row indices, nt = max(1, N // (R * 128)),
                        R = 8, 64, 512, 4096, 16384
  calib_roll            T5 lane_rotsum, (4096, 128)
  calib_pltpuroll       T6 the same kernel on the same array (the reference
                        probes two TPU instructions for one function)
  gather_shift_S{S}_n{n}  T1, S = 2^16 and 2^21 at n = N, S = 2^21 at 2^20
                        (each preceded by the launch its form makes)
  gather_small_S{S}_n{n}  T2, S = 1024 and 4096 at n = N, S = 1024 at 2^20
  mm_compact            T7 onehot_compact, (N // 32768 * 256, 128), 20 % of
                        m set, x < 2^15
  torch_take_S{S}       torch.take at S = 1024, 2^16, 2^21 and n = N: the
                        library baselines (the reference's xla_take)

Inputs come from a torch.Generator on the card seeded 0. Each kernel case
is checked bit for bit against the wrapper's plain PyTorch version on the
same inputs. Per case it prints the check, ms per call by CUDA events around
10 calls ("call", host launch cost included), the kernel's own time per
call from torch.profiler ("card"), the plain version's call time, the
library call's call and card time, and the bytes bound: each input read once
and each output written once, over the H100 SXM data-sheet rate of
3.35 TB/s. The library calls are torch.take (T1, T2), torch.gather (T3, T4),
an int32 row sum expanded to 128 columns (T5, T6) and the fp32 one-hot
torch.bmm with TF32 off (T7); their int64 indices and one-hot operands are
made once, outside the timed call. The last line is one JSON object with
every case and the launches per kernel. Any failed check exits non-zero.
Needs a CUDA device: without one it fails and never runs on the CPU."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from .kbench import HBM_BYTES_PER_S, call_ms, card_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="N = 6,000,000 instead of 60,000,000")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("substrate_bench: FAILED: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import substrate as sb

    sb.reset_counters()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    n_all = 6_000_000 if args.quick else 60_000_000
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"# substrate_bench: {smi.stdout.strip() or torch.cuda.get_device_name(0)} "
          f"N={n_all}", flush=True)
    cases = []

    def rand_i32(lo, hi, shape):
        return torch.randint(lo, hi, shape, device=dev, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def case(name, row, kernel, fn, plain, library, nbytes, elems):
        """Check fn() against plain() bit for bit, then time fn, plain and
        library; the launches are the kernel's over this case."""
        t0 = time.perf_counter()
        before = sb.LAUNCHES[kernel] if kernel else 0
        got, want = fn(), plain()
        torch.cuda.synchronize()
        ok = got.shape == want.shape and got.dtype == want.dtype
        err = (int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
               if ok and got.numel() else 0)
        ok = ok and err == 0
        lib_out = library()
        lib_equal = bool(torch.equal(lib_out.to(torch.int32).reshape(want.shape),
                                     want))
        del got, want, lib_out
        ms, card = call_ms(torch, fn), card_ms(torch, fn)
        plain_ms = call_ms(torch, plain, 3)
        lib_ms, lib_card = call_ms(torch, library, 5), card_ms(torch, library)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        launches = (sb.LAUNCHES[kernel] - before) if kernel else 0
        cases.append({"name": name, "row": row, "kernel": kernel,
                      "correct": ok, "max_abs_err": err, "elements": elems,
                      "ms": ms, "card_ms": card, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_card_ms": lib_card,
                      "library_equal": lib_equal, "bound_ms": bound,
                      "bound_by": "bytes", "bytes": nbytes,
                      "launches": launches,
                      "seconds": time.perf_counter() - t0})
        print(f"{name} [{row} {kernel}]: correct={ok} max_abs_err={err} "
              f"call={ms:.4f}ms card={card:.4f}ms plain={plain_ms:.4f}ms "
              f"library={lib_ms:.4f}ms library_card={lib_card:.4f}ms "
              f"(equal={lib_equal}) bound={bound:.4f}ms "
              f"card/bound={card / max(bound, 1e-9):.2f} launches={launches} "
              f"({cases[-1]['seconds']:.1f}s)",
              flush=True)

    # ---- T3 calib_lane: (n_tiles * 1024, 128)
    rows = n_all // (1024 * 128) * 1024
    data = rand_i32(0, 1 << 30, (rows, 128))
    lanes = rand_i32(0, 128, (rows, 128))
    lanes64 = lanes.to(torch.int64)
    case("calib_lane", "T3", "lane_gather", lambda: sb.lane_gather(data, lanes),
         lambda: sb.lane_gather_plain(data, lanes),
         lambda: torch.gather(data, 1, lanes64), rows * 128 * 4 * 3, rows * 128)
    del data, lanes, lanes64

    # ---- T4 calib_sub_R: an (R, 128) table, (nt * R, 128) row indices
    for r in (8, 64, 512, 4096, 16384):
        m = max(1, n_all // (r * 128)) * r
        tab = rand_i32(0, 1 << 30, (r, 128))
        ridx = rand_i32(0, r, (m, 128))
        ridx64 = ridx.to(torch.int64)
        case(f"calib_sub_R{r}", "T4", "sublane_gather",
             lambda t=tab, i=ridx: sb.sublane_gather(t, i),
             lambda t=tab, i=ridx: sb.sublane_gather_plain(t, i),
             lambda t=tab, i=ridx64: torch.gather(t, 0, i),
             m * 128 * 4 * 2 + r * 128 * 4, m * 128)
        del tab, ridx, ridx64

    # ---- T5 calib_roll and T6 calib_pltpuroll: one function, one kernel
    tab = rand_i32(0, 1 << 30, (4096, 128))
    for name, row in (("calib_roll", "T5"), ("calib_pltpuroll", "T6")):
        case(name, row, "lane_rotsum", lambda: sb.lane_rotsum(tab),
             lambda: sb.lane_rotsum_plain(tab),
             lambda: tab.sum(1, dtype=torch.int32, keepdim=True).expand(-1, 128),
             4096 * 128 * 4 * 2, 4096 * 128)
    del tab

    # ---- T1 gather_shift, T2 gather_small: table[idx]
    for row, kernel, fn, shapes in (
            ("T1", "gather_shift", sb.gather_shift,
             ((1 << 16, n_all), (1 << 21, n_all), (1 << 21, 1 << 20))),
            ("T2", "gather_small", sb.gather_small,
             ((1024, n_all), (4096, n_all), (1024, 1 << 20)))):
        for s, n in shapes:
            table = rand_i32(0, 1 << 30, (s,))
            idx = rand_i32(0, s, (n,))
            idx64 = idx.to(torch.int64)
            if kernel == "gather_shift":
                print(f"# {kernel}_S{s}_n{n} launch: "
                      f"{json.dumps(sb.gather_shift_plan(s, n))}", flush=True)
            case(f"{kernel}_S{s}_n{n}", row, kernel,
                 lambda f=fn, t=table, i=idx: f(t, i),
                 lambda t=table, i=idx: sb.table_gather_plain(t, i),
                 lambda t=table, i=idx64: torch.take(t, i),
                 n * 4 * 2 + s * 4, n)
            del table, idx, idx64

    # ---- T7 mm_compact: 256-row tiles, 20 % of m set, x < 2^15
    rows = max(1, n_all // (sb.TILE_ROWS * 128)) * sb.TILE_ROWS
    xs = rand_i32(0, 1 << 15, (rows, 128))
    ms = (torch.rand((rows, 128), device=dev, generator=gen) < 0.2).to(torch.int32)
    onehot, xm = sb.onehot_operands(xs, ms)
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 for the library bmm
    case("mm_compact", "T7", "onehot_compact", lambda: sb.onehot_compact(xs, ms),
         lambda: sb.onehot_compact_plain(xs, ms),
         lambda: torch.bmm(onehot, xm), rows * 128 * 4 * 3, rows * 128)
    del xs, ms, onehot, xm

    # ---- library baselines: torch.take at the reference's xla_take shapes
    for s in (1024, 1 << 16, 1 << 21):
        table = rand_i32(0, 1 << 30, (s,))
        idx64 = rand_i32(0, s, (n_all,)).to(torch.int64)
        case(f"torch_take_S{s}", "baseline", None,
             lambda t=table, i=idx64: torch.take(t, i),
             lambda t=table, i=idx64: t[i], lambda t=table, i=idx64: torch.take(t, i),
             n_all * (8 + 4) + s * 4, n_all)
        del table, idx64

    print(json.dumps({"device": torch.cuda.get_device_name(0), "n": n_all,
                      "cases": cases, "launches": dict(sb.LAUNCHES)}),
          flush=True)
    bad = [c["name"] for c in cases if not c["correct"]]
    if bad:
        print(f"substrate_bench: FAILED: {bad} differ from their plain versions",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
