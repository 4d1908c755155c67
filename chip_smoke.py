#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py            # TPC-H scale factor 1
    python3 chip_smoke.py --sf 0.2   # smaller data (lineitem stays >= 1M rows)

Phases, each of which ends the run with a non-zero exit code when it fails:

  1. device   require CUDA; print the card's name and power limit
  2. build    compile the CUDA kernels of lingodb_tpu_torch/csrc with nvcc
  3. kernels  launch each kernel wrapper at the main path's shapes, require
              bit-equality with its plain PyTorch version, time both (and one
              PyTorch library call computing the same function) with CUDA
              events around 10 calls, read the kernels' own time on the card
              (and the library call's) from torch.profiler, compute the bytes
              bound; compact_positions also on the edges of its one-pass
              design (n at a tile's edges and n = 1, masks all zeros and all
              ones, set bits only in the last tile, count = k + 1, count >> k,
              k >> count, an unaligned mask, uint8 and int8 masks, a second
              stream, two calls back to back, calls after one that raised
              before its launch, a call at the wrap of the call number the
              kernel keeps on the card), count and slots bit for bit, and
              from two threads on the default stream at once (50 calls
              each, sel 0.5 and 0.02, with a time limit on the join: a hang
              fails); gather_chunked and gather_sorted also on the edges
              of theirs (every plane width alone and eight widths in one
              call, s = 1 and 16,384, K1's plane groups past 227 KB and
              its direct and staged forms, n = 0 and 1, planes, idx and
              outputs at an odd element, out-of-range and SENTINEL
              indices, K2 given unsorted indices), bit for bit; K2's cases
              also print the sector floor (32 bytes for each sector that
              holds a requested entry);
              segscan is only
              checked here (at lineitem's length, runs of 4 and one run over
              the whole array; then n below one tile and at a tile's edges,
              every row a head, runs longer than a tile, W = 1, 3, 8 and 9,
              strided limb planes, int32 wrap, two calls back to back) and
              timed by the kernel bench of phase 7
  4. queries  TPC-H q6, q1, q14, q3, q4 through Session.sql on the card over
              generated tables, on two paths: the fused aggregate program
              (it must engage for every query) and the eager operators (the
              fused program declined); every result must equal that of a
              second session on device="cpu" (plain versions) over the same
              tables, q6 also a direct numpy sum; each of compact_positions,
              gather_sorted and gather_chunked must have been launched on
              the fused path. Per query and path: launches, wall time, host
              syncs (sync debug mode) and peak device memory of a second run.
              Then the fused path once more with every kernel call checked
              bit for bit against the plain version on the very same inputs,
              listing the shapes each query hands each kernel
  4b. topk/chain the queries whose TopK or multi-join chain the fused
              programs carry (TopK: q2, q3, q10, q18, q21; chain: q8, q9, q11,
              q16, q17, q20; q2, q3, q10, q18 through both) three ways, from
              a clean stage cache: on the fused path, with all three fused
              entry points declined (the eager operators) and on the CPU
              session; the rows equal on all three and again on a second
              run; which queries engaged the fused TopK and the fused chain,
              on the card and on the CPU (the sets must be equal and neither
              empty); per query and path the wall time (second run), host
              syncs and launches; then every chain run once more from a clean
              cache with each kernel call checked bit for bit against its
              plain version at the chain's own shapes (the chain's tail must
              have launched compact_positions or gather_sorted)
  5. the rest the other 17 TPC-H queries, card against CPU session
  6. battery  ~100 SQL statements over small tables held as tensors (joins of
              every kind, set operations, subqueries, casts, NULLs), card
              against CPU session; (b) the statements of
              lingodb_tpu_torch/tools/sqlite_battery.py (ORDER BY / LIMIT /
              OFFSET after a set operation, grouped string keys with NULLs
              under string functions, set operations, ROLLUP and CUBE;
              lag / lead, ntile, nth_value, substring, replace, concat and
              NULL literal arguments at their edges, two of them raising
              PostgreSQL's errors; errors the data raises: INT and BIGINT
              arithmetic beyond the range, casts of strings, decimals and
              doubles to integers; arithmetic past int64; DECIMAL % and
              casts from DOUBLE and REAL to DECIMAL, and INSERTs that make
              them) on
              the tensor tier, and CUBE over two keys with NULLs at 30,000
              rows at the default tier, each card row equal to the CPU
              session's and to sqlite3's, or raising PostgreSQL's words as
              the CPU session does, every K1-K3 call checked against its
              plain version and counted; then INT arithmetic beyond INT's
              range in the fused aggregate over the SF1 lineitem, which
              must raise after the program's packed fetch on its captured
              run and on two replays
  7. kbench   `python -m lingodb_tpu_torch.tools.kbench --quick` as a
              subprocess, the entry point that runs segscan (no engine
              caller): every kernel at 6M rows, held against its plain
              version; segscan must have been launched there, and its times
              in the kernels line are that run's, as are compact_positions'
              at the shapes the fused queries pass (q14, q3 lead and
              boundary, q4)
  8. substrate `python -m lingodb_tpu_torch.tools.substrate_bench --quick` as
              a subprocess, the entry point that runs the seven substrate
              kernels T1-T7 (no engine caller): every case at the reference
              bench's shapes held bit for bit against its plain version, each
              kernel launched there; their times in the kernels line are that
              run's. Before it, in this process, the same kernels on the edges
              of their contracts (ragged and unaligned index arrays, indices
              out of range, gather_shift's tables at each change of form,
              with fewer indices than blocks, and an unaligned table;
              sublane_gather's tables at each change of band
              width and of form, R = 1 and m = 1, int32 wrap, one-hot tiles
              whose lane 0 is all ones
              or all zeros, runs crossing or ending on each 32-row segment
              edge of onehot_compact, single tiles, the 60M bench's 1,831
              tiles), against their plain versions
  9. executor the executor slice, each query's engine kernel calls (K1, K2,
              K3) checked bit for bit against their plain versions and
              counted, then a second run timed (wall ms, host syncs, peak
              device memory):
              (a) q1 and q6 over tools/tpchbig.py's lineitem subset at 10x
              the scale factor (SF10: 60M rows), streamed by the out-of-core
              aggregate at a 1 GiB system.device_byte_budget (the chunk
              layout must be the one the budget gives: q1 15 chunks of 2^22
              rows, q6 8 of 2^23; the table never uploaded whole; peak
              device memory under what was resident plus the budget, and
              flat across chunks) and resident at the default budget (the
              fused aggregate); rows equal; bytes copied host -> device,
              their rate, and the share of the copies' time under kernels
              (tools/gpu_profile.py's trace);
              (a') the same q1 and q6 streamed at 1 GiB and at 64 MiB (q1
              in chunks of 2^18 rows), the chunk program replayed from one
              CUDA graph a staging slot against run as it is called
              (tools/outofcore_bench.py's stream_runs), each from a session
              that captured nothing for it: two captures and then a replay
              a chunk in the first run, a replay a chunk in the second,
              none uncaptured; wall ms of both runs, the host's launches a
              chunk (torch.profiler, at 1 GiB), the host's fill ms; rows
              equal to the resident run's; then each at 1 GiB with a chunk
              program that reads the host (host_read_part): its capture
              raises HostRead and it streams uncaptured, rows equal;
              (a'') five aggregates over a wide decimal that only the host
              computes (sum, avg, a restricted global sum, min/max of
              l_extendedprice / 7, a price per unit) over the lineitem
              subset at the scale factor (SF1: 6M rows), streamed at a
              64 MiB budget in exact host lanes (more than one chunk, the
              plan uncaptured, the table never uploaded whole) against
              resident; rows equal as strings; wall ms both ways, chunks,
              host fill ms and the uncaptured chunk program's ms a chunk;
              (b) window functions over SF1 orders and lineitem (ranking,
              running and bounded frames, the sparse table's min/max,
              lag/lead/nth_value), card against CPU session;
              (c) WITH RECURSIVE over SF1 tables (a UNION fixpoint, a
              UNION ALL counter; at least 8 rounds), card against CPU
              session, once in DEBUG mode;
              (d) the chunked non-equi join (inner, semi, anti, left, full)
              of supplier and part on a price band, over 2^26 candidate
              pairs in at least 4 chunks, against numpy's band counts;
              (e) the 22 queries through Session.sql_many(overlap=True)
              against sequential Session.sql, each from evicted device
              memory; q9, q13 and q20 with device LIKE engaged on the card,
              rows equal to the CPU session's, the device mask equal to the
              host's and timed against it (strings.like_lut)
  10. graphs  the fused programs as CUDA graphs (runtime/exestore.py):
              (a) compact_positions captured in a graph and replayed over
              masks written into its input buffer (sel 0, 0.5 and 1, a
              count above k, the call number at its wrap), then two threads
              each replaying its own graph on its own stream (time limit on
              the join), and gather_chunked (int32 planes, planes of three
              widths, and 10 rows: its direct form), gather_sorted (int32
              planes, three widths) and segscan captured and replayed once
              each: bit for bit against the plain versions;
              (b) the fused queries of phases 4 and 4b (q6, q1, q14, q3,
              q4 and the eleven; 15 distinct) and a grouped sum of round
              with digits (ROUND_SQL; its replay must sync as q1's does)
              from an empty stage cache and
              store with system.capstore_dir set: three runs each, run 1
              calibrates and captures, runs 2 and 3 capture, build and
              calibrate nothing and replay; rows equal the CPU session's;
              per query the wall ms and host syncs replayed against run
              uncaptured (the store's switch), the capture seconds, the
              graph pool's MiB and the device idle share of both
              (tools/gpu_profile.py);
              (c) a fresh session over the same capstore: no calibration
              run, rows equal;
              (d) after Session._evict_device_memory the next run captures
              again, rows equal;
              (e) execution mode PERF over q6 and q3, its speed of light
              against system.hbm_gbps set to the H100 SXM data sheet's
              3350 GB/s (the setting has no default)
  11. tools   user-defined functions on the card and the tools that drive
              the engine, each kernel call (K1, K2, K3) checked bit for bit
              against its plain version and counted ("p11"):
              (a) a Python UDF, a C UDF and the Python UDF in the isolated
              worker (SET udf_isolation = 'process') over SF1 lineitem, in
              a WHERE under an aggregate (over a join with supplier and
              nation) and in an aggregate's argument: the aggregate over
              the UDF declines its fused program on the host, as on the CPU
              session (an aggregate above it may run fused over its eager
              result), no UDF is called inside a fused program, the filter
              launches K3 and K2; rows equal the CPU session's; per query the wall
              ms, the UDF's device -> host -> device round trip, host syncs
              and launches; a UDF that kills its worker raises UDFError and
              the next call succeeds;
              (b) the CLI as subprocesses over the TPC-H tables written to
              a database directory under .cache/: run-sql q1, q6, q3 (rows
              equal the in-process card session's), sql-to-plan, profile,
              sql-to-artifact q3 and run-artifact in a fresh process (rows
              equal; no parse, no optimizer, 0 calibrations);
              (c) the 22 TPC-H queries on the card at sf 0.005 against
              sqlite3 (tools/sqlite_oracle.py; sqlite runs on a thread
              beside (a) and (b));
              (d) the sqllogictest runner over tests/data/torch_basic.test,
              every table on the tensor tier: every record passes;
              (e) TPC-DS at the scale factor (tools/tpcdsgen.py): a star
              join of store_sales, date_dim and item grouped by brand and
              year (the shape of TPC-DS q3) through the fused aggregate,
              rows equal the CPU session's
  12. mesh    the sharded operators (parallel/shuffle.py) over a mesh of 8
              positions on the one card (the port's counterpart of the JAX
              package's 8 virtual devices; runtime/device.get_mesh builds
              none on one card) at the production system.shuffle_min_rows,
              the fused programs declined on the mesh: q3 and q18 (the JAX
              package's test_mesh_sf1.py) and the statements of its
              test_shuffle.py over lineitem and orders (inner join with its
              group-by, semi, anti with NULL keys, left, full, a scalar
              subquery's single join, count and sum distinct, ORDER BY
              descending and ascending through the sample sort, a skewed
              probe side that takes the heavy-hitter split), each held
              column by column against the one-card session and each
              strategy's shuffle.STATS counter required to move; every K1,
              K2, K3 call of the first meshed run checked bit for bit
              against its plain version (K2 and K3 must launch: VTable.dense
              of the lazy sharded results); wall ms, host syncs and peak
              device memory of a second run, meshed against one card. The
              base tables are held sharded from their upload (padded, with
              a pad mask); an operator without a sharded form gathers its
              input once ("gathers", which must move too: a window function
              over a filtered lineitem is the fourteenth statement)
  12 (b).     the fused aggregate's general (sorted) mode over tables held
              on the 8 positions: customer's 150,000 names (joined to
              nation) and supplier's s_acctbal (below
              system.shuffle_min_rows) must mark their plans, gather their
              base once a run and run the one-card program from its graph
              (a run after the capture: 1 gather, 0 captures, 1 replay);
              c_name's sum over orders and customer must not (the
              optimizer groups orders below the join); each held against
              the one-card session, every K1-K3 call of its first run
              checked, wall ms and host syncs against the eager operators;
              then the 22 TPC-H queries on the mesh against one card,
              listing those that take the gathered program
  13. upload  q1 and q6 over tools/tpchbig.py's SF10 lineitem (60M rows,
              from phase 9's cache) held sharded at upload over the 8
              positions: the fused aggregate runs position by position (one
              CUDA graph a position, captured on the first run and replayed
              on the second) with its lanes reduced across positions, rows
              equal to the one-card session's resident run; then a TopK over
              a filtered lineitem, whose input leaves the mesh in one
              gather. Printed: the bytes of base columns held a position
              against the whole table, gathers, host syncs, wall ms of a
              second run and the graph pool's MiB meshed against one card,
              K1-K3 launches of an uncaptured run (each call checked bit
              for bit against its plain version)
  14. processes with two or more cards, two processes of one card each
              (CUDA_VISIBLE_DEVICES) under NCCL run
              lingodb_tpu_torch/tools/mesh_procs.py: every mesh and shuffle
              function over the mesh that spans them against the one-process
              mesh, shard for shard, and q3, q1, q6 and four statements over
              sf 0.05 tables, rows equal to the one-process mesh's and the
              one-card session's on both processes. NCCL takes one card a
              rank, so on one card this phase says that it did not run
  15. wide    arithmetic past int64 (C24-C27, C29): (a) (run within phase
              3, before any other profiling) the checked kernel
              (csrc/checked_arith.cu) at lineitem's length against its plain
              version bit for bit, value and code, for each operator form
              (decimal products past int64, a product that rounds across the
              bound, a sum that rescales, INT and BIGINT arithmetic, a cast
              past a precision; a DECIMAL % whose dividend or divisor the
              rescale takes past int64; casts from DOUBLE and REAL to
              DECIMAL), its first rows the edges (INT64_MIN, +-(2^63 - 1),
              products exactly at the bound and one past it, rescales that
              round to the bound and across it; INT64_MIN % -1, remainders
              of exactly +-(2^63 - 1), zero divisors; 0.285, 1.005, 2.675,
              99.995 at DECIMAL(4,2), -0.0, a subnormal, 2^53 +- 1, +-9.2 *
              10^18 and past it, NaN and the infinities), timed beside the
              plain version, the int64 PyTorch passes (torch.fmod of the
              rescaled operands; torch.round(x * 10^s)) and the bytes bound,
              by CUDA events around calls, by torch.profiler and as replays
              of a CUDA graph of ten calls; the first mul, mod and cast_f
              forms then captured in a CUDA graph and replayed over new
              inputs, bit for bit; (b) seven statements over the SF1
              lineitem (WIDE_SQL: a grouped hand-written variance that needs
              the exact path on live rows, the same restricted to rows that
              fit, sum and avg of BIGINTs near 2^62, q1, a % whose dividend
              passes int64 at its scale, casts of a double and of a real to
              DECIMAL(15,2)), three runs each: rows equal the CPU session's;
              per run the wall ms, captures, replays, the statement's runs
              again on the exact path and the checked kernel's launches
              (every run of the last three must launch it); host syncs of
              the third run. Phase 6 (b) also runs tools/sqlite_battery.py's
              WIDE_STATEMENTS and MOD_CAST_STATEMENTS on the card, against
              the CPU session and the exact oracle

Output: progress lines, then the `nvidia-smi` name/power line, then one JSON
line {"kernels": [...]}, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

# the port's kernel bench: its timing helpers and the card's memory rate
from lingodb_tpu_torch.tools.kbench import HBM_BYTES_PER_S
from lingodb_tpu_torch.tools.kbench import call_ms as time_ms
from lingodb_tpu_torch.tools.kbench import card_ms as device_ms
from lingodb_tpu_torch.tools.kbench import sector_count

QUERIES = ["6", "1", "14", "3", "4"]
TOPK_CHAIN_QUERIES = ["2", "3", "10", "18", "21", "8", "9", "11", "16", "17",
                      "20"]
KERNEL_META = {
    "compact_positions": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/compact_positions.cu",
        "replaces": "lingodb_tpu/ops/pgather.py:249",
    },
    "gather_sorted": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/gather_sorted.cu",
        "replaces": "lingodb_tpu/ops/pgather.py:383",
    },
    "gather_chunked": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/gather_chunked.cu",
        "replaces": "lingodb_tpu/ops/pgather.py:163",
    },
    "segscan": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/segscan.cu",
        "replaces": "lingodb_tpu/ops/pgather.py:606",
    },
    # the substrate kernels, T1-T7 (ops/substrate.py); T5 and T6 are one
    # kernel, since the two reference probes compute one function
    "gather_shift": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/table_gather.cu",
        "replaces": "benchtools/tools_pallas_gather.py:42",
    },
    "gather_small": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/table_gather.cu",
        "replaces": "benchtools/tools_pallas_gather.py:89",
    },
    "lane_gather": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/tile_gather.cu",
        "replaces": "benchtools/tools_kbench.py:76",
    },
    "sublane_gather": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/tile_gather.cu",
        "replaces": "benchtools/tools_kbench.py:97",
    },
    "lane_rotsum_k_roll": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/lane_rotsum.cu",
        "replaces": "benchtools/tools_kbench.py:118",
    },
    "lane_rotsum_k_roll2": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/lane_rotsum.cu",
        "replaces": "benchtools/tools_kbench.py:141",
    },
    "onehot_compact": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/onehot_compact.cu",
        "replaces": "benchtools/tools_kbench.py:209",
    },
    # no Pallas counterpart: in the JAX package XLA fuses an operator's
    # value and its checks into one loop (the decimal operators' int64 path)
    "checked_arith": {
        "route": "cuda",
        "source": "lingodb_tpu_torch/csrc/checked_arith.cu",
        "replaces": "none (no Pallas counterpart: XLA's fusion of "
                    "lingodb_tpu/ops/scalar.py:943)",
    },
}
# each substrate row: its row in the substrate bench, its kernel there, and
# the bench case that heads its entry in the kernels line
SUBSTRATE_ROWS = {
    "gather_shift": ("T1", "gather_shift", "gather_shift_S65536_n"),
    "gather_small": ("T2", "gather_small", "gather_small_S1024_n"),
    "lane_gather": ("T3", "lane_gather", "calib_lane"),
    "sublane_gather": ("T4", "sublane_gather", "calib_sub_R4096"),
    "lane_rotsum_k_roll": ("T5", "lane_rotsum", "calib_roll"),
    "lane_rotsum_k_roll2": ("T6", "lane_rotsum", "calib_pltpuroll"),
    "onehot_compact": ("T7", "onehot_compact", "mm_compact"),
}
# the path whose run counts each kernel's launches: the fused aggregate for
# the engine's kernels, the kernel bench for segscan and the substrate bench
# for T1-T7 (none of them has an engine caller)
MAIN_PATH = {"compact_positions": "fused", "gather_sorted": "fused",
             "gather_chunked": "fused", "segscan": "kbench",
             **{name: "substrate" for name in SUBSTRATE_ROWS},
             "checked_arith": "wide"}
# the kernels of the fused chain's tail (phase 4b, path "topk_chain"): the
# compacted tail and the full-width tail's select_mask both take the
# survivors' positions (compact_positions) and gather the output columns at
# them (gather_sorted); the TopK tail ranks with torch.topk. Each kernel
# entry of the kernels line counts its checked calls inside the chain
# ("chain_calls_checked").
CHAIN_TAIL = ("compact_positions", "gather_sorted")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def fmt_ms(v) -> str:
    return "none" if v is None else f"{v:.4f}"


def max_abs_err(torch, got, want) -> int:
    """The largest difference between got and want, tensor by tensor, of
    their bits read as integers (a float's bits: 0 only where bit-equal)."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"shape/dtype mismatch {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            if g.dtype.is_floating_point:
                as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
                g = g.view(as_int[g.dtype.itemsize])
                w = w.view(as_int[w.dtype.itemsize])
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


def case_entry(name, shape, err, ms, dev_ms, plain_ms, library_ms,
               library_dev_ms, nbytes):
    return {"name": name, "shape": shape, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_dev_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def check_compact(torch, pg, n, cases):
    gen = torch.Generator(device="cuda").manual_seed(3)
    u = torch.rand(n, device="cuda", generator=gen)
    # the last case is a mask of a few rows: the dispatcher has no size
    # threshold, so small intermediate results take the kernel too
    for rows, sel in ((n, 0.02), (n, 0.5), (n, 0.98), (1024, 0.5)):
        mask = u[:rows] < sel
        cnt_p, pos_p = pg.compact_positions_plain(mask, rows)
        want = int(cnt_p)
        k = want
        cnt, pos = pg.compact_positions(mask, k)
        torch.cuda.synchronize()
        if int(cnt) != want:
            fail(f"compact_positions count {int(cnt)} != {want} at sel {sel}")
        err = max_abs_err(torch, [pos], [pos_p[:k]])
        # capacity with a sentinel tail
        _, pos2 = pg.compact_positions(mask, k + 1000)
        if int((pos2[k:] != pg.SENTINEL).sum()) or max_abs_err(
                torch, [pos2[:k]], [pos_p[:k]]):
            fail("compact_positions sentinel tail / prefix wrong")
        ms = time_ms(torch, lambda: pg.compact_positions(mask, k))
        dev = device_ms(torch, lambda: pg.compact_positions(mask, k))
        plain = time_ms(torch, lambda: pg.compact_positions_plain(mask, k), 3)
        lib = time_ms(torch, lambda: torch.nonzero(mask), 5)
        lib_dev = device_ms(torch, lambda: torch.nonzero(mask))
        cases.append(case_entry("compact_positions", f"n={rows} sel={sel} k={k}",
                                err, ms, dev, plain, lib, lib_dev,
                                rows + 4 * k + 4))
        if err:
            fail(f"compact_positions differs from plain version (sel {sel})")
    check_compact_edges(torch, pg, u)
    check_compact_threads(torch, pg, u)
    return u < 0.5


def check_compact_threads(torch, pg, u, calls=50, limit_s=300.0):
    """compact_positions from two threads on the default stream at once,
    each `calls` times on its own mask (sel 0.5 and 0.02, k = count): each
    thread has a scratch of its own (a call is two launches, the prologue
    that numbers it and the kernel, which two threads on one stream would
    interleave). Each thread waits for
    the card, and the joins have a time limit: a hang fails the run here.
    Then every result, count and slots, bit for bit against the plain
    version."""
    masks = [u < 0.5, u < 0.02]
    wants = [pg.compact_positions_plain(m, int(m.sum())) for m in masks]
    results, errors = [[], []], []

    def work(t):
        try:
            k = int(wants[t][0])
            for _ in range(calls):
                results[t].append(pg.compact_positions(masks[t], k))
            torch.cuda.synchronize()
        except Exception as exc:  # reported after the join
            errors.append(f"thread {t}: {exc!r}")

    threads = [threading.Thread(target=work, args=(t,), daemon=True)
               for t in range(2)]
    deadline = time.perf_counter() + limit_s
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    if any(th.is_alive() for th in threads):
        print(f"chip_smoke: FAILED: compact_positions from two threads did "
              f"not finish within {limit_s:.0f} s (a hang)", file=sys.stderr,
              flush=True)
        os._exit(1)  # a thread waits on the card: no orderly exit
    if errors:
        fail(f"compact_positions from two threads raised: {errors}")
    for t, (cnt_p, pos_p) in enumerate(wants):
        for c, (cnt, pos) in enumerate(results[t]):
            if int(cnt) != int(cnt_p) or max_abs_err(torch, [pos], [pos_p]):
                fail(f"compact_positions from two threads differs from the "
                     f"plain version: thread {t}, call {c}")
    log(f"# compact_positions from two threads: {calls} calls each, every "
        "result equal to the plain version")


def check_compact_edges(torch, pg, u):
    """compact_positions on the edges of its one-pass design, count and
    every slot bit for bit against the plain version: n at a tile's edges,
    at each change of tile size and n = 1, masks all zeros and all ones, set bits only in the last
    tile, count = k + 1 and count >> k (the count stays exact), k >> count
    at q14's shape, an unaligned mask, bool / uint8 / int8 masks, and two
    calls back to back on one stream with different n (no status word of
    the first may read as ready in the second), and calls after one that
    raised between taking its scratch and launching."""
    from lingodb_tpu_torch.ops import cuda_build

    n = u.numel()
    tile = cuda_build.lib("compact_positions").ldb_compact_tile()

    def same(label, mask, k, got=None):
        cnt, pos = got if got is not None else pg.compact_positions(mask, k)
        cnt_p, pos_p = pg.compact_positions_plain(mask, k)
        torch.cuda.synchronize()
        if int(cnt) != int(cnt_p) or max_abs_err(torch, [pos], [pos_p]):
            fail(f"compact_positions differs from plain version: {label} "
                 f"(n={mask.numel()}, k={k}, count {int(cnt_p)})")

    # the smallest tile's edges, and each change of tile size (2^20 and
    # 2^22 mask bytes)
    for rows in (1, tile - 1, tile, tile + 1, 2 * tile + 1, (1 << 20) - 1,
                 1 << 20, (4 << 20) - 1, 4 << 20, n):
        mask = u[:rows] < 0.3
        c = int(mask.sum())
        for k in (c, c + 1000, max(c - 1, 0)):
            same(f"n at a tile's edge, k={k}", mask, k)
    for label, one in (("set", u[:1] < 2.0), ("not set", u[:1] < -1.0)):
        for k in (0, 1, 5):
            same(f"n = 1, {label}, k={k}", one, k)
    zeros = torch.zeros(n, dtype=torch.bool, device="cuda")
    same("all zeros", zeros, 1000)
    same("all ones", ~zeros, n)
    same("all ones, k = tile + 1", ~zeros, tile + 1)
    last = zeros.clone()
    last[n - 100:] = u[n - 100:] < 0.5
    same("set bits only in the last tile", last, 1000)
    sparse = u < 0.3
    c = int(sparse.sum())
    same("count = k + 1", sparse, c - 1)
    same("count >> k", sparse, 1024)
    q14 = zeros.clone()
    q14[torch.randperm(n, device="cuda")[:75_029]] = True
    same("k >> count, q14's shape", q14, 262_144)
    odd = sparse[3: n - 5]
    same("unaligned mask", odd, c)
    for dt in (torch.uint8, torch.int8):
        same(f"{dt} mask", (u < 0.3).to(dt) * 7, c)
    # on a second stream (a scratch of its own), then on the first again
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = pg.compact_positions(sparse, c + 10)
    torch.cuda.current_stream().wait_stream(side)
    same("on a second stream", sparse, c + 10, got)
    same("back on the first stream", sparse, c + 10)
    # back to back, no synchronisation between the calls
    a, b = u < 0.2, (u < 0.7)[: n - 54_321]
    ka, kb = int(a.sum()) + 10, int(b.sum()) + 10
    got_a, got_b = pg.compact_positions(a, ka), pg.compact_positions(b, kb)
    same("back to back, first", a, ka, got_a)
    same("back to back, second", b, kb, got_b)
    # a call that raises after taking its scratch and number, before its
    # launch (as an out-of-memory error would, which Session answers by
    # running the plan again), uses up neither: the calls after it are right
    take = pg._compact_scratch_for

    class Injected(Exception):
        pass

    def take_then_raise(*args):
        take(*args)
        raise Injected

    pg._compact_scratch_for = take_then_raise
    try:
        pg.compact_positions(a, ka)
        fail("compact_positions: the injected error was not raised")
    except Injected:
        pass
    finally:
        pg._compact_scratch_for = take
    same("after a call that raised before its launch", b, kb)
    same("and the call after that", a, ka)
    # the wrap of the call number the kernel keeps on the card: the number
    # at its last value and every status word tagged with number 1 (as the
    # words of a call 2^30 - 1 calls ago might be), so that the call after
    # the wrap finds them all ready unless its prologue zeroes them
    stale_scratch(torch, pg._compact_scratch_for(
        u.device, torch.cuda.current_stream().cuda_stream, n, False))
    same("at the call number's wrap", sparse, c)
    same("the call after the wrap", b, kb)


def stale_scratch(torch, scratch):
    """Set a compact_positions scratch to the last call number before the
    wrap (2^30 - 1, tile counter 0) with every status word inclusive, tagged
    with number 1 and a wrong count."""
    torch.cuda.synchronize()
    scratch[0] = (1 << 30) - 1
    scratch[1:] = (((1 << 2) | 2) << 32) | 12345


def check_sorted(torch, pg, s, mask, cases):
    gen = torch.Generator(device="cuda").manual_seed(5)
    keep = int(mask.sum())
    _, idx = pg.compact_positions(mask[:s], keep)  # a real compaction
    planes8 = [torch.randint(-(1 << 31), (1 << 31) - 1, (s,), device="cuda",
                             dtype=torch.int64, generator=gen).to(torch.int32)
               for _ in range(8)]
    # after the three full-size cases: q6's shape at scale factor 1 (7 planes,
    # 2 % of the rows kept), q4's width (3 planes), and a sparse index set of
    # about a thousand survivors of the whole table
    few = idx[:: max(keep // 1024, 1)].contiguous()
    for c, idx in ((1, idx), (2, idx), (8, idx), (7, idx[:: 26].contiguous()),
                   (3, idx), (2, few)):
        distinct = int(torch.unique_consecutive(idx.clamp(0, s - 1)).numel())
        sectors = sector_count(torch, idx.clamp(0, s - 1), 4)
        n = int(idx.numel())
        planes = planes8[:c]
        got = pg.gather_sorted_planes(planes, idx)
        want = pg.gather_sorted_planes_plain(planes, idx)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        stacked = torch.stack(planes)
        idx64 = idx.to(torch.int64).clamp(0, s - 1)
        ms = time_ms(torch, lambda: pg.gather_sorted_planes(planes, idx))
        dev = device_ms(torch, lambda: pg.gather_sorted_planes(planes, idx))
        plain = time_ms(torch, lambda: pg.gather_sorted_planes_plain(planes, idx), 3)
        lib = time_ms(torch, lambda: torch.index_select(stacked, 1, idx64), 5)
        lib_dev = device_ms(torch, lambda: torch.index_select(stacked, 1, idx64))
        cases.append(case_entry(
            "gather_sorted", f"s={s} n={n} C={c}", err, ms, dev, plain, lib,
            lib_dev, 4 * n + 4 * c * n + 4 * c * distinct))
        # the sector floor: the card moves whole 32-byte sectors
        cases[-1]["floor_ms"] = ((4 * n + 4 * c * n + 32 * c * sectors)
                                 / HBM_BYTES_PER_S * 1e3)
        if err:
            fail(f"gather_sorted differs from plain version (C={c}, n={n})")
    # a 64-bit column as one 8-byte plane, unsorted + out-of-range idx
    wide = torch.randint(-(1 << 62), 1 << 62, (s,), device="cuda", generator=gen)
    ridx = torch.randint(-5, s + 5, (1 << 20,), device="cuda", generator=gen).to(torch.int32)
    ridx[-1] = pg.SENTINEL
    got = pg.take_fast(wide, ridx, monotone=True)
    want = wide[ridx.to(torch.int64).clamp(0, s - 1)]
    if not torch.equal(got, want):
        fail("take_fast wrong for int64 / unsorted / out-of-range idx")
    check_gather_edges(torch, pg, s, cases)


# the gathers' planes: one of each width, in the order of GATHER_DTYPES
GATHER_DTYPES = ("bool", "int8", "uint8", "int16", "int32", "float32",
                 "int64", "float64")


def gather_planes(torch, gen, s, dtypes=GATHER_DTYPES):
    """One plane of s random elements of each dtype named."""
    out = []
    for name in dtypes:
        dt = getattr(torch, name)
        if dt == torch.bool:
            out.append(torch.rand(s, device="cuda", generator=gen) < 0.5)
        elif dt.is_floating_point:
            out.append(torch.randn(s, device="cuda", generator=gen).to(dt))
        else:
            bits = 8 * dt.itemsize
            lo = 0 if dt == torch.uint8 else -(1 << (bits - 1))
            hi = (1 << bits if dt == torch.uint8 else 1 << (bits - 1)) - 1
            out.append(torch.randint(lo, hi, (s,), device="cuda",
                                     generator=gen, dtype=torch.int64).to(dt))
    return out


def check_gather_edges(torch, pg, s_big, cases):
    """K1 and K2 on the edges of their contracts, each call bit for bit
    against its plain version (recorded in `cases` without times): every
    width alone and all eight in one call; s = 1, 16,384 and K1's plane
    groups past 227 KB (two and eight 8-byte planes at s = 16,384), K1's
    direct form (few rows) and staged form (many); n = 0 and n = 1; planes,
    idx and outputs that start at an odd element (not 16-byte aligned);
    out-of-range and SENTINEL indices; K2 given unsorted indices (a wrong
    monotone hint); a bool output stays 0/1 bytes."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    kernels = (("gather_chunked", pg.gather_chunked_planes,
                pg.gather_chunked_planes_plain),
               ("gather_sorted", pg.gather_sorted_planes,
                pg.gather_sorted_planes_plain))

    def idx_for(s, n, sort):
        i = torch.randint(-3, s + 3, (n,), device="cuda", generator=gen)
        if n > 2:
            i[n // 2] = pg.SENTINEL
        i = i.to(torch.int32)
        return torch.sort(i).values if sort else i

    def same(name, label, kernel, plain, planes, idx, outs=None):
        got = kernel(planes, idx, outs=outs)
        want = plain(planes, idx)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        for g in got:
            if g.dtype == torch.bool and g.numel() and int(
                    g.view(torch.uint8).max()) > 1:
                fail(f"{name} {label}: a bool output holds a byte above 1")
        cases.append({"name": name, "shape": f"edge: {label}",
                      "max_abs_err": err})
        if err:
            fail(f"{name} differs from plain version ({label})")

    for name, kernel, plain in kernels:
        sort = name == "gather_sorted"
        for s, n in ((1, 1000), (16_384, 1 << 20), (16_384, 100), (4_000, 7)):
            idx = idx_for(s, n, sort)
            every = gather_planes(torch, gen, s)
            for p, dt in zip(every, GATHER_DTYPES):
                same(name, f"s={s} n={n} {dt}", kernel, plain, [p], idx)
            same(name, f"s={s} n={n} all eight widths", kernel, plain, every,
                 idx)
        for c in (2, 8):  # 8-byte planes of 128 KB: K1 in c groups
            planes = gather_planes(torch, gen, 16_384, ("int64",) * c)
            same(name, f"s=16384 n={1 << 20} C={c} int64", kernel, plain,
                 planes, idx_for(16_384, 1 << 20, sort))
        planes = gather_planes(torch, gen, 5_000, ("bool", "int64", "int16"))
        for n in (0, 1):
            same(name, f"s=5000 n={n}", kernel, plain, planes,
                 idx_for(5_000, n, sort))
        # views that start at an odd element: planes (no bulk staging), idx
        # (no 16-byte index loads) and outputs (no whole-quad stores)
        wide = gather_planes(torch, gen, 5_001, ("int32", "int64", "bool"))
        odd = [p[1:] for p in wide]
        idx = idx_for(5_000, 100_001, sort)[1:]
        same(name, "odd views of planes and idx", kernel, plain, odd, idx)
        bufs = [torch.empty(100_001, dtype=p.dtype, device="cuda")
                for p in odd]
        same(name, "odd views of the outputs", kernel, plain, odd, idx,
             outs=[b[1:] for b in bufs])
    # K2 given unsorted indices: the hint is wrong, the values are not
    planes = gather_planes(torch, gen, s_big, ("int64", "bool", "float32"))
    same("gather_sorted", f"s={s_big} unsorted (wrong monotone hint)",
         pg.gather_sorted_planes, pg.gather_sorted_planes_plain, planes,
         idx_for(s_big, 1 << 20, False))
    idx = idx_for(s_big, 4096, False)
    got = pg.take_fast_multi(planes, idx, monotone=True)
    if max_abs_err(torch, got, pg.gather_sorted_planes_plain(planes, idx)):
        fail("take_fast_multi with a wrong monotone hint differs")


def check_chunked(torch, pg, n, cases):
    gen = torch.Generator(device="cuda").manual_seed(7)
    # the last two cases are the shapes that q14 (part-type dictionary probe)
    # and q3 (a 10-row result over a compacted build side) pass at scale
    # factor 1, as listed by lingodb_tpu_torch/tools/threshold_bench.py
    for s, c, n in ((25, 1, n), (10_000, 1, n), (16_384, 1, n), (10_000, 2, n),
                    (150, 1, 75_029), (11_268, 6, 10)):
        planes = [torch.randint(-(1 << 31), (1 << 31) - 1, (s,), device="cuda",
                                dtype=torch.int64, generator=gen).to(torch.int32)
                  for _ in range(c)]
        idx = torch.randint(0, s, (n,), device="cuda", generator=gen).to(torch.int32)
        got = pg.gather_chunked_planes(planes, idx)
        want = pg.gather_chunked_planes_plain(planes, idx)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        stacked = torch.stack(planes)
        idx64 = idx.to(torch.int64)
        ms = time_ms(torch, lambda: pg.gather_chunked_planes(planes, idx))
        dev = device_ms(torch, lambda: pg.gather_chunked_planes(planes, idx))
        plain = time_ms(torch, lambda: pg.gather_chunked_planes_plain(planes, idx), 3)
        lib = time_ms(torch, lambda: torch.index_select(stacked, 1, idx64), 5)
        lib_dev = device_ms(torch, lambda: torch.index_select(stacked, 1, idx64))
        cases.append(case_entry("gather_chunked", f"s={s} n={n} C={c}", err, ms,
                                dev, plain, lib, lib_dev,
                                4 * n + 4 * c * n + 4 * c * s))
        if err:
            fail(f"gather_chunked differs from plain version (s={s}, C={c})")
    table = torch.arange(100, device="cuda", dtype=torch.int32)
    idx = torch.tensor([-5, 0, 99, 150], device="cuda", dtype=torch.int32)
    if pg.gather_chunked_i32(table, idx).tolist() != [0, 0, 99, 99]:
        fail("gather_chunked does not clamp out-of-range indices")


def check_segscan(torch, pg, n, cases):
    """segscan at the kernel bench's shape (two planes, runs of 4) and with
    one run over the whole array (the carry crosses every tile), bit for bit
    against the plain version. Its times come from the kernel bench. Then
    the edges of the one-pass design: n below one tile and at a tile's
    edges, every row a head, runs longer than a tile (a look-back past
    tiles without a head), W = 1, 3, 8 and 9 (two launches), a strided
    plane, sums that wrap int32, and two calls back to back on one stream
    with different n (no status word of the first may read as ready in the
    second)."""
    from lingodb_tpu_torch.ops import cuda_build

    gen = torch.Generator(device="cuda").manual_seed(11)

    def check(label, gid, vals):
        got = pg.segscan_i32(gid, vals)
        err = max_abs_err(torch, got, pg.segscan_i32_plain(gid, vals))
        cases.append({"name": "segscan", "shape": f"n={gid.numel()} "
                      f"W={len(vals)} {label}", "max_abs_err": err})
        if err:
            fail(f"segscan differs from plain version ({label}, "
                 f"n={gid.numel()}, W={len(vals)})")
        return got

    def rand(lo, hi, size):
        return torch.randint(lo, hi, (size,), device="cuda", generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def runs(size, p_head):
        """sorted gid whose runs start where a coin with p_head comes up"""
        heads = torch.rand(size, device="cuda", generator=gen) < p_head
        return torch.cumsum(heads.to(torch.int32), 0, dtype=torch.int32)

    v1 = rand(-1000, 1000, n)
    ones = torch.ones(n, device="cuda", dtype=torch.int32)
    for label, gid in (("runs of 4", torch.arange(n, device="cuda",
                                                  dtype=torch.int32) // 4),
                       ("one run", torch.zeros(n, device="cuda",
                                               dtype=torch.int32))):
        got = check(label, gid, [v1, ones])
    if int(got[1][-1]) != n:
        fail("segscan: one run over the whole array does not count every row")
    tile = cuda_build.lib("segscan").ldb_segscan_tile
    for w in (2, 3):
        for size in (1000, tile(w) - 1, tile(w), tile(w) + 1):
            check("runs of ~3 at a tile's edge", runs(size, 0.3),
                  [rand(-(1 << 31), (1 << 31) - 1, size) for _ in range(w)])
    check("every row a head", torch.arange(n, device="cuda", dtype=torch.int32),
          [v1, ones])
    planes9 = [rand(-(1 << 31), (1 << 31) - 1, n) for _ in range(9)]
    for w in (1, 3, 8, 9):
        check("runs of ~4", runs(n, 0.25), planes9[:w])
    long_runs = runs(n, 1 / 5000)  # most tiles hold no head
    for w in (2, 8):
        check("runs of ~5000", long_runs, planes9[:w])
    wide = torch.randint(-(1 << 62), 1 << 62, (n,), device="cuda", generator=gen)
    limbs = wide.view(torch.int32)  # the two limbs of each int64, stride 2
    check("strided limb planes", long_runs, [limbs[0::2], limbs[1::2], v1])
    check("sums that wrap int32", runs(n, 1 / 300),
          [rand((1 << 31) - 100_000, (1 << 31) - 1, n),
           rand(-(1 << 31), -(1 << 31) + 100_000, n)])
    # back to back, no synchronisation between the calls
    gid_a, gid_b = runs(n, 1 / 5000), runs(n - 12_345, 1 / 5000)
    vals_a, vals_b = planes9[:2], [p[: n - 12_345] for p in planes9[2:4]]
    got_a, got_b = pg.segscan_i32(gid_a, vals_a), pg.segscan_i32(gid_b, vals_b)
    for label, gid, vals, got in (("back to back, first", gid_a, vals_a, got_a),
                                  ("back to back, second", gid_b, vals_b, got_b)):
        err = max_abs_err(torch, got, pg.segscan_i32_plain(gid, vals))
        cases.append({"name": "segscan", "shape": f"n={gid.numel()} W=2 {label}",
                      "max_abs_err": err})
        if err:
            fail(f"segscan differs from plain version ({label})")


def sublane_band_edges():
    """The tallest table of each form of sublane_gather, from the built
    library (csrc/tile_gather.cu's ldb_sublane_band_edges)."""
    import ctypes

    from lingodb_tpu_torch.ops import cuda_build

    fn = cuda_build.lib("tile_gather").ldb_sublane_band_edges
    edges = (ctypes.c_int64 * 16)()
    return [int(e) for e in edges[: fn(edges, 16)]]


def check_substrate_edges(torch, sb):
    """The substrate kernels at small shapes on the edges of their
    contracts, bit for bit against their plain versions: index arrays that
    are not 16-byte aligned or a multiple of four long, indices out of
    range (clamped, or taken modulo 128), gather_shift's tables at each
    change of form (check_gather_shift_edges), sublane_gather's tables at
    each change of band width, sums that wrap in int32, and
    one-hot tiles whose lane 0 is all ones (the last row is dropped) or all
    zeros (every row goes to slot 0); for onehot_compact's 32-row segments,
    runs that cross every segment edge or end on one, each pattern alone as
    a single tile and all together, and the 60M-element bench's tile
    count."""
    gen = torch.Generator(device="cuda").manual_seed(13)

    def rand(lo, hi, shape):
        return torch.randint(lo, hi, shape, device="cuda", generator=gen,
                             dtype=torch.int64).to(torch.int32)

    def same(label, got, want):
        torch.cuda.synchronize()
        if max_abs_err(torch, [got], [want]):
            fail(f"substrate edge case differs from plain version: {label}")

    for s in (1000, sb.SMALL_TABLE_LIMIT):
        table = rand(-(1 << 31), (1 << 31) - 1, (s,))
        idx = rand(-3, s + 3, (100_003,))
        for label, i in (("aligned", idx[:100_000]), ("unaligned", idx[1:]),
                         ("seven", idx[1:8])):
            same(f"gather_small S={s} {label}", sb.gather_small(table, i),
                 sb.table_gather_plain(table, i))
    check_gather_shift_edges(torch, sb, rand, same)
    d = rand(-(1 << 31), (1 << 31) - 1, (3000, 128))
    lanes = rand(-300, 300, (3000, 128))
    same("lane_gather, l outside [0, 128)", sb.lane_gather(d, lanes),
         sb.lane_gather_plain(d, lanes))
    # sublane_gather: R = 1, the last R of each form and the first of the
    # next, as the built library gives them (the direct form up to 64 rows,
    # bands of W = 128 ... 8, a partial band of 8 while two fifths of the
    # table fit and the rows fill the card, then the direct form), R =
    # 16,384; row counts that no split divides, m = 1, and row indices out
    # of range
    last = sublane_band_edges()
    if len(last) != 7 or last != sorted(last):
        fail(f"sublane_gather's form edges out of order: {last}")
    edges = {1, 8, 300, 16_384} | set(last) | {r + 1 for r in last}
    for r in sorted(edges):
        tab = rand(-(1 << 31), (1 << 31) - 1, (r, 128))
        ms = (1, 1001, 3 * r + 5)
        if r > last[-2]:  # a partial band: rows enough for every SM
            ms += (64_003,)
        for m in ms:
            rows = rand(-2, r + 2, (m, 128))
            rows[0, :4] = torch.tensor([-(1 << 31), (1 << 31) - 1, r, -1],
                                       dtype=torch.int32)
            same(f"sublane_gather R={r} m={m}", sb.sublane_gather(tab, rows),
                 sb.sublane_gather_plain(tab, rows))
    near = rand((1 << 31) - 1000, (1 << 31) - 1, (33, 128))
    same("lane_rotsum wrapping", sb.lane_rotsum(near), sb.lane_rotsum_plain(near))
    x = rand(0, 1 << 15, (4 * sb.TILE_ROWS, 128))
    m = (torch.rand((4 * sb.TILE_ROWS, 128), device="cuda", generator=gen)
         < 0.2).to(torch.int32)
    m[: sb.TILE_ROWS, 0] = 1                      # tile 0: lane 0 all ones
    m[sb.TILE_ROWS: 2 * sb.TILE_ROWS, 0] = 0      # tile 1: lane 0 all zeros
    m[3 * sb.TILE_ROWS - 1, :] = 1                # tile 2: last row all set
    same("onehot_compact edge tiles", sb.onehot_compact(x, m),
         sb.onehot_compact_plain(x, m))
    # the kernel's 32-row segments: per tile, the rows where lane 0 is set
    heads = {"runs crossing every segment edge": [0, 20, 50, 90, 120, 150,
                                                  170, 200, 230],
             "runs ending on segment edges": list(range(32, 256, 32)),
             "one run of 255 rows, then the last row": [255],
             "heads at rows 31 and 32": [31, 32],
             "lane 0 all ones": list(range(256)),
             "lane 0 all zeros": []}
    tiles = len(heads)
    x = rand(0, 1 << 15, (tiles * sb.TILE_ROWS, 128))
    m = (torch.rand((tiles * sb.TILE_ROWS, 128), device="cuda", generator=gen)
         < 0.2).to(torch.int32)
    m[:, 0] = 0
    for k, rows in enumerate(heads.values()):
        m[[k * sb.TILE_ROWS + r for r in rows], 0] = 1
    for k, label in enumerate(heads):
        one = slice(k * sb.TILE_ROWS, (k + 1) * sb.TILE_ROWS)
        same(f"onehot_compact single tile, {label}",
             sb.onehot_compact(x[one], m[one]), sb.onehot_compact_plain(x[one], m[one]))
    same("onehot_compact segment edges, all tiles", sb.onehot_compact(x, m),
         sb.onehot_compact_plain(x, m))
    # the tile count of the 60M-element bench
    rows = 60_000_000 // (sb.TILE_ROWS * 128) * sb.TILE_ROWS
    x = rand(0, 1 << 15, (rows, 128))
    m = (torch.rand((rows, 128), device="cuda", generator=gen) < 0.2).to(torch.int32)
    same(f"onehot_compact {rows // sb.TILE_ROWS} tiles", sb.onehot_compact(x, m),
         sb.onehot_compact_plain(x, m))


def check_gather_shift_edges(torch, sb, rand, same):
    """gather_shift at S = 1, on each side of the built library's edges
    (the last table the staged form holds whole and the first it holds in
    part, the last it takes and the first of the L2 form), S = 2^16 and
    2^21, and S that are not a multiple of 4; each with n = 100,000, an
    unaligned n = 100,002, n = 7 aligned and not, n = 1, and fewer indices
    than the grid has blocks (blocks with no index); indices out of range,
    INT32_MIN and INT32_MAX among them; then a table that is not 16-byte
    aligned (staged by loads, not bulk copies)."""
    edges = sb.gather_shift_edges()
    plans = [sb.gather_shift_plan(s, 100_000)
             for e in edges for s in (e, e + 1)]
    got = [(p["form"], p["held"]) for p in plans]
    if (len(edges) != 2 or edges != sorted(edges)
            or got[:3] != [("staged", edges[0]), ("staged", edges[0]),
                           ("staged", edges[0])] or got[3][0] != "l2"):
        fail(f"gather_shift's form edges {edges} give launches {got}")
    sizes = ({1, 5000, 1 << 16, (1 << 16) + 3, 300_001, 1 << 21} | set(edges)
             | {e + 1 for e in edges})
    for s in sorted(sizes):
        table = rand(-(1 << 31), (1 << 31) - 1, (s,))
        idx = rand(-3, s + 3, (100_003,))
        idx[:2] = torch.tensor([-(1 << 31), (1 << 31) - 1], dtype=torch.int32)
        plan = sb.gather_shift_plan(s, 100_000)
        few = max(1, plan["blocks"] // 2)
        for label, i in (("aligned", idx[:100_000]), ("unaligned", idx[1:]),
                         ("seven", idx[:7]), ("seven unaligned", idx[1:8]),
                         ("one", idx[:1]),
                         (f"{few} indices, {plan['blocks']} blocks", idx[:few])):
            same(f"gather_shift S={s} ({plan['form']}, {plan['held']} held) "
                 f"{label}", sb.gather_shift(table, i),
                 sb.table_gather_plain(table, i))
    table = rand(-(1 << 31), (1 << 31) - 1, ((1 << 16) + 1,))[1:]
    idx = rand(-3, (1 << 16) + 3, (100_000,))
    same("gather_shift S=65536, table not 16-byte aligned",
         sb.gather_shift(table, idx), sb.table_gather_plain(table, idx))


def checked_kernel_calls(torch, pg, shapes: list):
    """Within the block every call of the three engine kernels' wrappers is
    followed by its plain version on the very same inputs and must equal it
    bit for bit (the padding tail included); each call's kernel and shape
    is appended to `shapes`."""
    import contextlib

    def compact(kernel, plain):
        def call(mask, k):
            cnt, pos = kernel(mask, k)
            cnt_p, pos_p = plain(mask, k)
            err = max_abs_err(torch, [pos], [pos_p])
            if int(cnt) != int(cnt_p) or err:
                fail(f"compact_positions differs from plain version on the "
                     f"fused path (n={mask.numel()}, k={k})")
            shapes.append(("compact_positions", f"n={mask.numel()} k={k} "
                           f"count={int(cnt)}"))
            return cnt, pos
        return call

    def gather(name, kernel, plain):
        def call(tables, idx, outs=None):
            got = kernel(tables, idx, outs=outs)
            want = plain(tables, idx)
            if max_abs_err(torch, [g.reshape(-1) for g in got],
                           [w.reshape(-1) for w in want]):
                fail(f"{name} differs from plain version on the fused path "
                     f"(s={tables[0].shape[0]}, n={idx.numel()})")
            shapes.append((name, f"s={tables[0].shape[0]} n={idx.numel()} "
                           f"C={len(tables)}"))
            return got
        return call

    @contextlib.contextmanager
    def block():
        # the checked calls read counts to the host: the fused programs run
        # as they are called (a graph's replay calls no wrapper)
        from lingodb_tpu_torch.runtime import exestore

        old_capture, exestore.CAPTURE = exestore.CAPTURE, False
        orig = (pg.compact_positions, pg.gather_sorted_planes,
                pg.gather_chunked_planes)
        pg.compact_positions = compact(orig[0], pg.compact_positions_plain)
        pg.gather_sorted_planes = gather("gather_sorted", orig[1],
                                         pg.gather_sorted_planes_plain)
        pg.gather_chunked_planes = gather("gather_chunked", orig[2],
                                          pg.gather_chunked_planes_plain)
        try:
            yield
        finally:
            (pg.compact_positions, pg.gather_sorted_planes,
             pg.gather_chunked_planes) = orig
            exestore.CAPTURE = old_capture

    return block()


def topk_chain_phase(torch, pg, ex, gpu_profile, gpu, cpu, launches,
                     cpu_rows) -> dict:
    """Phase 4b (see the module docstring). Returns the checked kernel calls
    made inside the fused chain, by kernel."""
    sqls = {q: open(f"queries/tpch/{q}.sql").read() for q in TOPK_CHAIN_QUERIES}
    seen = set()
    names = {"_try_fused_topk": "topk", "_try_fused_chain": "chain"}
    orig = {name: getattr(ex.Executor, name) for name in names}

    def spy(name):
        def call(self, *a, **k):
            r = orig[name](self, *a, **k)
            if r is not None:
                seen.add(names[name])
            return r
        return call

    for name in names:
        setattr(ex.Executor, name, spy(name))
    engaged = {"cpu": {"topk": [], "chain": []}, "gpu": {"topk": [], "chain": []}}
    try:
        gpu.stage_cache.clear()
        cpu.stage_cache.clear()
        for where, sess in (("cpu", cpu), ("gpu", gpu)):
            pg.reset_counters()  # the card's first runs: the path's launches
            for q in TOPK_CHAIN_QUERIES:
                seen.clear()
                rows = sess.sql(sqls[q]).format_rows()
                for kind in seen:
                    engaged[where][kind].append(q)
                if where == "cpu":
                    cpu_rows[q] = rows
                elif rows != cpu_rows[q]:
                    fail(f"q{q} [topk/chain, fused]: GPU rows differ from the "
                         f"CPU session's\ngpu={rows[:3]}\ncpu={cpu_rows[q][:3]}")
            if where == "gpu":
                torch.cuda.synchronize()
                launches["topk_chain"] = dict(pg.LAUNCHES)
    finally:
        for name, fn in orig.items():
            setattr(ex.Executor, name, fn)
    log(f"# topk/chain engaged on the card: {json.dumps(engaged['gpu'])}; on "
        f"the CPU session: {json.dumps(engaged['cpu'])}")
    if engaged["gpu"] != engaged["cpu"]:
        fail("topk/chain: the card engaged the fused TopK / chain on other "
             "queries than the CPU session")
    if not engaged["gpu"]["topk"] or not engaged["gpu"]["chain"]:
        fail(f"topk/chain: a fused path never engaged: {engaged['gpu']}")
    log(f"# main path launches [topk_chain] (first runs): "
        f"{json.dumps(launches['topk_chain'])}")
    for path in ("fused", "eager"):
        label = "fused" if path == "fused" else "declined"
        with gpu_profile.path_context(path):
            for q in TOPK_CHAIN_QUERIES:
                if path == "eager" and gpu.sql(sqls[q]).format_rows() != cpu_rows[q]:
                    fail(f"q{q} [topk/chain, declined]: GPU rows differ from "
                         "the CPU session's")
                pg.reset_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = gpu.sql(sqls[q]).format_rows()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = dict(pg.LAUNCHES)
                syncs, peak, _resident = gpu_profile.syncs_and_peak(
                    torch, lambda: gpu.sql(sqls[q]).format_rows())
                if rows != cpu_rows[q]:
                    fail(f"q{q} [topk/chain, {label}]: second run differs from "
                         "the CPU session's")
                log(f"# topk/chain q{q} [{label}]: rows={len(rows)} "
                    f"wall_ms={ms:.2f} (second run) launches={json.dumps(counts)} "
                    f"syncs={syncs} peak_mib={peak / 2**20:.1f}")
    # every chain once more from a clean cache (calibration, then its tail),
    # each kernel call held against its plain version on the same inputs;
    # the calls inside the chain's program and finish are its own, those
    # inside its spine (fused.run_spine) are not its tail's
    from lingodb_tpu_torch.runtime import fused as F

    shapes: list = []
    ranges = {"chain": [], "spine": []}
    wrapped = []
    for owner, name, kind in ((ex.Executor, "_fused_chain_program", "chain"),
                              (ex.Executor, "_finish_fused_chain", "chain"),
                              (F, "run_spine", "spine")):
        fn = getattr(owner, name)
        wrapped.append((owner, name, fn))

        def marked(*a, _fn=fn, _kind=kind, **k):
            start = len(shapes)
            try:
                return _fn(*a, **k)
            finally:
                ranges[_kind].append(range(start, len(shapes)))

        setattr(owner, name, marked)
    gpu.stage_cache.clear()
    try:
        with checked_kernel_calls(torch, pg, shapes):
            for q in TOPK_CHAIN_QUERIES:
                if gpu.sql(sqls[q]).format_rows() != cpu_rows[q]:
                    fail(f"q{q} [topk/chain, checked]: GPU rows differ from "
                         "the CPU session's")
    finally:
        for owner, name, fn in wrapped:
            setattr(owner, name, fn)
    in_chain = sorted({i for r in ranges["chain"] for i in r})
    spine = {i for r in ranges["spine"] for i in r}
    log("# chain kernel calls (each equal to its plain version): "
        + ("; ".join(f"{'spine' if i in spine else 'tail'}: {shapes[i][0]} "
                     f"{shapes[i][1]}" for i in in_chain) or "none"))
    tail = {shapes[i][0] for i in in_chain if i not in spine}
    if not tail & set(CHAIN_TAIL):
        fail(f"the fused chain's tail launched none of {CHAIN_TAIL}")
    checked: dict = {}
    for i in in_chain:
        checked[shapes[i][0]] = checked.get(shapes[i][0], 0) + 1
    return checked


def q6_numpy(tables) -> str:
    import numpy as np

    li = tables["lineitem"]
    ship = np.asarray(li.column("l_shipdate").data)
    disc = np.asarray(li.column("l_discount").data)
    qty = np.asarray(li.column("l_quantity").data)
    price = np.asarray(li.column("l_extendedprice").data)
    lo = (np.datetime64("1994-01-01") - np.datetime64("1970-01-01")).astype(int)
    hi = (np.datetime64("1995-01-01") - np.datetime64("1970-01-01")).astype(int)
    m = (ship >= lo) & (ship < hi) & (disc >= 5) & (disc <= 7) & (qty < 2400)
    v = int((price[m].astype(np.int64) * disc[m].astype(np.int64)).sum())
    return f"{v // 10000}.{v % 10000:04d}"


# ---- phase 9: the executor slice (out-of-core aggregate, window functions,
# WITH RECURSIVE, the chunked non-equi join, sql_many and device LIKE)
BIG_BUDGET = 1 << 30  # the out-of-core runs' system.device_byte_budget
SMALL_BUDGET = 64 << 20  # phase 9 (a'): chunks of 2^18 rows for q1
BIG_WIDTH = {"1": 44, "6": 28}  # bytes a row of the columns q1 / q6 scan
WINDOW_QUERIES = {
    "ranking": "select sum(rn), sum(rk), sum(drk), max(rn) from (select "
               "row_number() over (partition by o_custkey order by "
               "o_orderdate, o_orderkey) rn, rank() over (partition by "
               "o_custkey order by o_orderdate) rk, dense_rank() over "
               "(partition by o_custkey order by o_orderdate) drk from "
               "orders) x",
    "running_sum": "select sum(s), count(*) from (select sum(o_totalprice) "
                   "over (partition by o_custkey order by o_orderdate) s "
                   "from orders) x",
    "rows_sum_avg": "select sum(s), sum(a) from (select sum(l_quantity) over "
                    "(partition by l_suppkey order by l_shipdate, l_orderkey, "
                    "l_linenumber rows between 3 preceding and current row) "
                    "s, avg(l_extendedprice) over (order by l_orderkey, "
                    "l_linenumber rows between 2 preceding and 2 following) a "
                    "from lineitem) x",
    "minmax_sparse": "select sum(m), sum(x) from (select min(l_extendedprice) "
                     "over (order by l_orderkey, l_linenumber rows between 10 "
                     "preceding and 10 following) m, max(l_extendedprice) "
                     "over (partition by l_returnflag order by l_shipdate, "
                     "l_orderkey, l_linenumber rows between 100 preceding and "
                     "27 following) x from lineitem) y",
    "lag_lead_nth": "select sum(o_orderkey - coalesce(prev, 0)), count(nxt), "
                    "count(n3), sum(n3) from (select o_orderkey, "
                    "lag(o_orderkey) over (partition by o_custkey order by "
                    "o_orderkey) prev, lead(o_orderkey, 2) over (partition by "
                    "o_custkey order by o_orderkey) nxt, nth_value(o_orderkey, "
                    "3) over (partition by o_custkey order by o_orderkey) n3 "
                    "from orders) z",
}
RECURSIVE_QUERIES = {
    # UNION (semi-naive): 100,000 new keys a round for 10 rounds
    "union_fixpoint": "with recursive r(v) as (select c_custkey from customer "
                      "where c_custkey <= 100000 union select v + 100000 "
                      "from r where v < 1000000) select count(*), sum(v), "
                      "max(v) from r",
    # UNION ALL counter over the orders of 1992, ten rounds
    "union_all_counter": "with recursive t(k, d) as (select o_orderkey, 0 "
                         "from orders where o_orderdate < date '1993-01-01' "
                         "union all select k + 1, d + 1 from t where d < 9) "
                         "select d, count(*), sum(k) from t group by d "
                         "order by d",
}
BAND = "p_retailprice between s_acctbal - 1 and s_acctbal + 1"
NONEQUI_QUERIES = {
    "inner": "select count(*), sum(s_suppkey) from supplier, part where "
             f"p_size < 10 and {BAND}",
    "semi": "select count(*) from supplier where exists (select * from part "
            f"where p_size < 10 and {BAND})",
    "anti": "select count(*) from supplier where not exists (select * from "
            f"part where p_size < 10 and {BAND})",
    "left": "select count(*), count(p_partkey) from supplier left join "
            f"(select p_partkey, p_retailprice from part where p_size < 10) p "
            f"on {BAND}",
    "full": "select count(*), count(s_suppkey), count(p_partkey) from "
            "supplier full outer join (select p_partkey, p_retailprice from "
            f"part where p_size < 10) p on {BAND}",
}
LIKE_QUERIES = ("9", "13", "20")


def run_checked(torch, pg, fn):
    """fn() with every engine kernel call held bit for bit against its plain
    version; returns (fn's result, launches of K1, K2, K3, calls checked)."""
    shapes: list = []
    pg.reset_counters()
    with checked_kernel_calls(torch, pg, shapes):
        out = fn()
    torch.cuda.synchronize()
    counts = {"K1": pg.LAUNCHES["gather_chunked"],
              "K2": pg.LAUNCHES["gather_sorted"],
              "K3": pg.LAUNCHES["compact_positions"]}
    return out, counts, len(shapes)


def chunk_layout(rows: int, width: int, budget: int) -> tuple:
    """The chunk rows and count the out-of-core aggregate must choose: a
    power of two, at least 2^18, a third of the budget's rows."""
    m = max(1 << 18, (budget // 3) // width)
    m = 1 << (m.bit_length() - 1)
    return m, -(-rows // m)


def nonequi_numpy(tables) -> dict:
    """The expected rows of NONEQUI_QUERIES (Python values) from the band
    counts: for each
    supplier the parts (p_size < 10) whose price lies within 1.00 of its
    account balance, and for each part whether any supplier does."""
    import numpy as np

    s, p = tables["supplier"], tables["part"]
    acct = np.asarray(s.column("s_acctbal").data).astype(np.int64)
    key = np.asarray(s.column("s_suppkey").data).astype(np.int64)
    size = np.asarray(p.column("p_size").data)
    price = np.sort(np.asarray(p.column("p_retailprice").data)[size < 10]
                    .astype(np.int64))
    cnt = (np.searchsorted(price, acct + 100, "right")
           - np.searchsorted(price, acct - 100, "left"))
    sa = np.sort(acct)
    part_hit = (np.searchsorted(sa, price + 100, "right")
                - np.searchsorted(sa, price - 100, "left")) > 0
    left = int(np.maximum(cnt, 1).sum())
    unmatched_p = int((~part_hit).sum())
    pairs = int(cnt.sum())
    return {
        "inner": [[pairs, int((key * cnt).sum())]],
        "semi": [[int((cnt > 0).sum())]],
        "anti": [[int((cnt == 0).sum())]],
        "left": [[left, pairs]],
        "full": [[left + unmatched_p, left, pairs + unmatched_p]],
        "pairs": len(acct) * len(price),
    }


def out_of_core_part(torch, pg, ldb, gpu_profile, device, sf, seed,
                     slice_launches):
    """Phase 9 (a): q1 and q6 over the lineitem subset at 10x the scale
    factor, streamed at a 1 GiB budget and resident at the default one."""
    from lingodb_tpu_torch.tools import tpchbig
    from lingodb_tpu_torch.utils import settings

    big_sf = 10 * sf
    t0 = time.perf_counter()
    table = tpchbig.generate(big_sf, seed)
    rows = table.num_rows
    log(f"# slice (a) data: lineitem subset sf={big_sf:g}, {rows} rows, "
        f"generated in {time.perf_counter() - t0:.1f}s")
    big = ldb.create_in_memory(device=device)
    tpchbig.install(big, table)
    default_budget = settings.DEVICE_BYTE_BUDGET.get()
    try:
        for q in ("1", "6"):
            sql = open(f"queries/tpch/{q}.sql").read()
            got = {}
            for label, budget in (("chunked", BIG_BUDGET),
                                  ("resident", default_budget)):
                settings.DEVICE_BYTE_BUDGET.set(str(budget))
                big._evict_device_memory()
                big._device_cache.clear()
                big.executor.last_chunked = None
                out, counts, nchk = run_checked(
                    torch, pg, lambda: big.sql(sql).format_rows())
                for k, v in counts.items():
                    slice_launches[k] = slice_launches.get(k, 0) + v
                plan = big.executor.last_chunked
                if label == "chunked":
                    m, chunks = chunk_layout(rows, BIG_WIDTH[q], budget)
                    if plan is None:
                        fail(f"slice (a) q{q}: the chunked aggregate did not "
                             f"engage at a {budget}-byte budget")
                    if (plan["width"], plan["chunk_rows"], plan["chunks"]) != (
                            BIG_WIDTH[q], m, chunks):
                        fail(f"slice (a) q{q}: chunk layout {plan} != width "
                             f"{BIG_WIDTH[q]}, m {m}, {chunks} chunks")
                    if "lineitem" in big._device_cache:
                        fail(f"slice (a) q{q}: the streamed table was uploaded")
                elif plan is not None:
                    fail(f"slice (a) q{q}: the chunked aggregate engaged at "
                         f"the default budget")
                got[label] = out
                # a second run: wall time and peak device memory
                big.executor.last_chunked = None
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                again = big.sql(sql).format_rows()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                if again != out:
                    fail(f"slice (a) q{q} [{label}]: second run differs")
                line = (f"# slice (a) q{q} [{label}, budget {budget}]: "
                        f"rows={len(out)} wall_ms={wall * 1e3:.2f} (second "
                        f"run) launches={json.dumps(counts)} checked={nchk} "
                        f"peak_mib={peak / 2**20:.1f} "
                        f"resident_before_mib={before / 2**20:.1f}")
                if label == "chunked":
                    plan = big.executor.last_chunked
                    alloc = plan["allocated_after_chunk"]
                    if device.type == "cuda" and len(alloc) != plan["chunks"]:
                        fail(f"slice (a) q{q}: {len(alloc)} chunk memory "
                             f"readings for {plan['chunks']} chunks")
                    spread = max(alloc) - min(alloc) if alloc else 0
                    ov = gpu_profile.copy_overlap(
                        torch, lambda: big.sql(sql).format_rows())
                    moved = plan["bytes_copied"]
                    card_rate = ("not measured" if not ov["copy_ms"] else
                                 f"{moved / (ov['copy_ms'] / 1e3) / 1e9:.2f}")
                    hidden = ("not measured" if ov["hidden_share"] is None
                              else f"{ov['hidden_share']:.3f}")
                    line += (f" chunks={plan['chunks']} m={plan['chunk_rows']}"
                             f" host_fill_ms={plan['host_fill_ms']:.2f}"
                             f" bytes_h2d={moved} h2d_gb_s_wall="
                             f"{moved / wall / 1e9:.2f} copy_ms_on_card="
                             f"{fmt_ms(ov['copy_ms'])} h2d_gb_s_card="
                             f"{card_rate} copy_hidden_share={hidden}"
                             f" allocated_after_chunk_spread_mib="
                             f"{spread / 2**20:.1f} bound_mib="
                             f"{(before + budget) / 2**20:.1f}")
                    if peak > before + budget:
                        fail(f"slice (a) q{q}: peak {peak} bytes above the "
                             f"resident {before} plus the budget {budget}")
                    if spread > 64 << 20:
                        fail(f"slice (a) q{q}: device memory grew across "
                             f"chunks: {alloc}")
                log(line)
            if got["chunked"] != got["resident"]:
                fail(f"slice (a) q{q}: chunked rows differ from the resident "
                     f"run's\n{got['chunked'][:2]}\n{got['resident'][:2]}")
            graphs_part(torch, big, q, sql, rows, got["resident"])
    finally:
        settings.DEVICE_BYTE_BUDGET.set(str(default_budget))
        big._evict_device_memory()
        del big, table
        torch.cuda.empty_cache()


def graphs_part(torch, big, q, sql, rows, resident):
    """Phase 9 (a'): the chunk program replayed from one graph a staging
    slot against run as it is called, at the 1 GiB budget and at 64 MiB
    (chunks of 2^18 rows for q1); each from a session that has captured
    nothing for it. Rows equal the resident run's."""
    from lingodb_tpu_torch.tools import outofcore_bench
    from lingodb_tpu_torch.utils import settings

    for budget in (BIG_BUDGET, SMALL_BUDGET):
        settings.DEVICE_BYTE_BUDGET.set(str(budget))
        m, chunks = chunk_layout(rows, BIG_WIDTH[q], budget)
        for captured in (True, False):
            big._evict_device_memory()
            t0 = time.perf_counter()
            # a chunk's launches do not depend on its size: traced at 1 GiB
            # only (at 64 MiB the trace of q1's 229 chunks took 12 s
            # replayed and about 40 s uncaptured; tools/outofcore_bench.py
            # --paths traces both budgets)
            r = outofcore_bench.stream_runs(torch, big, sql, captured,
                                            trace=budget == BIG_BUDGET)
            label = f"slice (a') q{q} [{r['path']}, budget {budget}]"
            if r.pop("rows") != resident or not r["same"]:
                fail(f"{label}: rows differ from the resident run's")
            if (r["chunk_rows"], r["chunks"]) != (m, chunks):
                fail(f"{label}: chunks {r['chunk_rows']} x {r['chunks']} != "
                     f"{m} x {chunks}")
            # a graph is replayed for its own chunk right after its
            # capture on the card (the CPU store's stand-in ran it then)
            slots = min(2, chunks)
            first = chunks if big.device.type == "cuda" else chunks - slots
            want = (slots, first, 0, chunks) if captured else (0, 0, 0, 0)
            got = (r["captures_first"], r["replays_first"],
                   r["captures_second"], r["replays_second"])
            if got != want:
                fail(f"{label}: captures / replays of two runs {got} != "
                     f"{want}")
            per_chunk = ("not traced" if r["launches"] is None
                         else f"{r['launches_per_chunk']:.2f}")
            log(f"# {label}: chunks={chunks} m={m} wall_ms first "
                f"{r['wall_ms_first']:.2f} second {r['wall_ms_second']:.2f} "
                f"launches={r['launches']} launches_per_chunk={per_chunk} "
                f"captures/replays "
                f"first {got[0]}/{got[1]} second {got[2]}/{got[3]} "
                f"host_fill_ms={r['host_fill_ms']:.2f} "
                f"({time.perf_counter() - t0:.1f}s)")
    host_read_part(torch, big, q, sql, resident)
    big._evict_device_memory()


def host_read_part(torch, big, q, sql, resident):
    """Phase 9 (a'): a chunk program that reads the host (here the valid
    count, read by a wrapper) cannot be captured: its capture raises
    HostRead, the plan is marked ("chunked_eager") and streams uncaptured,
    host reads and all; a second run goes straight there. Rows equal the
    resident run's, nothing is captured."""
    from lingodb_tpu_torch.ops import backend as be
    from lingodb_tpu_torch.runtime import executor as ex
    from lingodb_tpu_torch.utils import compilestats, settings

    settings.DEVICE_BYTE_BUDGET.set(str(BIG_BUDGET))
    big._evict_device_memory()
    orig = ex.Executor._chunk_program

    def reads_host(self, *args):
        be.to_host(args[-1])  # the valid count: HostRead under capture
        return orig(self, *args)

    label = f"slice (a') q{q} [host read, budget {BIG_BUDGET}]"
    ex.Executor._chunk_program = reads_host
    try:
        for run in ("first", "second"):
            big.executor.last_chunked = None
            c0 = compilestats.snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = big.sql(sql).format_rows()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            d = compilestats.delta(c0)
            plan = big.executor.last_chunked
            marked = any(isinstance(k, tuple) and k and k[0] == "chunked_eager"
                         for k in big.stage_cache)
            if plan is None or not marked:
                fail(f"{label}: streamed {plan is not None}, marked {marked}")
            if (d["captures"], d["replays"]) != (0, 0):
                fail(f"{label}: captures / replays {d['captures']} / "
                     f"{d['replays']} in the {run} run")
            if out != resident:
                fail(f"{label}: rows differ from the resident run's")
            log(f"# {label}: {run} run streamed uncaptured, "
                f"chunks={plan['chunks']} wall_ms={wall:.2f}, rows equal "
                f"the resident run's")
    finally:
        ex.Executor._chunk_program = orig


# phase 9 (a''): aggregates over a wide decimal that only the host computes
# (a quotient past 18 digits, a host object column in the chunk program)
HOST_DECIMAL_SQL = {
    "sum": "SELECT l_returnflag, sum(l_extendedprice / 7) FROM lineitem "
           "GROUP BY l_returnflag ORDER BY l_returnflag",
    "avg": "SELECT l_returnflag, avg(l_extendedprice / 7) FROM lineitem "
           "GROUP BY l_returnflag ORDER BY l_returnflag",
    "global": "SELECT sum(l_extendedprice / 3) FROM lineitem "
              "WHERE l_quantity < 10",
    "minmax": "SELECT l_returnflag, min(l_extendedprice / 7), "
              "max(l_extendedprice / 7) FROM lineitem "
              "GROUP BY l_returnflag ORDER BY l_returnflag",
    "per_unit": "SELECT l_returnflag, sum(l_extendedprice * 1.0 / l_quantity) "
                "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag",
}
HOST_DECIMAL_BUDGET = 64 << 20


def host_decimal_part(torch, pg, ldb, device, sf, seed, slice_launches,
                      smi_line):
    """Phase 9 (a''): the five HOST_DECIMAL_SQL statements over the lineitem
    subset at the scale factor, streamed at a 64 MiB budget (exact host
    lanes, the plan uncaptured, more than one chunk, the table never
    uploaded whole) against resident at the default budget; rows equal as
    strings. Logs each statement's wall ms both ways, its chunks, the host's
    fill ms and its uncaptured chunk program's ms a chunk (the object
    lanes' work on the host)."""
    from lingodb_tpu_torch.tools import tpchbig
    from lingodb_tpu_torch.utils import compilestats, settings

    t0 = time.perf_counter()
    table = tpchbig.generate(sf, seed)
    log(f"# slice (a'') data: lineitem subset sf={sf:g}, {table.num_rows} "
        f"rows, generated in {time.perf_counter() - t0:.1f}s ({smi_line})")
    big = ldb.create_in_memory(device=device)
    tpchbig.install(big, table)
    default_budget = settings.DEVICE_BYTE_BUDGET.get()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    try:
        for name, sql in HOST_DECIMAL_SQL.items():
            label = f"slice (a'') {name}"
            settings.DEVICE_BYTE_BUDGET.set(str(default_budget))
            big.device_table("lineitem")  # uploaded before the timed run
            big.executor.last_chunked = None
            resident, resident_ms = timed(lambda: big.sql(sql).format_rows())
            if big.executor.last_chunked is not None:
                fail(f"{label}: streamed at the default budget")
            settings.DEVICE_BYTE_BUDGET.set(str(HOST_DECIMAL_BUDGET))
            big._evict_device_memory()
            big._device_cache.clear()
            c0 = compilestats.snapshot()
            (rows, counts, nchk), ms = timed(lambda: run_checked(
                torch, pg, lambda: big.sql(sql).format_rows()))
            d = compilestats.delta(c0)
            for k, v in counts.items():
                slice_launches[k] = slice_launches.get(k, 0) + v
            plan = big.executor.last_chunked
            marked = any(isinstance(k, tuple) and k and k[0] == "chunked_eager"
                         for k in big.stage_cache)
            if plan is None or plan["chunks"] < 2:
                fail(f"{label}: did not stream in more than one chunk: {plan}")
            if not marked or (d["captures"], d["replays"]) != (0, 0):
                fail(f"{label}: marked uncaptured {marked}, captures / "
                     f"replays {d['captures']} / {d['replays']}")
            if "lineitem" in big._device_cache:
                fail(f"{label}: the streamed table was uploaded")
            if rows != resident:
                fail(f"{label}: streamed rows differ from the resident run's"
                     f"\n{rows}\n{resident}")
            log(f"# {label}: rows={len(rows)} wall_ms streamed {ms:.2f} "
                f"resident {resident_ms:.2f} chunks={plan['chunks']} "
                f"m={plan['chunk_rows']} width={plan['width']} "
                f"host_fill_ms={plan['host_fill_ms']:.2f} "
                f"uncaptured_program_ms_a_chunk="
                f"{plan['uncaptured_program_ms'] / plan['chunks']:.2f} "
                f"launches={json.dumps(counts)} checked={nchk} rows equal "
                f"the resident run's ({smi_line})")
    finally:
        settings.DEVICE_BYTE_BUDGET.set(str(default_budget))
        big._evict_device_memory()
        del big, table
        torch.cuda.empty_cache()


FLOAT_REL = 1e-12  # floats of the card against the CPU session's


def same_rows(got, want) -> bool:
    """Rows of Python values (ResultTable.to_pylist) equal, floats within a
    relative FLOAT_REL: a float sum's order differs between the card's
    atomics and the CPU, and the card divides by a scalar through its
    reciprocal, so the last bits may differ; every other value is exact."""
    import math

    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not math.isclose(a, b, rel_tol=FLOAT_REL, abs_tol=0.0):
                    return False
            elif a != b:
                return False
    return True


SQLITE_BIG_ROWS = 30_000  # phase 6 (b)'s CUBE table, at the default tier
# phase 6 (b): INT arithmetic beyond INT's range inside the fused aggregate
# over the SF1 lineitem (l_linenumber 3 to 7), and the same kept in range
# by its restriction
FUSED_ERROR_SQL = ("SELECT l_returnflag, sum(l_linenumber * 1000000000) "
                   "FROM lineitem {}GROUP BY l_returnflag "
                   "ORDER BY l_returnflag")
# host syncs and launches of the main path's queries, by phase (4 and 10),
# printed together before the report
SYNCS: dict = {}


def sqlite_phase(torch, pg, ldb, launches):
    """Phase 6 (b): the statements of tools/sqlite_battery.py (ORDER BY /
    LIMIT / OFFSET after a set operation; grouped string keys with NULLs
    under string functions, set operations, ROLLUP and CUBE; lag / lead,
    ntile, nth_value, substring, replace, concat and NULL literal arguments
    at their edges) on the tensor tier (SMALL_ROWS = 2), and CUBE over two
    keys with NULLs at SQLITE_BIG_ROWS rows at the default SMALL_ROWS. Each
    statement runs on the card with every K1-K3 call checked against its
    plain version and counted, and its rows must equal the CPU session's
    (same_rows) and sqlite3's (ROLLUP and CUBE against their UNION ALL
    expansion; PostgreSQL's result spelled for sqlite3 where the two
    differ; NULLs last when ascending, first when descending, as the engines
    order them). A statement that must raise (sqlite_battery.Raises) raises
    PostgreSQL's words on the card and on the CPU session. Statements
    without an ORDER BY compare as multisets."""
    import sqlite3
    from contextlib import closing

    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.tools import sqlite_battery as sb
    from lingodb_tpu_torch.tools import sqlite_oracle as so

    def row_key(row):
        return tuple((v is None, str(v)) for v in row)

    big = {f"{name}_{SQLITE_BIG_ROWS}": sb.cube_two_keys("big", *keys)
           for name, keys in (("cube_b_d", ("b", "d")),
                              ("cube_d_s", ("d", "s")))}
    groups = [  # (label, SMALL_ROWS, setup, statements, ordered)
        ("setop", 2, sb.SETOP_SETUP,
         {**sb.SETOP_WHOLE_RESULT, **sb.SETOP_UNCHANGED}, True),
        ("null_keys", 2, sb.null_key_setup(), sb.NULL_KEY_STATEMENTS, False),
        ("cube_big", dv.SMALL_ROWS,
         sb.null_key_setup(SQLITE_BIG_ROWS, table="big"), big, False),
        ("semantics", 2, sb.semantics_setup(), sb.SEMANTICS_STATEMENTS, True),
        ("errors", 2, sb.semantics_setup() + sb.errors_setup(),
         sb.ERROR_STATEMENTS, True),
        ("wide", 2, sb.wide_setup(), sb.WIDE_STATEMENTS, True),
        ("mod_cast", 2, sb.mod_cast_setup(), sb.MOD_CAST_STATEMENTS, True),
    ]
    # the exact oracle's tables: decimals as text
    exact_setup = {"wide": sb.wide_setup(sqlite=True),
                   "mod_cast": sb.mod_cast_setup(sqlite=True)}
    tables = iter(range(1 << 30))

    def query(session, sql):
        """A tuple runs its first entries as statements over a fresh table
        {t}, its last as the query."""
        if isinstance(sql, str):
            return session.sql(sql)
        name = f"p6b_{next(tables)}"
        for st in sql[:-1]:
            session.sql_stmt(st.format(t=name))
        return session.sql(sql[-1].format(t=name))

    def raised(session, sql):
        try:
            query(session, sql)
        except Exception as exc:  # the statement must raise
            return exc
        return None

    t0 = time.perf_counter()
    small_rows = dv.SMALL_ROWS
    total = {"K1": 0, "K2": 0, "K3": 0, "C": 0}  # C: checked_arith
    n_stmts = n_checked = 0
    for label, tier, setup, stmts, ordered in groups:
        t_group = time.perf_counter()
        group = {"K1": 0, "K2": 0, "K3": 0, "C": 0}
        dv.SMALL_ROWS = tier  # read when a column is first uploaded
        gpu = ldb.create_in_memory()
        cpu = ldb.create_in_memory(device="cpu")
        with closing(sqlite3.connect(":memory:")) as conn:
            exact = label in exact_setup
            if exact:
                sb.exact_functions(conn)
            for st in setup:
                gpu.sql_stmt(st)
                cpu.sql_stmt(st)
            for st in exact_setup.get(label, setup):
                conn.execute(st)
            for name, (sql, sqlite_sql) in stmts.items():
                if isinstance(sqlite_sql, sb.Raises):
                    exc, counts, nchk = run_checked(
                        torch, pg, lambda: raised(gpu, sql))
                    counts["C"] = pg.LAUNCHES["checked_arith"]
                    want_exc = raised(cpu, sql)
                    if (exc is None or want_exc is None
                            or str(sqlite_sql) not in str(exc)
                            or str(sqlite_sql) not in str(want_exc)):
                        fail(f"phase 6 (b) {name}: {sql} must raise "
                             f"'{sqlite_sql}': card {exc!r}, CPU session "
                             f"{want_exc!r}")
                    for k in total:
                        total[k] += counts[k]
                        group[k] += counts[k]
                    n_stmts += 1
                    n_checked += nchk
                    continue
                res, counts, nchk = run_checked(torch, pg,
                                                lambda: query(gpu, sql))
                counts["C"] = pg.LAUNCHES["checked_arith"]
                got, want = res.to_pylist(), query(cpu, sql).to_pylist()
                if not ordered:
                    got = sorted(got, key=row_key)
                    want = sorted(want, key=row_key)
                if not same_rows(got, want):
                    fail(f"phase 6 (b) {name}: card rows differ from the "
                         f"CPU session's: {sql}\ncard={got[:4]}\n"
                         f"cpu={want[:4]}")
                if exact:
                    ok, msg = sb.exact_equal(
                        sb.exact_rows(res),
                        conn.execute(sqlite_sql).fetchall())
                else:
                    ok, msg = so.rows_equal(
                        so.our_rows(res),
                        so.run_sqlite(conn, sqlite_sql or sql),
                        ordered=ordered)
                if not ok:
                    fail(f"phase 6 (b) {name}: card rows differ from "
                         f"sqlite3's: {sql}: {msg}")
                for k in total:
                    total[k] += counts[k]
                    group[k] += counts[k]
                n_stmts += 1
                n_checked += nchk
        dv.SMALL_ROWS = small_rows
        log(f"# sqlite statements (6 b) {label}: {len(stmts)} statements in "
            f"{time.perf_counter() - t_group:.1f}s, launches (K1, K2, K3, "
            f"C the checked kernel) {json.dumps(group)}")
    if not any(total.values()):
        fail("phase 6 (b): no engine kernel launched")
    launches["p6b"] = {"gather_chunked": total["K1"],
                       "gather_sorted": total["K2"],
                       "compact_positions": total["K3"],
                       "checked_arith": total["C"]}
    log(f"# sqlite statements (6 b): {n_stmts} statements equal on the card, "
        f"the CPU session and sqlite3 in {time.perf_counter() - t0:.1f}s; "
        f"launches (K1, K2, K3, each call checked: {n_checked}; C the "
        f"checked kernel): {json.dumps(total)}")


def fused_error_part(torch, gpu, cpu):
    """Phase 6 (b): FUSED_ERROR_SQL in the fused aggregate over the SF1
    tables. Its first run captures the program and replays it, the next two
    replay it; each must raise PostgreSQL's "integer out of range" after
    the program's packed fetch (the finish raises it, not a read inside
    the program), as the CPU session raises it; the statement kept in range
    gives the CPU session's rows."""
    import traceback

    from lingodb_tpu_torch.ops import scalar as sc
    from lingodb_tpu_torch.runtime.executor import FETCH_FINISHES
    from lingodb_tpu_torch.utils import compilestats

    raising = FUSED_ERROR_SQL.format("")
    kept = FUSED_ERROR_SQL.format("WHERE l_linenumber < 3 ")
    runs = []
    for session in (gpu, gpu, gpu, cpu):
        cs0 = compilestats.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            session.sql(raising)
        except sc.EvalError as exc:
            where = traceback.extract_tb(exc.__traceback__)[-2].name
            if str(exc) != "integer out of range" or where not in (
                    FETCH_FINISHES):
                fail(f"phase 6 (b) fused: {raising} raised {exc!r} in "
                     f"{where}")
        else:
            fail(f"phase 6 (b) fused: {raising} must raise")
        ms = (time.perf_counter() - t0) * 1e3
        d = compilestats.delta(cs0)
        runs.append((ms, d["captures"], d["replays"], d["calibrations"]))
    card = runs[:3]
    if (card[0][1] != 1 or any(r[1] or r[3] for r in card[1:])
            or any(r[2] != 1 for r in card)):
        fail(f"phase 6 (b) fused: captures / replays / calibrations by run "
             f"{[r[1:] for r in card]}: want one capture, then replays")
    for _run in range(2):
        if gpu.sql(kept).to_pylist() != cpu.sql(kept).to_pylist():
            fail(f"phase 6 (b) fused: card rows differ from the CPU "
                 f"session's: {kept}")
    log(f"# sqlite statements (6 b) fused: {raising} raised 'integer out of "
        f"range' after the packed fetch on its captured run and two replays "
        f"(ms {', '.join(f'{r[0]:.2f}' for r in card)}; captures / replays /"
        f" calibrations by run {[r[1:] for r in card]}) and on the CPU "
        f"session; kept in range by l_linenumber < 3, rows equal")


# phase 15 (b): (the statement, whether its first run must run again on
# the exact path); the variance passes int64 where |l_extendedprice -
# 38000.123456| > 3037 (its square at scale 12)
_VARIANCE = ("SELECT l_returnflag, l_linestatus, sum((l_extendedprice - "
             "38000.123456) * (l_extendedprice - 38000.123456)), count(*) "
             "FROM lineitem {}GROUP BY l_returnflag, l_linestatus "
             "ORDER BY l_returnflag, l_linestatus")
WIDE_SQL = {
    "variance_needs_exact": (_VARIANCE.format(""), True),
    "variance_that_fits": (_VARIANCE.format(
        "WHERE l_extendedprice BETWEEN 36000 AND 40000 "), False),
    "bigint_near_2_62": (
        "SELECT l_returnflag, sum(CAST(l_orderkey AS BIGINT) + "
        "4611686018427387904), avg(CAST(l_orderkey AS BIGINT) + "
        "4611686018427387904), count(*) FROM lineitem GROUP BY l_returnflag "
        "ORDER BY l_returnflag", False),
    "q1": (None, False),  # queries/tpch/1.sql
    # C27: l_orderkey * 10^12 fits a BIGINT, rescaled to % 0.0007's scale it
    # passes int64; the remainder fits: the kernel computes it, no re-run
    "mod_past_int64": (
        "SELECT l_returnflag, sum(CAST(l_orderkey AS BIGINT) * 1000000000000 "
        "% 0.0007), count(*) FROM lineitem GROUP BY l_returnflag "
        "ORDER BY l_returnflag", False),
    # C29: a double (a real) cast to DECIMAL, 15 (6) digits, then the scale
    "cast_double": (
        "SELECT l_returnflag, l_linestatus, sum(CAST(CAST(l_extendedprice AS "
        "DOUBLE) * 1.005 AS DECIMAL(15,2))) FROM lineitem GROUP BY "
        "l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus",
        False),
    "cast_real": (
        "SELECT l_returnflag, l_linestatus, sum(CAST(CAST(l_extendedprice * "
        "1.005 AS REAL) AS DECIMAL(15,2))) FROM lineitem GROUP BY "
        "l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus",
        False),
}
# the statements whose every run launches the checked kernel (a % whose
# dividend passes int64 at its scale, a cast from a float)
WIDE_CHECKED = ("mod_past_int64", "cast_double", "cast_real")
INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1


def _edge_pairs():
    """(x, y) rows at the kernel's edges: INT64_MIN and +-(2^63 - 1) with
    small and large partners, products exactly at the bound and one past
    it, and products whose tenth (a rescale by one digit) rounds to the
    bound and across it."""
    b = INT64_MAX
    pairs = [(INT64_MIN, 1), (INT64_MIN, -1), (INT64_MIN, 0), (b, 1),
             (b, -1), (-b, 1), (b, 2), (INT64_MIN, INT64_MIN), (b, b),
             (3037000499, 3037000499), (3037000500, 3037000500),
             (-3037000500, 3037000500), (0, INT64_MIN), (1, b)]
    f = next(d for d in range(2, 100) if b % d == 0)  # 7
    pairs += [(b // f, f), (-(b // f), f), (b // f + 1, f)]
    for tenth in (10 * b + 4, 10 * b + 5, -10 * b - 5, -10 * b - 6):
        y = next(d for d in range(11, 100000)
                 if tenth % d == 0 and abs(tenth // d) <= b)
        pairs.append((tenth // y, y))
    return pairs


def _mod_edge_pairs():
    """(x, y) rows at the edges of a checked %: INT64_MIN % -1, +-(2^63 -
    1) rescaled by 10^18, 999999999999999999 % 0.007 (70 at scale 4),
    remainders of exactly +-(2^63 - 1) (10 at scale 0 is 10^19 at scale
    18), zero divisors."""
    b = INT64_MAX
    return [(INT64_MIN, -1), (b, 7), (-b, 7), (999999999999999999, 70),
            (b, 10), (-b, 10), (INT64_MIN, b), (b, -b), (INT64_MIN, INT64_MIN),
            (5, 0), (0, 0), (INT64_MIN, 0), (1, b), (-7, 2), (7, -2)]


CAST_F_EDGES = [0.285, 1.005, 2.675, -0.125, 0.0, -0.0, 0.004999999999999999,
                0.005, 5e-324, 2.0**53 - 1, 2.0**53 + 2, 9.2e18, -9.2e18,
                9.3e18, -9.3e18, 9.223372036854775e18, 1e19, 99.995, -99.995,
                float("nan"), float("inf"), float("-inf"), 999999999999999.5,
                12345.675]


def graph_ms(torch, fn, reps=10):
    """Card ms of one fn() with no host in between: `reps` calls captured in
    one CUDA graph, its replays timed by CUDA events. (torch.profiler read
    some of the checked kernel's forms as 0 or below their bound.)"""
    fn()
    g, _out, _scratch = capture(torch, lambda: [fn() for _ in range(reps)])
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del g
    return ms


def check_checked_arith(torch, n, cases):
    """Phase 15 (a), see the module docstring: the checked kernel against
    its plain version at n rows; appends the timed cases to `cases`."""
    from lingodb_tpu_torch.ops import checked as ck
    from lingodb_tpu_torch.ops import pgather as pg
    from lingodb_tpu_torch.ops import scalar as sc

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(24)

    def col(top, dtype=torch.int64, big=None):
        """n values in (-top, top); with `big`, one row in a hundred in
        (-big, big) instead (the plain version evaluates the rows near a
        limit in Python ints: few of them keep it quick)."""
        x = torch.randint(-top, top, (n,), generator=gen, device="cuda",
                          dtype=torch.int64)
        if big is not None:
            far = torch.randint(-big, big, (n,), generator=gen,
                                device="cuda", dtype=torch.int64)
            x = torch.where(torch.rand(n, generator=gen, device="cuda")
                            < 0.01, far, x)
        return x.to(dtype)

    def floats(top, dtype, scale=1.0):
        """n doubles in (-top, top), one row in a hundred a price of three
        decimals (a half at the scale of two), as `dtype`."""
        x = (torch.rand(n, generator=gen, device="cuda",
                        dtype=torch.float64) * 2 - 1) * top
        priced = torch.round(x * 1000) / 1000
        x = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.01,
                        priced, x)
        return (x * scale).to(dtype)

    def magnitudes(dtype):
        """n doubles of every magnitude up to 10^16, one row in fifty up to
        10^19 (past 2^52 the plain version takes Python's decimals)."""
        e = torch.where(
            torch.rand(n, generator=gen, device="cuda") < 0.02,
            torch.randint(17, 20, (n,), generator=gen, device="cuda"),
            torch.randint(0, 17, (n,), generator=gen, device="cuda"))
        return ((torch.rand(n, generator=gen, device="cuda",
                            dtype=torch.float64) * 2 - 1)
                * torch.pow(10.0, e.to(torch.float64))).to(dtype)

    edges = _edge_pairs()
    i32 = (-(1 << 31), (1 << 31) - 1)
    i64 = (INT64_MIN, INT64_MAX)
    exact = sc.ERR_EXACT
    num = sc.ERR_NUMERIC
    # (label, op, sx, sy, s, (lo, hi), code, prec, code_prec, dtype, x, y,
    # edge rows: (x, y) pairs, or x values of a cast; digits of cast_f)
    big = 8 * 10**9
    f64, f32 = torch.float64, torch.float32
    specs = [
        ("variance (p - a)^2: DECIMAL scale 6 x 6 -> 12 past int64", "mul",
         6, 6, 12, i64, exact, 0, 0, torch.int64, col(10**9, big=big),
         col(10**9, big=big), edges, 0),
        ("price^3 step: scale 4 x 2 -> 6 past int64", "mul", 4, 2, 6, i64,
         exact, 0, 0, torch.int64, col(10**11, big=10**15),
         col(10**7, big=10**9), edges, 0),
        ("product rounded one digit: scale 3 x 3 -> 5", "mul", 3, 3, 5, i64,
         exact, 0, 0, torch.int64, col(1 << 50, big=1 << 62),
         col(1 << 8), edges, 0),
        ("sum rescaled: scale 2 + 6 -> 6", "add", 2, 6, 6, i64, exact, 0, 0,
         torch.int64, col(10**12, big=10**15), col(1 << 58, big=1 << 62),
         edges, 0),
        ("INT * INT", "mul", 0, 0, 0, i32, sc.ERR_INT, 0, 0, torch.int32,
         col(1 << 15, torch.int32, big=1 << 20), col(1 << 14, torch.int32),
         None, 0),
        ("BIGINT - BIGINT", "sub", 0, 0, 0, i64, sc.ERR_BIGINT, 0, 0,
         torch.int64, col(1 << 58, big=INT64_MAX),
         col(1 << 58, big=INT64_MAX), edges, 0),
        ("cast scale 6 -> DECIMAL(12,2)", "cast", 6, 0, 2, i64, exact, 12,
         sc.ERR_NUMERIC, torch.int64, col(10**14, big=10**15), None,
         [e[0] for e in edges], 0),
        # C27: BIGINT % DECIMAL(p,4), the dividend rescaled by 10^4 past
        # int64 (l_orderkey * 10^12 % 0.0007 in phase 15 (b))
        ("mod: BIGINT % DECIMAL scale 0 % 4 -> 4, dividend past int64",
         "mod", 0, 4, 4, i64, exact, 0, 0, torch.int64,
         col(INT64_MAX), col(10**6), _mod_edge_pairs(), 0),
        ("mod: DECIMAL scale 18 % BIGINT -> 18, divisor rescaled 10^18",
         "mod", 18, 0, 18, i64, exact, 0, 0, torch.int64,
         col(INT64_MAX), col(10, big=INT64_MAX), _mod_edge_pairs(), 0),
        # C29: casts from DOUBLE and REAL, 15 (6) digits, then the scale
        ("cast_f: DOUBLE -> DECIMAL(15,2)", "cast_f", 0, 0, 2, i64, exact,
         15, num, torch.int64, floats(1e5, f64), None, CAST_F_EDGES, 15),
        ("cast_f: REAL -> DECIMAL(15,2)", "cast_f", 0, 0, 2, i64, exact, 15,
         num, torch.int64, floats(1e5, f32), None, CAST_F_EDGES, 6),
        ("cast_f: DOUBLE -> DECIMAL(19,0), magnitudes to 10^19",
         "cast_f", 0, 0, 0, i64, exact, 19, num, torch.int64,
         magnitudes(f64), None, CAST_F_EDGES, 15),
        ("cast_f: DOUBLE -> DECIMAL(4,2)", "cast_f", 0, 0, 2, i64, exact, 4,
         num, torch.int64, floats(90.0, f64), None, CAST_F_EDGES, 15),
    ]
    valid = torch.rand(n, generator=gen, device="cuda") > 0.05
    # the ops whose first form is captured and replayed (add, sub and cast
    # take mul's path through the kernel)
    replayed = {"add", "sub", "cast"}
    for (label, op, sx, sy, s, (lo, hi), code, prec, code_prec, dt, x, y,
         edge_rows, digits) in specs:
        if edge_rows is not None:  # the edges in the first rows
            if y is None:
                x[:len(edge_rows)] = torch.tensor(edge_rows, dtype=x.dtype,
                                                  device="cuda")
            else:
                x[:len(edge_rows)] = torch.tensor(
                    [e[0] for e in edge_rows], dtype=x.dtype, device="cuda")
                y[:len(edge_rows)] = torch.tensor(
                    [e[1] for e in edge_rows], dtype=y.dtype, device="cuda")

        def kernel():
            return ck.checked_arith(op, x, y, valid, sx, sy, s, lo, hi, code,
                                    prec, code_prec, dt, digits)

        def plain():
            return ck.checked_arith_plain(op, x, y, valid, sx, sy, s, lo, hi,
                                          code, prec, code_prec, dt, digits)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            bad = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
            fail(f"checked_arith {label}: {bad} rows differ from the plain "
                 "version")
        marked = int((got[1] != 0).sum())
        nbytes = (x.element_size() + (0 if y is None else y.element_size())
                  + 1 + torch.empty((), dtype=dt).element_size() + 4) * n
        case = {"name": "checked_arith", "shape": f"{label} n={n}",
                "max_abs_err": 0, "marked_rows": marked,
                "ms": time_ms(torch, kernel),
                "device_ms": device_ms(torch, kernel) or None,
                "plain_ms": time_ms(torch, plain, reps=2),
                "library_ms": time_ms(torch, lambda: ck.int64_passes(
                    op, x, y, sx, sy, s)),
                "library_device_ms": device_ms(torch, lambda: ck.int64_passes(
                    op, x, y, sx, sy, s)) or None,
                "graph_ms": graph_ms(torch, kernel),
                "library_graph_ms": graph_ms(torch, lambda: ck.int64_passes(
                    op, x, y, sx, sy, s)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": nbytes}
        cases.append(case)
        log(f"# checked_arith {label} n={n}: {case['ms']:.4f} ms (on the card "
            f"{fmt_ms(case['device_ms'])} ms, graph-replayed "
            f"{case['graph_ms']:.4f} ms), plain {case['plain_ms']:.4f} ms, "
            f"int64 passes {case['library_ms']:.4f} ms (on the card "
            f"{fmt_ms(case['library_device_ms'])} ms, graph-replayed "
            f"{case['library_graph_ms']:.4f} ms), bound "
            f"{case['bound_ms']:.4f} ms; {marked} rows marked; bit-equal")
        if op not in replayed:  # each op's first form, captured, replayed
            replayed.add(op)
            g, out, _scratch = capture(torch, kernel)
            g.replay()
            torch.cuda.synchronize()
            if not (torch.equal(out[0], want[0])
                    and torch.equal(out[1], want[1])):
                fail(f"checked_arith {label}: the graph's replay differs")
            # new inputs (the rows permuted): the replay reads them
            x.copy_(x[torch.randperm(n, generator=gen, device="cuda")])
            g.replay()
            want = plain()
            torch.cuda.synchronize()
            if not (torch.equal(out[0], want[0])
                    and torch.equal(out[1], want[1])):
                fail(f"checked_arith {label}: the replay over new inputs "
                     "differs")
            del g
    pg.reset_counters()  # launches made to compare do not count
    log(f"# checked_arith: {len(specs)} forms bit-equal to the plain version "
        f"at n={n}, their edge rows first, the first mul, mod and cast_f "
        f"forms captured and replayed twice "
        f"({time.perf_counter() - t0:.1f}s)")


def wide_phase(torch, pg, gpu, cpu, launches, smi_line):
    """Phase 15 (b), see the module docstring."""
    from lingodb_tpu_torch.tools import gpu_profile
    from lingodb_tpu_torch.utils import compilestats

    t_phase = time.perf_counter()
    report = {}
    pg.reset_counters()
    for name, (sql, reruns) in WIDE_SQL.items():
        sql = sql or open("queries/tpch/1.sql").read()
        t0 = time.perf_counter()
        want = cpu.sql(sql).to_pylist()
        cpu_ms = (time.perf_counter() - t0) * 1e3
        runs = []
        for i in range(3):
            cs0 = compilestats.snapshot()
            k0 = pg.LAUNCHES["checked_arith"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = gpu.sql(sql).to_pylist()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            d = compilestats.delta(cs0)
            runs.append({"ms": ms, "captures": d["captures"],
                         "replays": d["replays"],
                         "exact_reruns": gpu.executor.last_exact_reruns,
                         "checked_launches": pg.LAUNCHES["checked_arith"] - k0})
            if not same_rows(got, want):
                fail(f"phase 15 {name} run {i + 1}: card rows differ from the "
                     f"CPU session's\ncard={got[:3]}\ncpu={want[:3]}")
        if [r["exact_reruns"] for r in runs] != ([1, 0, 0] if reruns
                                                 else [0, 0, 0]):
            fail(f"phase 15 {name}: exact runs by run "
                 f"{[r['exact_reruns'] for r in runs]}")
        if name in WIDE_CHECKED and not all(r["checked_launches"]
                                            for r in runs):
            fail(f"phase 15 {name}: the checked kernel did not launch on "
                 f"every run: {[r['checked_launches'] for r in runs]}")
        syncs, peak, _res = gpu_profile.syncs_and_peak(
            torch, lambda: gpu.sql(sql).to_pylist())
        report[name] = {"runs": runs, "syncs_third": syncs,
                        "cpu_session_ms": cpu_ms, "rows": len(want)}
        log(f"# wide (15) {name}: rows={len(want)} equal to the CPU session's; "
            f"by run (ms, captures, replays, exact reruns, checked launches) "
            + "; ".join(f"{r['ms']:.2f}, {r['captures']}, {r['replays']}, "
                        f"{r['exact_reruns']}, {r['checked_launches']}"
                        for r in runs)
            + f"; syncs {syncs}; CPU session {cpu_ms:.1f} ms")
    launches["wide"] = dict(pg.LAUNCHES)
    if not launches["wide"]["checked_arith"]:
        fail("phase 15: the checked kernel never launched")
    report["seconds"] = time.perf_counter() - t_phase
    report["device"] = smi_line
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "wide_phase.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"# wide (15): launches {json.dumps(launches['wide'])}; "
        f"{report['seconds']:.1f}s ({smi_line})")


def card_vs_cpu(torch, pg, gpu_profile, gpu, cpu, label, sql, slice_launches,
                want=None):
    """One query on the card (each kernel call checked, then a second run
    timed with its syncs and peak memory) against the CPU session's rows
    (or `want`, rows of Python values), by same_rows. Returns the card's
    rows."""
    if want is None:
        want = cpu.sql(sql).to_pylist()
    rows, counts, nchk = run_checked(torch, pg,
                                     lambda: gpu.sql(sql).to_pylist())
    for k, v in counts.items():
        slice_launches[k] = slice_launches.get(k, 0) + v
    if not same_rows(rows, want):
        fail(f"slice {label}: card rows differ from the expected ones\n"
             f"card={rows[:3]}\nwant={want[:3]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = gpu.sql(sql).to_pylist()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    syncs, peak, before = gpu_profile.syncs_and_peak(
        torch, lambda: gpu.sql(sql).to_pylist())
    if not same_rows(again, want):
        fail(f"slice {label}: second run differs\n{again[:3]}\n{want[:3]}")
    log(f"# slice {label}: rows={len(rows)} wall_ms={ms:.2f} (second run) "
        f"launches={json.dumps(counts)} checked={nchk} syncs={syncs} "
        f"peak_mib={peak / 2**20:.1f} resident_mib={before / 2**20:.1f}")
    return rows


def executor_slice_phase(torch, pg, ldb, gpu_profile, gpu, cpu, tables, args,
                         launches, smi_line):
    """Phase 9 (see the module docstring)."""
    from lingodb_tpu_torch.ops import bytestr, strings
    from lingodb_tpu_torch.utils.settings import EXECUTION_MODE

    t_phase = time.perf_counter()
    slice_launches: dict = {}
    # (a) the out-of-core aggregate
    out_of_core_part(torch, pg, ldb, gpu_profile, gpu.device, args.sf,
                     args.seed, slice_launches)
    log(f"# slice (a): {time.perf_counter() - t_phase:.1f}s")

    # (a'') aggregates over wide decimals that only the host computes
    t0 = time.perf_counter()
    host_decimal_part(torch, pg, ldb, gpu.device, args.sf, args.seed,
                      slice_launches, smi_line)
    log(f"# slice (a''): {time.perf_counter() - t0:.1f}s")

    # (b) window functions over orders and lineitem
    t0 = time.perf_counter()
    for name, sql in WINDOW_QUERIES.items():
        card_vs_cpu(torch, pg, gpu_profile, gpu, cpu, f"(b) window {name}",
                    sql, slice_launches)
    log(f"# slice (b): {time.perf_counter() - t0:.1f}s")

    # (c) WITH RECURSIVE, once in DEBUG mode (which checks that no host
    # array sits in a table of tensors) and once in the default mode
    t0 = time.perf_counter()
    for name, sql in RECURSIVE_QUERIES.items():
        want = cpu.sql(sql).to_pylist()
        EXECUTION_MODE.set("DEBUG")
        try:
            if not same_rows(gpu.sql(sql).to_pylist(), want):
                fail(f"slice (c) {name} [DEBUG]: card rows differ")
        finally:
            EXECUTION_MODE.set("DEFAULT")
        card_vs_cpu(torch, pg, gpu_profile, gpu, cpu, f"(c) recursive {name}",
                    sql, slice_launches, want)
        rounds = gpu.executor.last_iterate_rounds
        log(f"# slice (c) recursive {name}: rounds={rounds}")
        if rounds is None or rounds < 8:
            fail(f"slice (c) {name}: {rounds} rounds, fewer than 8")
    log(f"# slice (c): {time.perf_counter() - t0:.1f}s")

    # (d) the chunked non-equi join, held against numpy's band counts
    t0 = time.perf_counter()
    expect = nonequi_numpy(tables)
    for kind, sql in NONEQUI_QUERIES.items():
        gpu.executor.last_nonequi_chunks = None
        card_vs_cpu(torch, pg, gpu_profile, gpu, cpu, f"(d) non-equi {kind}",
                    sql, slice_launches, expect[kind])
        chunks = gpu.executor.last_nonequi_chunks
        log(f"# slice (d) non-equi {kind}: candidate pairs={expect['pairs']} "
            f"left chunks={chunks}")
        if chunks is None or chunks < 4:
            fail(f"slice (d) {kind}: {chunks} chunks, fewer than 4")
    log(f"# slice (d): {time.perf_counter() - t0:.1f}s")

    # (e) sql_many with overlap against sequential sql, from evicted device
    # memory (so that the worker thread's uploads run beside the main
    # thread's queries); then device LIKE on q9, q13, q20
    t0 = time.perf_counter()
    qs = [open(f"queries/tpch/{i}.sql").read() for i in range(1, 23)]
    gpu._evict_device_memory()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seq = [gpu.sql(q).format_rows() for q in qs]
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t1) * 1e3
    gpu._evict_device_memory()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    many = [r.format_rows() for r in gpu.sql_many(qs, overlap=True)]
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t1) * 1e3
    for i, (a, b) in enumerate(zip(seq, many), start=1):
        if a != b:
            fail(f"slice (e) sql_many: q{i} differs from sequential sql")
    log(f"# slice (e) sql_many 22 queries: sequential_ms={seq_ms:.1f} "
        f"overlap_ms={many_ms:.1f} (each from evicted device memory)")
    calls: list = []
    orig = bytestr.device_like_mask

    def spy(dictionary, pattern, ci=False, device="cpu"):
        r = orig(dictionary, pattern, ci, device)
        calls.append((dictionary, pattern, ci, str(device), r is not None))
        return r

    bytestr.device_like_mask = spy
    try:
        for q in LIKE_QUERIES:
            sql = qs[int(q) - 1]
            want = cpu.sql(sql).to_pylist()
            # a fused program's dimension builds are cached with their
            # filters applied: clear them, so that the LIKE runs again
            gpu.stage_cache.clear()
            bytestr._MASK_CACHE.clear()
            calls.clear()
            card_vs_cpu(torch, pg, gpu_profile, gpu, cpu, f"(e) like q{q}",
                        sql, slice_launches, want)
            mine = [c for c in calls if c[3] == str(gpu.device)]
            if not mine or not all(c[4] for c in mine):
                fail(f"slice (e) q{q}: device LIKE did not engage on the card "
                     f"({[(c[1], c[3], c[4]) for c in calls]})")
                return
            d, pat, ci = mine[0][0], mine[0][1], mine[0][2]
            dev_ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                mask = bytestr._device_like_mask_uncached(d, pat, ci, gpu.device)
                torch.cuda.synchronize()
                dev_ms.append((time.perf_counter() - t1) * 1e3)
            host_ms = []
            for _ in range(3):
                t1 = time.perf_counter()
                lut = strings.like_lut(d, pat, ci)
                host_ms.append((time.perf_counter() - t1) * 1e3)
            if mask.cpu().numpy().tolist() != lut.tolist():
                fail(f"slice (e) q{q}: device LIKE mask differs from the host's")
            log(f"# slice (e) like q{q} {pat!r} over {len(d)} entries: device "
                f"{min(dev_ms):.3f} ms (best of 5), host like_lut "
                f"{min(host_ms):.3f} ms (best of 3), "
                f"{min(host_ms) / min(dev_ms):.1f}x")
    finally:
        bytestr.device_like_mask = orig
    log(f"# slice (e): {time.perf_counter() - t0:.1f}s")
    launches["executor_slice"] = {
        "gather_chunked": slice_launches.get("K1", 0),
        "gather_sorted": slice_launches.get("K2", 0),
        "compact_positions": slice_launches.get("K3", 0)}
    log(f"# slice launches (K1, K2, K3 over phase 9, each call checked): "
        f"{json.dumps(slice_launches)}")
    log(f"# slice: phase 9 took {time.perf_counter() - t_phase:.1f}s")


# ---- phase 10: the fused programs as CUDA graphs
GRAPH_THREAD_REPLAYS = 50
# round with digits inside the fused aggregate: its digits are read from the
# plan, so the program is captured (ORDER BY for a fixed row order)
ROUND_SQL = ("SELECT l_returnflag, sum(round(l_extendedprice, 1)) "
             "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag")


def replay_check(torch, label, got, want):
    """got and want: lists of tensors, compared bit for bit (int64)."""
    torch.cuda.synchronize()
    if max_abs_err(torch, [g.reshape(-1) for g in got],
                   [w.reshape(-1) for w in want]):
        fail(f"graph replay differs from the plain version: {label}")


def capture(torch, fn, stream=None, scratch=None):
    """fn() captured in a new CUDA graph (its compact_positions calls on
    `scratch`): (graph, fn's outputs, which the graph's replays refill)."""
    from lingodb_tpu_torch.ops import pgather as pg

    g = torch.cuda.CUDAGraph()
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    if scratch is None:
        scratch = pg.new_compact_scratch("cuda")
    with pg.capture_scratch(scratch), torch.cuda.stream(stream):
        g.capture_begin()
        out = fn()
        g.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    return g, out, scratch


def check_graph_kernels(torch, pg, u, limit_s=300.0):
    """Phase 10 (a), see the module docstring."""
    n = u.numel()
    masks = {"sel 0": u < 0, "sel 0.5": u < 0.5, "sel 1": u < 2,
             "count above k": u < 0.8, "sel 0.02": u < 0.02}
    k = int(masks["sel 0.5"].sum())
    static = torch.zeros(n, dtype=torch.bool, device="cuda")
    g, (cnt, pos), scratch = capture(
        torch, lambda: pg.compact_positions(static, k))
    for label in list(masks) + ["wrap"]:
        m = masks["sel 0.5" if label == "wrap" else label]
        if label == "wrap":
            stale_scratch(torch, scratch)
        static.copy_(m)
        g.replay()
        cnt_p, pos_p = pg.compact_positions_plain(m, k)
        replay_check(torch, f"compact_positions, {label}", [cnt, pos],
                     [cnt_p, pos_p])
    log(f"# graphs: compact_positions replayed over {len(masks) + 1} masks "
        f"(n={n}, k={k}), equal to the plain version")
    # two threads, each replaying its own graph on its own stream
    graphs = []
    for label in ("sel 0.5", "sel 0.02"):
        st = torch.cuda.Stream()
        mk = masks[label]
        kk = int(mk.sum())
        gi, outs, _scr = capture(torch, lambda m=mk, kk=kk:
                                 pg.compact_positions(m, kk), stream=st)
        graphs.append((label, st, gi, outs,
                       pg.compact_positions_plain(mk, kk)))
    results, errors = [[], []], []

    def work(t):
        label, st, gi, (c, p), _want = graphs[t]
        try:
            with torch.cuda.stream(st):
                for _ in range(GRAPH_THREAD_REPLAYS):
                    gi.replay()
                    results[t].append((c.clone(), p.clone()))
            st.synchronize()
        except Exception as exc:  # reported after the join
            errors.append(f"thread {t}: {exc!r}")

    threads = [threading.Thread(target=work, args=(t,), daemon=True)
               for t in range(2)]
    deadline = time.perf_counter() + limit_s
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    if any(th.is_alive() for th in threads):
        print(f"chip_smoke: FAILED: graph replays from two threads did not "
              f"finish within {limit_s:.0f} s (a hang)", file=sys.stderr,
              flush=True)
        os._exit(1)  # a thread waits on the card: no orderly exit
    if errors:
        fail(f"graph replays from two threads raised: {errors}")
    for t, (label, _st, _g, _o, want) in enumerate(graphs):
        for c, p in results[t]:
            replay_check(torch, f"compact_positions from thread {t} ({label})",
                         [c, p], list(want))
    log(f"# graphs: compact_positions from two threads, each replaying its "
        f"own graph {GRAPH_THREAD_REPLAYS} times on its own stream, equal to "
        "the plain version")
    # gather_chunked, gather_sorted and segscan: one replay each, new
    # indices (and keys) written into the captured inputs first
    gen = torch.Generator(device="cuda").manual_seed(11)
    planes = [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                            device="cuda", generator=gen) for _ in range(2)]
    small = [p[:10_000].clone() for p in planes]
    idx = torch.zeros(n, dtype=torch.int32, device="cuda")
    sidx = torch.zeros(n // 2, dtype=torch.int32, device="cuda")
    gid = torch.zeros(n, dtype=torch.int32, device="cuda")
    # planes of three widths in one launch, and K1's direct form (10 rows)
    mixed = gather_planes(torch, gen, n, ("int64", "bool", "float32"))
    mixed_small = [p[:10_000].clone() for p in mixed]
    few = torch.zeros(10, dtype=torch.int32, device="cuda")
    for name, fn, fill, plain in (
            ("gather_chunked, three widths",
             lambda: pg.gather_chunked_planes(mixed_small, idx),
             lambda: idx.copy_(torch.randint(0, 10_000, (n,), device="cuda",
                                             generator=gen)),
             lambda: pg.gather_chunked_planes_plain(mixed_small, idx)),
            ("gather_chunked, 10 rows (the direct form)",
             lambda: pg.gather_chunked_planes(mixed_small, few),
             lambda: few.copy_(torch.randint(-5, 10_005, (10,), device="cuda",
                                             generator=gen)),
             lambda: pg.gather_chunked_planes_plain(mixed_small, few)),
            ("gather_sorted, three widths",
             lambda: pg.gather_sorted_planes(mixed, sidx),
             lambda: sidx.copy_(torch.sort(torch.randint(
                 0, n, (n // 2,), device="cuda", generator=gen)).values),
             lambda: pg.gather_sorted_planes_plain(mixed, sidx)),
            ("gather_chunked", lambda: pg.gather_chunked_planes(small, idx),
             lambda: idx.copy_(torch.randint(0, 10_000, (n,), device="cuda",
                                             generator=gen)),
             lambda: pg.gather_chunked_planes_plain(small, idx)),
            ("gather_sorted", lambda: pg.gather_sorted_planes(planes, sidx),
             lambda: sidx.copy_(torch.sort(torch.randint(
                 0, n, (n // 2,), device="cuda", generator=gen)).values),
             lambda: pg.gather_sorted_planes_plain(planes, sidx)),
            ("segscan", lambda: pg.segscan_i32(gid, planes),
             lambda: gid.copy_(torch.arange(n, device="cuda") // 4),
             lambda: pg.segscan_i32_plain(gid, planes))):
        gk, out, _scr = capture(torch, fn)
        fill()
        gk.replay()
        replay_check(torch, name, list(out), list(plain()))
    log("# graphs: gather_chunked (int32 planes, three widths, the direct "
        "form), gather_sorted (int32 planes, three widths) and segscan "
        "replayed with new inputs, equal to their plain versions")


def graphs_phase(torch, pg, ldb, gpu_profile, gpu, cpu, tables, cpu_rows,
                 mask_u):
    """Phase 10 (see the module docstring)."""
    from lingodb_tpu_torch.runtime import exestore
    from lingodb_tpu_torch.tools import tpchgen
    from lingodb_tpu_torch.utils import capstore, compilestats
    from lingodb_tpu_torch.utils.settings import CAPSTORE_DIR

    t_phase = time.perf_counter()
    check_graph_kernels(torch, pg, mask_u)
    queries = list(dict.fromkeys(QUERIES + TOPK_CHAIN_QUERIES)) + ["round"]
    sqls = {q: open(f"queries/tpch/{q}.sql").read() for q in queries
            if q != "round"}
    sqls["round"] = ROUND_SQL
    for q in queries:
        if q not in cpu_rows:
            cpu_rows[q] = cpu.sql(sqls[q]).format_rows()
    freeze_heap()
    gen2_before = gc.get_stats()[2]["collections"]
    # (b) from an empty stage cache and store, the capstore written anew
    store_dir = os.path.join("build", "capstore_smoke")
    if os.path.exists(os.path.join(store_dir, "capacities.json")):
        os.remove(os.path.join(store_dir, "capacities.json"))
    CAPSTORE_DIR.set(store_dir)
    capstore.reset()
    gpu.stage_cache.clear()
    gpu.exestore.clear()
    table = {}
    for q in queries:
        runs = []
        pool0 = gpu.exestore.pool_memory()[0]
        for r in range(3):
            cs0 = compilestats.snapshot()
            pg.reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = gpu.sql(sqls[q]).format_rows()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            d = compilestats.delta(cs0)
            d["launches"] = dict(pg.LAUNCHES)
            if rows != cpu_rows[q]:
                fail(f"q{q} [graphs, run {r + 1}]: GPU rows differ from the "
                     "CPU session's")
            runs.append((ms, d))
        # what the store's one shared pool grew by over the query's runs
        pool_mib = (gpu.exestore.pool_memory()[0] - pool0) / 2**20
        for r in (1, 2):
            d = runs[r][1]
            if d["captures"] or d["builds"] or d["calibrations"]:
                fail(f"q{q} [graphs, run {r + 1}]: {d}")
            if d["replays"] < 1:
                fail(f"q{q} [graphs, run {r + 1}]: no replay")
        if runs[0][1]["captures"] < 1:
            fail(f"q{q} [graphs, run 1]: nothing captured")
        syncs, peak, _ = gpu_profile.syncs_and_peak(
            torch, lambda: gpu.sql(sqls[q]).format_rows())
        prof = gpu_profile.profile_query(torch, gpu, sqls[q])
        split = front_and_execution(torch, gpu, sqls[q])
        alone = front_and_execution(torch, gpu, sqls[q])
        with gpu_profile.uncaptured_path():
            gpu.sql(sqls[q]).format_rows()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = gpu.sql(sqls[q]).format_rows()
            torch.cuda.synchronize()
            un_ms = (time.perf_counter() - t0) * 1e3
            un_syncs, _, _ = gpu_profile.syncs_and_peak(
                torch, lambda: gpu.sql(sqls[q]).format_rows())
            un_prof = gpu_profile.profile_query(torch, gpu, sqls[q])
            un_split = front_and_execution(torch, gpu, sqls[q])
        if rows != cpu_rows[q]:
            fail(f"q{q} [uncaptured]: GPU rows differ from the CPU session's")
        table[q] = {
            "runs": [{"ms": ms, **d} for ms, d in runs],
            "captured": {"wall_ms": runs[2][0], "syncs": syncs,
                         "front_ms": split[0], "execution_ms": split[1],
                         "execution_gc_ms": split[2], "execution_gc_gen2": split[3],
                         "execution_counts": split[4],
                         "alone_front_ms": alone[0],
                         "alone_execution_ms": alone[1],
                         "alone_gc_ms": alone[2], "alone_gc_gen2": alone[3],
                         "alone_counts": alone[4],
                         "idle": prof["device_idle_share"],
                         "device_ms": prof["device_ms"],
                         "profiled_wall_ms": prof["wall_ms"],
                         "replays": prof["replays"], "peak_mib": peak / 2**20},
            "uncaptured": {"wall_ms": un_ms, "syncs": un_syncs,
                           "front_ms": un_split[0],
                           "execution_ms": un_split[1],
                           "execution_gc_ms": un_split[2],
                           "execution_gc_gen2": un_split[3],
                           "execution_counts": un_split[4],
                           "idle": un_prof["device_idle_share"],
                           "device_ms": un_prof["device_ms"],
                           "profiled_wall_ms": un_prof["wall_ms"]},
            "capture_ms": runs[0][1]["capture_secs"] * 1e3,
            "pool_mib": pool_mib}
        t = table[q]
        SYNCS[f"p10 q{q}"] = {"syncs": syncs, "uncaptured_syncs": un_syncs,
                              "launches": runs[2][1]["launches"]}
        by_run = [(d["captures"], d["replays"], d["calibrations"])
                  for _m, d in runs]
        log(f"# graphs q{q}: captures/replays/calibrations by run {by_run}; "
            f"launches by run {[d['launches'] for _m, d in runs]}; "
            f"wall_ms replayed {t['captured']['wall_ms']:.2f} uncaptured "
            f"{un_ms:.2f}; syncs {syncs} / {un_syncs}; idle "
            f"{t['captured']['idle']:.3f} / {t['uncaptured']['idle']:.3f}; "
            f"device_ms {prof['device_ms']:.3f} / {un_prof['device_ms']:.3f}; "
            f"capture_ms {t['capture_ms']:.1f}; pool_mib {pool_mib:.1f}; "
            f"front/execution ms {split[0]:.2f}/{split[1]:.2f} replayed "
            f"after the profiler (gc {split[2]:.2f} ms, gen2 {split[3]}, "
            f"{json.dumps(split[4])}), {alone[0]:.2f}/{alone[1]:.2f} replayed "
            f"alone (gc {alone[2]:.2f} ms, gen2 {alone[3]}), "
            f"{un_split[0]:.2f}/{un_split[1]:.2f} uncaptured (gc "
            f"{un_split[2]:.2f} ms, gen2 {un_split[3]})")
    # round's digits read nothing to the host: its replays sync as q1's
    # (a fused aggregate with a sort) do
    got = table["round"]["captured"]["syncs"]
    want = table["1"]["captured"]["syncs"]
    if got != want:
        fail(f"graphs (b): the round statement's replay syncs {got} times, "
             f"q1's {want}")
    log(f"# graphs (b) round: {ROUND_SQL}: captured once, replayed, rows "
        f"equal the CPU session's; replay syncs {got} (q1: {want})")
    # what one generation-2 collection costs in this process now (C5: a
    # prepared run's spikes), the frozen heap aside
    gen2 = gc.get_stats()[2]["collections"] - gen2_before
    tracked = len(gc.get_objects())
    t0 = time.perf_counter()
    gc.collect()
    table["gc"] = {"gen2_collections_in_phase": gen2,
                   "tracked_objects": tracked,
                   "frozen_objects": gc.get_freeze_count(),
                   "full_collection_ms": (time.perf_counter() - t0) * 1e3}
    log(f"# graphs: {gen2} generation-2 collections during (b); a full "
        f"collection now takes {table['gc']['full_collection_ms']:.1f} ms "
        f"over {tracked} tracked objects ({gc.get_freeze_count()} frozen "
        f"before (b))")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "graphs_phase.json"), "w") as f:
        json.dump(table, f, indent=1)
    # (c) a fresh session over the capstore: no calibration run
    capstore.reset()
    fresh = ldb.create_in_memory()
    tpchgen.install(fresh, tables)
    cs0 = compilestats.snapshot()
    for q in queries:
        if fresh.sql(sqls[q]).format_rows() != cpu_rows[q]:
            fail(f"q{q} [fresh session over the capstore]: rows differ")
    d = compilestats.delta(cs0)
    if d["calibrations"]:
        fail(f"a fresh session over the capstore calibrated: {d}")
    log(f"# graphs (c): a fresh session over the capstore ran the "
        f"{len(queries)} queries with {d['calibrations']} calibration runs, "
        f"{d['captures']} captures, rows equal")
    fresh._evict_device_memory()
    del fresh
    CAPSTORE_DIR.set("")
    capstore.reset()
    # (d) eviction drops the graphs: the next run captures again
    gpu._evict_device_memory()
    if gpu.exestore.entries:
        fail("graphs (d): entries left after _evict_device_memory")
    cs0 = compilestats.snapshot()
    for q in ("6", "3", "9"):
        if gpu.sql(sqls[q]).format_rows() != cpu_rows[q]:
            fail(f"q{q} [graphs, after eviction]: rows differ")
    d = compilestats.delta(cs0)
    if d["captures"] < 3:
        fail(f"graphs (d): after eviction the queries captured {d}")
    log(f"# graphs (d): after eviction q6, q3, q9 captured again "
        f"({d['captures']} captures), rows equal")
    # (e) execution mode PERF on the card, its speed of light against the
    # H100 SXM data sheet's 3.35 TB/s (system.hbm_gbps has no default)
    from lingodb_tpu_torch.utils.settings import EXECUTION_MODE, HBM_GBPS

    HBM_GBPS.set(HBM_BYTES_PER_S / 1e9)
    EXECUTION_MODE.set("PERF")
    try:
        for q in ("6", "3"):
            if gpu.sql(sqls[q]).format_rows() != cpu_rows[q]:
                fail(f"q{q} [PERF mode]: rows differ")
            for rec in gpu.executor.last_op_profile:
                log(f"# perf q{q}: {rec[0]} self={rec[1]:.3f}ms "
                    f"incl={rec[3]:.3f}ms rows={rec[2]} bytes={rec[4]} "
                    f"sol={rec[5]} (system.hbm_gbps={HBM_GBPS.get():g})")
    finally:
        EXECUTION_MODE.set("DEFAULT")
        HBM_GBPS.reset()
    log(f"# graphs: phase 10 took {time.perf_counter() - t_phase:.1f}s "
        f"(capture switch {exestore.CAPTURE})")


# ---- phase 11: user-defined functions on the card, the tools that drive the
# engine (CLI, sqlite3 oracle, sqllogictest runner) and TPC-DS
UDF_FUNCTIONS = {
    "pmix": "create function pmix(x int) returns bigint as $$\n"
            "def pmix(x):\n    return (x % 997) * 7 % 1000\n$$ language python",
    "cmix": "create function cmix(x int) returns bigint language c as "
            "$$ return (x % 997) * 7 % 1000; $$",
    "boom": "create function boom(x int) returns int as $$\n"
            "def boom(x):\n    import os\n    os._exit(3)\n$$ language python",
}
# a UDF in the WHERE under an aggregate over a join with two small tables
# (the eager join gathers the 10,000-row supplier), and one in an
# aggregate's argument
UDF_QUERIES = {
    "where": "select n_name, count(*), sum(l_quantity) from lineitem, "
             "supplier, nation where l_suppkey = s_suppkey and s_nationkey = "
             "n_nationkey and {f}(l_partkey) < 100 group by n_name order by "
             "n_name",
    "argument": "select l_returnflag, l_linestatus, sum({f}(l_partkey)), "
                "count(*) from lineitem group by l_returnflag, l_linestatus "
                "order by l_returnflag, l_linestatus",
}
# (label, function, system.udf_isolation)
UDF_RUNS = (("python", "pmix", "none"), ("c", "cmix", "none"),
            ("python isolated", "pmix", "process"))
CLI_QUERIES = ("1", "6", "3")
CLI_DEVICE_ARGS: list = []  # rehearsals on the host pass ["--device", "cpu"]
ORACLE_SF = 0.005  # the JAX package's oracle scale (tests/test_tpch.py:12)
RUNNER_FILE = os.path.join("tests", "data", "torch_basic.test")
# the shape of TPC-DS q3: store_sales joined to date_dim and item, grouped by
# brand and year (no TPC-DS query text is in the repo)
TPCDS_STAR = (
    "select dt.d_year, item.i_brand_id brand_id, item.i_brand brand, "
    "sum(ss_ext_sales_price) sum_agg from date_dim dt, store_sales, item "
    "where dt.d_date_sk = store_sales.ss_sold_date_sk and "
    "store_sales.ss_item_sk = item.i_item_sk and item.i_manufact_id = 128 "
    "and dt.d_moy = 11 group by dt.d_year, item.i_brand, item.i_brand_id "
    "order by dt.d_year, sum_agg desc, brand_id limit 100")


def oracle_rows(small, out: dict) -> None:
    """sqlite3's rows of the 22 TPC-H queries over `small` (run on a thread:
    sqlite releases the interpreter lock while it steps)."""
    import sqlite3

    from lingodb_tpu_torch.tools import sqlite_oracle as so
    from lingodb_tpu_torch.tools import tpchgen

    try:
        t0 = time.perf_counter()
        conn = sqlite3.connect(":memory:")
        tpchgen.to_sqlite(conn, small)
        for i in range(1, 23):
            out[str(i)] = so.run_sqlite(
                conn, open(f"queries/tpch/{i}.sql").read())
        conn.close()
        out["seconds"] = time.perf_counter() - t0
    except Exception as e:  # reported by the main thread
        out["error"] = repr(e)


def timed_udf(torch, sc, spent: list):
    """ops.scalar._eval_udf with the wall ms of each call (the device ->
    host -> device round trip and the function) appended to `spent`; a
    call inside a fused program (where no host read is allowed) fails."""
    from lingodb_tpu_torch.ops import backend as be

    orig = sc._eval_udf

    def call(*a, **k):
        if be._no_host_reads:
            fail("udf: a UDF was evaluated inside a fused program")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a, **k)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return r

    return orig, call


def udf_part(torch, pg, ex, gpu_profile, gpu, cpu, p11):
    """Phase 11 (a)."""
    from lingodb_tpu_torch.ops import scalar as sc
    from lingodb_tpu_torch.runtime import sandbox
    from lingodb_tpu_torch.runtime.udf import UDFError
    from lingodb_tpu_torch.utils.settings import UDF_ISOLATION

    for s in (gpu, cpu):
        for name in ("pmix", "cmix"):
            if s.catalog.get_function(name) is None:
                s.sql_stmt(UDF_FUNCTIONS[name])
    # which aggregates the fused program took (True) or declined (False),
    # in order: the one over the UDF declines; an aggregate above it may
    # run fused over its eager result (the UDF is not in its program)
    engaged: list = []
    orig_fused = ex.Executor._try_fused_agg

    def spy(self, op, epi=None):
        r = orig_fused(self, op, epi)
        engaged.append(r is not None)
        return r

    spent: list = []
    orig_udf, timed = timed_udf(torch, sc, spent)
    ex.Executor._try_fused_agg = spy
    sc._eval_udf = timed
    want: dict = {}
    try:
        for label, fn, iso in UDF_RUNS:
            UDF_ISOLATION.set(iso)
            try:
                for place, text in UDF_QUERIES.items():
                    sql = text.format(f=fn)
                    if sql not in want:
                        engaged.clear()
                        want[sql] = (cpu.sql(sql).to_pylist(), list(engaged))
                    engaged.clear()
                    rows, counts, nchk = run_checked(
                        torch, pg, lambda: gpu.sql(sql).to_pylist())
                    seen = (False in engaged, True in engaged)
                    if (seen != (False in want[sql][1], True in want[sql][1])
                            or False not in engaged):
                        fail(f"udf ({label}, {place}): fused aggregates "
                             f"engaged {engaged} on the card, "
                             f"{want[sql][1]} on the CPU session (the one "
                             "over the UDF must decline)")
                    if not same_rows(rows, want[sql][0]) or not rows:
                        fail(f"udf ({label}, {place}): card rows differ from "
                             f"the CPU session's\n{rows[:3]}\n"
                             f"{want[sql][0][:3]}")
                    if place == "where" and not (counts["K2"] and counts["K3"]):
                        fail(f"udf ({label}, {place}): the filter's K3 and "
                             f"K2 were not launched ({counts})")
                    for k, v in counts.items():
                        p11[k] = p11.get(k, 0) + v
                    spent.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    again = gpu.sql(sql).to_pylist()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    udf_ms, udf_calls = sum(spent), len(spent)
                    syncs, peak, _ = gpu_profile.syncs_and_peak(
                        torch, lambda: gpu.sql(sql).to_pylist())
                    if not same_rows(again, want[sql][0]):
                        fail(f"udf ({label}, {place}): second run differs")
                    log(f"# udf ({label}, {place}): rows={len(rows)} "
                        f"wall_ms={ms:.2f} (second run) udf_round_trip_ms="
                        f"{udf_ms:.2f} in {udf_calls} call(s) syncs={syncs} "
                        f"launches={json.dumps(counts)} checked={nchk} "
                        f"peak_mib={peak / 2**20:.1f} fused aggregates "
                        f"engaged={engaged}")
            finally:
                UDF_ISOLATION.set("none")
        # a crash in the isolated worker surfaces as UDFError; the next call
        # restarts the worker and succeeds
        UDF_ISOLATION.set("process")
        try:
            gpu.sql_stmt(UDF_FUNCTIONS["boom"])
            try:
                gpu.sql("select boom(n_nationkey) from nation")
                fail("udf: a crashing isolated UDF raised nothing")
            except UDFError as e:
                log(f"# udf crash: UDFError({str(e)[:80]!r})")
            got = gpu.sql("select pmix(n_nationkey) from nation order by "
                          "n_nationkey").to_pylist()
            if [r[0] for r in got] != [(k % 997) * 7 % 1000 for k in range(25)]:
                fail(f"udf: the call after a crash gave {got[:5]}")
            log("# udf crash: the next call restarted the worker, rows right")
        finally:
            UDF_ISOLATION.set("none")
            if sandbox._GLOBAL_WORKER is not None:
                sandbox._GLOBAL_WORKER.close()
    finally:
        ex.Executor._try_fused_agg = orig_fused
        sc._eval_udf = orig_udf


def cli_part(torch, ldb, gpu, tables, sf):
    """Phase 11 (b): the CLI as subprocesses over a database directory."""
    import shutil

    t0 = time.perf_counter()
    db = os.path.join(".cache", f"chip_smoke_cli_sf{sf:g}")
    shutil.rmtree(db, ignore_errors=True)
    w = ldb.connect_to_db(db, device="cpu")
    from lingodb_tpu_torch.tools import tpchgen

    tpchgen.install(w, tables)
    w.close()
    log(f"# cli: database sf={sf:g} written to {db} in "
        f"{time.perf_counter() - t0:.1f}s")
    art = os.path.join(db, "q3.lqa")
    cli = [sys.executable, "-m", "lingodb_tpu_torch.tools.cli"]

    def start(argv, env=None):
        return (time.perf_counter(), subprocess.Popen(
            cli + argv + CLI_DEVICE_ARGS, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))

    def finish(label, job, timeout=600):
        t_start, proc = job
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"cli {label}: no answer in {timeout}s")
        if proc.returncode != 0:
            fail(f"cli {label} exited {proc.returncode}: {err[-3000:]}")
        log(f"# cli {label}: {time.perf_counter() - t_start:.1f}s (process "
            f"wall, run beside the others)")
        return out, err

    jobs: dict = {}
    try:
        # the tools side by side, each its own process on the card; the
        # artifact's cold run starts once the artifact is written
        for q in CLI_QUERIES:
            jobs[f"run-sql q{q}"] = start(["run-sql", f"queries/tpch/{q}.sql",
                                           db])
        jobs["sql-to-plan q3"] = start(["sql-to-plan", "queries/tpch/3.sql",
                                        db])
        # profile writes its per-pass plans to system.snapshot_dir
        jobs["profile q6"] = start(["profile", "queries/tpch/6.sql", db],
                                   dict(os.environ, LINGODB_SNAPSHOT_DIR=db))
        jobs["sql-to-artifact q3"] = start(["sql-to-artifact",
                                            "queries/tpch/3.sql", art, db])
        outs = {"sql-to-artifact q3": finish("sql-to-artifact q3",
                                             jobs["sql-to-artifact q3"])}
        jobs["run-artifact q3"] = start(["run-artifact", art, db])
        for label, job in jobs.items():
            if label not in outs:
                outs[label] = finish(label, job)
    finally:
        for _t, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for q in CLI_QUERIES:
        want = gpu.sql(open(f"queries/tpch/{q}.sql").read()).pretty(
            max_rows=10_000) + "\n"
        if outs[f"run-sql q{q}"][0] != want:
            fail(f"cli run-sql q{q}: rows differ from the in-process card "
                 f"session's\n{outs[f'run-sql q{q}'][0][:400]}\n{want[:400]}")
    if not outs["sql-to-plan q3"][0].startswith("Materialize"):
        fail(f"cli sql-to-plan: {outs['sql-to-plan q3'][0][:300]}")
    prof = outs["profile q6"][0]
    if "== operator profile (self time) ==" not in prof or "TOTAL" not in prof:
        fail(f"cli profile: no operator profile\n{prof[-1500:]}")
    lines = prof.splitlines()
    at = lines.index("== operator profile (self time) ==")
    for line in lines[at + 1:]:
        if not line.startswith(("  ", "== host")):
            break
        log(f"# cli profile q6: {line.strip()}")
    log(f"# cli sql-to-artifact: {outs['sql-to-artifact q3'][0].strip()}")
    want3 = gpu.sql(open("queries/tpch/3.sql").read()).pretty(
        max_rows=10_000) + "\n"
    out, err = outs["run-artifact q3"]
    if out != want3:
        fail(f"cli run-artifact q3: rows differ\n{out[:400]}\n{want3[:400]}")
    stats = next((line for line in err.splitlines()
                  if line.startswith("# cold run")), "")
    if "parses=0 optimizations=0 calibrations=0" not in stats:
        fail(f"cli run-artifact q3: the cold process parsed, optimized or "
             f"calibrated: {stats!r}")
    log(f"# cli run-artifact q3 (fresh process): {stats[2:]}, rows equal")
    shutil.rmtree(db, ignore_errors=True)
    log(f"# cli: part (b) took {time.perf_counter() - t0:.1f}s")


def oracle_part(torch, pg, ldb, small, sqlite_out, thread, p11):
    """Phase 11 (c): the card's rows of the 22 TPC-H queries against
    sqlite3's."""
    from lingodb_tpu_torch.tools import sqlite_oracle as so
    from lingodb_tpu_torch.tools import tpchgen

    s = ldb.create_in_memory()
    tpchgen.install(s, small)
    ours = {}
    t0 = time.perf_counter()
    for i in range(1, 23):
        res, counts, _n = run_checked(
            torch, pg, lambda: s.sql(open(f"queries/tpch/{i}.sql").read()))
        ours[str(i)] = so.our_rows(res)
        for k, v in counts.items():
            p11[k] = p11.get(k, 0) + v
    card_s = time.perf_counter() - t0
    thread.join(timeout=600)
    if thread.is_alive() or "error" in sqlite_out:
        fail(f"oracle: sqlite3 did not answer: {sqlite_out.get('error')}")
    for q, rows in ours.items():
        ok, msg = so.rows_equal(rows, sqlite_out[q], ordered=True)
        if not ok:
            fail(f"oracle q{q}: the card's rows differ from sqlite3's: {msg}")
    log(f"# oracle: the 22 TPC-H queries at sf {ORACLE_SF:g} on the card "
        f"({card_s:.1f}s, each kernel call checked) pass sqlite3's rows "
        f"(sqlite3 {sqlite_out['seconds']:.1f}s on a thread)")
    s._evict_device_memory()


def runner_part(ldb):
    """Phase 11 (d): the sqllogictest runner over the in-repo .test file,
    every table on the tensor tier."""
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.tester import runner

    small_rows, dv.SMALL_ROWS = dv.SMALL_ROWS, 2
    try:
        stats = runner.run_file(ldb.create_in_memory(), RUNNER_FILE,
                                stop_on_error=False)
    finally:
        dv.SMALL_ROWS = small_rows
    if not stats.ok or stats.queries < 10:
        fail(f"runner {RUNNER_FILE}: {stats.statements} statements, "
             f"{stats.queries} queries, failures {stats.failures[:3]}")
    log(f"# runner {RUNNER_FILE}: {stats.statements} statements, "
        f"{stats.queries} queries, every record passes on the card")


def tpcds_part(torch, pg, ldb, ex, gpu_profile, sf, p11):
    """Phase 11 (e): a star join of TPC-DS through the fused aggregate."""
    from lingodb_tpu_torch.tools import tpcdsgen

    t0 = time.perf_counter()
    ds = tpcdsgen.generate(sf)
    log(f"# tpcds: sf={sf:g}, store_sales={ds['store_sales'].num_rows} rows, "
        f"generated in {time.perf_counter() - t0:.1f}s")
    gpu_ds = ldb.create_in_memory()
    cpu_ds = ldb.create_in_memory(device="cpu")
    tpcdsgen.install(gpu_ds, ds)
    tpcdsgen.install(cpu_ds, ds)
    engaged = []
    orig = ex.Executor._try_fused_agg

    def spy(self, op, epi=None):
        r = orig(self, op, epi)
        engaged.append(r is not None)
        return r

    ex.Executor._try_fused_agg = spy
    try:
        want = cpu_ds.sql(TPCDS_STAR).to_pylist()
        cpu_hit = any(engaged)
        engaged.clear()
        rows, counts, nchk = run_checked(
            torch, pg, lambda: gpu_ds.sql(TPCDS_STAR).to_pylist())
        card_hit = any(engaged)
    finally:
        ex.Executor._try_fused_agg = orig
    if not (card_hit and cpu_hit):
        fail(f"tpcds: the fused aggregate did not engage (card {card_hit}, "
             f"CPU {cpu_hit})")
    if not rows or not same_rows(rows, want):
        fail(f"tpcds: card rows differ from the CPU session's\n{rows[:3]}\n"
             f"{want[:3]}")
    for k, v in counts.items():
        p11[k] = p11.get(k, 0) + v
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again = gpu_ds.sql(TPCDS_STAR).to_pylist()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    syncs, peak, _ = gpu_profile.syncs_and_peak(
        torch, lambda: gpu_ds.sql(TPCDS_STAR).to_pylist())
    if not same_rows(again, want):
        fail("tpcds: second run differs")
    log(f"# tpcds star join (q3 shape): rows={len(rows)} wall_ms={ms:.2f} "
        f"(second run) syncs={syncs} launches={json.dumps(counts)} "
        f"checked={nchk} peak_mib={peak / 2**20:.1f} fused=engaged")
    gpu_ds._evict_device_memory()


def tools_phase(torch, pg, ldb, ex, gpu_profile, gpu, cpu, tables, args,
                launches):
    """Phase 11 (see the module docstring)."""
    from lingodb_tpu_torch.tools import tpchgen

    t_phase = time.perf_counter()
    p11: dict = {}
    small = tpchgen.generate(ORACLE_SF, args.seed)
    sqlite_out: dict = {}
    thread = threading.Thread(target=oracle_rows, args=(small, sqlite_out),
                              daemon=True)
    thread.start()
    t0 = time.perf_counter()
    udf_part(torch, pg, ex, gpu_profile, gpu, cpu, p11)
    log(f"# udf: part (a) took {time.perf_counter() - t0:.1f}s")
    cli_part(torch, ldb, gpu, tables, args.sf)
    t0 = time.perf_counter()
    oracle_part(torch, pg, ldb, small, sqlite_out, thread, p11)
    runner_part(ldb)
    log(f"# oracle and runner: parts (c), (d) took "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tpcds_part(torch, pg, ldb, ex, gpu_profile, args.sf, p11)
    log(f"# tpcds: part (e) took {time.perf_counter() - t0:.1f}s")
    launches["p11"] = {"gather_chunked": p11.get("K1", 0),
                       "gather_sorted": p11.get("K2", 0),
                       "compact_positions": p11.get("K3", 0)}
    log(f"# p11 launches (K1, K2, K3 over phase 11, each call checked): "
        f"{json.dumps(p11)}")
    log(f"# tools: phase 11 took {time.perf_counter() - t_phase:.1f}s")


# ---- phase 12: the sharded operators over a mesh of 8 positions on the card
MESH_POSITIONS = 8
MESH_QUERIES = ("3", "18")  # the JAX package's tests/test_mesh_sf1.py
# the statements of the JAX package's tests/test_shuffle.py over lineitem and
# orders: name -> (sql, the shuffle.STATS counters it must move). Each is
# ordered by a unique key (the rows compare column by column); a derived key
# gives the anti join its NULL keys and the probe side its hot key (the
# join on an expression keeps the optimizer from pre-aggregating it)
MESH_STATEMENTS = {
    "inner_join_groupby": (
        "select l_orderkey, sum(l_quantity) from lineitem, orders where "
        "l_orderkey = o_orderkey and o_orderdate < date '1993-01-01' "
        "group by l_orderkey order by l_orderkey", ("joins", "groupbys")),
    "semi": (
        "select l_suppkey, count(*) from lineitem where l_orderkey in (select "
        "o_orderkey from orders where o_custkey < 75000) group by l_suppkey "
        "order by l_suppkey", ("joins", "groupbys")),
    "anti_null_keys": (
        "select count(*) from (select * from (select l_suppkey, case when "
        "l_linenumber = 1 then null else l_orderkey end as k from lineitem) t "
        "where t.k not in (select o_orderkey from orders where o_custkey < "
        "75000) or t.k is null) u", ("joins",)),
    "left": (
        "select o_orderkey, count(l_quantity) from orders left join lineitem "
        "on o_orderkey = l_orderkey and l_quantity > 25 group by o_orderkey "
        "order by o_orderkey", ("joins", "groupbys")),
    "full": (
        "select count(*), count(o_orderkey), count(l_quantity), "
        "sum(l_quantity) from orders full join lineitem on o_orderkey = "
        "l_orderkey and l_quantity > 40", ("joins",)),
    "single": (
        "select count(*), count(c), sum(c) from (select (select o_custkey "
        "from orders where o_orderkey = l_orderkey) as c from lineitem) t",
        ("joins",)),
    "count_distinct": (
        "select count(*), sum(c1), sum(c2) from (select l_orderkey, "
        "count(distinct l_linestatus) as c1, count(*) as c2 from lineitem "
        "group by l_orderkey) t", ("groupbys",)),
    "sum_distinct": (
        "select l_suppkey, sum(distinct l_quantity), min(l_quantity), "
        "count(distinct l_quantity) from lineitem group by l_suppkey "
        "order by l_suppkey", ("groupbys",)),
    "sort_desc": (
        "select l_quantity, l_orderkey, l_linenumber from lineitem order by "
        "l_quantity desc, l_orderkey, l_linenumber", ("sorts",)),
    "sort_asc": (
        "select o_totalprice, o_orderkey from orders order by o_totalprice, "
        "o_orderkey", ("sorts",)),
    "skewed_probe": (
        "select o_custkey, count(*), max(l_shipdate) from lineitem, orders "
        "where (case when l_linenumber > 1 then 1 else l_orderkey end) = "
        "o_orderkey group by o_custkey order by o_custkey",
        ("joins", "skew_splits")),
    # not among the JAX package's: a window function over a filtered
    # lineitem has no sharded form, so the scan's survivors leave the mesh
    # in one gather (the only statement without an exchange)
    "window_gather": (
        "select l_orderkey, l_linenumber, rank() over (order by "
        "l_extendedprice desc, l_orderkey, l_linenumber) from lineitem where "
        "l_quantity < 2 and l_discount = 0.1 order by l_orderkey, "
        "l_linenumber", ("gathers",)),
}


def same_table(got, want) -> bool:
    """Two ResultTables equal column by column: the same rows in the same
    order, integers and codes exact, floats within FLOAT_REL (no validity
    mask: every row valid)."""
    import numpy as np

    if got.num_rows != want.num_rows or list(got.names) != list(want.names):
        return False
    for a, b, va, vb in zip(got.columns, want.columns, got.valids, want.valids):
        a, b = np.asarray(a), np.asarray(b)
        va = np.ones(a.shape[0], bool) if va is None else np.asarray(va)
        vb = np.ones(b.shape[0], bool) if vb is None else np.asarray(vb)
        if not np.array_equal(va, vb):
            return False
        a, b = np.where(va, a, 0), np.where(vb, b, 0)  # NULLs hold anything
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            if not np.allclose(a, b, rtol=FLOAT_REL, atol=0.0, equal_nan=True):
                return False
        elif not np.array_equal(a, b):
            return False
    return True


def mesh_phase(torch, pg, gpu_profile, gpu, launches, smi_line, sqls):
    """Phase 12 (see the module docstring)."""
    from lingodb_tpu_torch.parallel import shuffle as sh
    from lingodb_tpu_torch.parallel.mesh import Mesh
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.utils.settings import SHUFFLE_MIN_ROWS

    t_phase = time.perf_counter()
    if dv.get_mesh() is not None and torch.cuda.device_count() < 2:
        fail("a mesh on one card without being asked for")
    mesh = Mesh([gpu.device] * MESH_POSITIONS)
    freeze_heap()
    stmts = {f"q{q}": (sqls[q], ()) for q in MESH_QUERIES}
    stmts.update(MESH_STATEMENTS)
    p12: dict = {}
    moved_all = {k: 0 for k in sh.STATS}
    report = {"device": smi_line, "positions": MESH_POSITIONS,
              "shuffle_min_rows": SHUFFLE_MIN_ROWS.get(), "statements": {}}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    old = dv._MESH, dv._MESH_INIT
    try:
        for name, (sql, must) in stmts.items():
            # one card: every strategy on, get_mesh() is None
            dv._MESH, dv._MESH_INIT = None, True
            want = gpu.sql(sql)
            _, one_ms = timed(lambda: gpu.sql(sql))
            one_syncs, one_peak, _ = gpu_profile.syncs_and_peak(
                torch, lambda: gpu.sql(sql))
            # the mesh, the fused programs declined (the JAX package's
            # test_mesh_sf1.py): every kernel call checked, then timed
            dv._MESH = mesh
            with gpu_profile.eager_path():
                before = dict(sh.STATS)
                got, counts, nchk = run_checked(torch, pg,
                                                lambda: gpu.sql(sql))
                moved = {k: sh.STATS[k] - before[k] for k in sh.STATS}
                again, mesh_ms = timed(lambda: gpu.sql(sql))
                mesh_syncs, mesh_peak, _ = gpu_profile.syncs_and_peak(
                    torch, lambda: gpu.sql(sql))
            dv._MESH = None
            for k, v in counts.items():
                p12[k] = p12.get(k, 0) + v
            for k, v in moved.items():
                moved_all[k] += v
            if not want.num_rows:
                fail(f"mesh {name}: empty result")
            if not same_table(got, want) or not same_table(again, want):
                fail(f"mesh {name}: rows on the mesh differ from the one-card "
                     f"session's\nmesh={got.format_rows()[:3]}\n"
                     f"one card={want.format_rows()[:3]}")
            missed = [k for k in must if not moved[k]]
            if "gathers" not in must and not moved["exchanges"]:
                missed.append("exchanges")
            if missed:
                fail(f"mesh {name}: strategies {missed} did not engage "
                     f"({moved})")
            rec = {"rows": want.num_rows, "one_card_ms": one_ms,
                   "one_card_syncs": one_syncs,
                   "one_card_peak_mib": one_peak / 2**20, "mesh_ms": mesh_ms,
                   "mesh_syncs": mesh_syncs, "mesh_peak_mib": mesh_peak / 2**20,
                   "stats": moved, "launches": counts, "checked": nchk}
            report["statements"][name] = rec
            log(f"# mesh {name}: rows={want.num_rows} wall_ms one card "
                f"{one_ms:.2f} / mesh {mesh_ms:.2f} (second runs); syncs "
                f"{one_syncs} / {mesh_syncs}; peak_mib {one_peak / 2**20:.1f} / "
                f"{mesh_peak / 2**20:.1f}; stats {json.dumps(moved)}; "
                f"launches {json.dumps(counts)} checked={nchk}")
    finally:
        dv._MESH, dv._MESH_INIT = old
    idle = [k for k, v in moved_all.items() if not v]
    if idle:
        fail(f"mesh: strategies that never engaged: {idle}")
    for k in ("K2", "K3"):
        if not p12.get(k):
            fail(f"mesh: {k} never launched on the sharded path")
    launches["p12"] = {"gather_chunked": p12.get("K1", 0),
                       "gather_sorted": p12.get("K2", 0),
                       "compact_positions": p12.get("K3", 0)}
    report["launches"] = p12
    report["stats"] = moved_all
    report["seconds"] = time.perf_counter() - t_phase
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "mesh_phase.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"# p12 launches (K1, K2, K3 over phase 12, each call checked): "
        f"{json.dumps(p12)}; stats {json.dumps(moved_all)}")
    log(f"# mesh: phase 12 took {report['seconds']:.1f}s ({smi_line}; "
        f"{MESH_POSITIONS} positions on one card, shuffle_min_rows "
        f"{SHUFFLE_MIN_ROWS.get()})")


# ---- phase 12 (b): the general-mode fused aggregate over tables held on
# the mesh: gathered once, the one-card program (its graph) over them.
# name -> (sql, whether its plan must be marked for the gathered program)
GENERAL_STATEMENTS = {
    # string keys, 150,000 names at SF1: past the dense limit (65,536)
    "names": ("select c_name, count(*), sum(c_acctbal) from customer, nation "
              "where c_nationkey = n_nationkey and n_name <> 'CHINA' group "
              "by c_name order by c_name", True),
    # a decimal key over supplier (10,000 rows at SF1: held sharded, below
    # system.shuffle_min_rows)
    "acctbal": ("select s_acctbal, count(*) from supplier group by "
                "s_acctbal order by s_acctbal", True),
    # the optimizer groups orders by o_custkey below the join (a sharded
    # grouping), so the fused aggregate's base is that grouping's result,
    # not a table held on the mesh: the one-card program, unmarked
    "names_over_orders": ("select c_name, sum(o_totalprice) from orders, "
                          "customer where o_custkey = c_custkey group by "
                          "c_name order by c_name", False),
}


def general_mesh_phase(torch, pg, gpu_profile, gpu, launches, smi_line):
    """Phase 12 (b) (see the module docstring)."""
    from lingodb_tpu_torch.parallel import shuffle as sh
    from lingodb_tpu_torch.parallel.mesh import Mesh
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.utils import compilestats

    t_phase = time.perf_counter()
    mesh = Mesh([gpu.device] * MESH_POSITIONS)
    freeze_heap()
    p12b: dict = {}
    report = {"device": smi_line, "positions": MESH_POSITIONS,
              "statements": {}, "tpch_marked": []}

    def marks():
        return sum(1 for k in gpu.stage_cache if isinstance(k, tuple)
                   and k and k[0] == "fused_mesh_general")

    def run(sql):
        """(rows, wall ms, captures, replays, gathers) of one run."""
        c0, g0 = compilestats.snapshot(), sh.STATS["gathers"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gpu.sql(sql)
        torch.cuda.synchronize()
        d = compilestats.delta(c0)
        return (out, (time.perf_counter() - t0) * 1e3, d["captures"],
                d["replays"], sh.STATS["gathers"] - g0)

    old = dv._MESH, dv._MESH_INIT
    try:
        for name, (sql, marked) in GENERAL_STATEMENTS.items():
            dv._MESH, dv._MESH_INIT = None, True
            want = gpu.sql(sql)
            one_ms = run(sql)[1]
            dv._MESH = mesh
            m0 = marks()
            # the first run with every kernel call checked (uncaptured:
            # a replay calls no wrapper), then captured, then replayed
            with gpu_profile.uncaptured_path():
                got, counts, nchk = run_checked(torch, pg,
                                                lambda: gpu.sql(sql))
            second = run(sql)
            third = run(sql)
            syncs, peak, _ = gpu_profile.syncs_and_peak(
                torch, lambda: gpu.sql(sql))
            with gpu_profile.eager_path():
                gpu.sql(sql)
                eager = run(sql)
                eager_syncs, _p, _ = gpu_profile.syncs_and_peak(
                    torch, lambda: gpu.sql(sql))
            set_mark = marks() > m0
            dv._MESH = None
            for k, v in counts.items():
                p12b[k] = p12b.get(k, 0) + v
            for out in (got, second[0], third[0], eager[0]):
                if not same_table(out, want):
                    fail(f"mesh (b) {name}: rows differ from the one-card "
                         f"session's\nmesh={out.format_rows()[:3]}\n"
                         f"one card={want.format_rows()[:3]}")
            if set_mark != marked:
                fail(f"mesh (b) {name}: plan marked for the gathered program "
                     f"{set_mark}, expected {marked}")
            if marked and (third[4], third[2], third[3]) != (1, 0, 1):
                fail(f"mesh (b) {name}: a replayed run made gathers, "
                     f"captures, replays {third[4]}, {third[2]}, {third[3]}; "
                     f"expected 1, 0, 1")
            rec = {"rows": want.num_rows, "marked": set_mark,
                   "one_card_ms": one_ms, "mesh_ms": third[1],
                   "eager_ms": eager[1], "syncs": syncs,
                   "eager_syncs": eager_syncs, "peak_mib": peak / 2**20,
                   "captures_replays_gathers": [list(second[2:]),
                                                list(third[2:])],
                   "eager_gathers": eager[4], "launches": counts,
                   "checked": nchk}
            report["statements"][name] = rec
            log(f"# mesh (b) {name}: rows={want.num_rows} marked={set_mark} "
                f"wall_ms one card {one_ms:.2f} / gathered {third[1]:.2f} / "
                f"eager {eager[1]:.2f}; syncs {syncs} / eager {eager_syncs}; "
                f"captures, replays, gathers: run 2 {list(second[2:])}, run 3 "
                f"{list(third[2:])}, eager {eager[4]}; peak_mib "
                f"{peak / 2**20:.1f}; launches {json.dumps(counts)} "
                f"checked={nchk}")
        # which of the 22 TPC-H queries take the gathered program on the mesh
        for q in range(1, 23):
            sql = open(f"queries/tpch/{q}.sql").read()
            dv._MESH, dv._MESH_INIT = None, True
            want = gpu.sql(sql)
            dv._MESH = mesh
            m0 = marks()
            got = gpu.sql(sql)
            dv._MESH = None
            if not same_table(got, want):
                fail(f"mesh (b) q{q}: rows differ from the one-card "
                     f"session's")
            if marks() > m0:
                report["tpch_marked"].append(q)
        log(f"# mesh (b) TPC-H queries marked for the gathered program at "
            f"this scale: {report['tpch_marked'] or 'none'} (all 22 equal "
            f"the one-card session's)")
    finally:
        dv._MESH, dv._MESH_INIT = old
    launches["p12b"] = {"gather_chunked": p12b.get("K1", 0),
                        "gather_sorted": p12b.get("K2", 0),
                        "compact_positions": p12b.get("K3", 0)}
    report["launches"] = p12b
    report["seconds"] = time.perf_counter() - t_phase
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "general_mesh.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"# p12b launches (K1, K2, K3 over phase 12 (b), each call "
        f"checked): {json.dumps(p12b)}")
    log(f"# mesh (b): phase 12 (b) took {report['seconds']:.1f}s "
        f"({smi_line}; {MESH_POSITIONS} positions on one card)")


# ---- phase 13: base tables held sharded at upload, the fused aggregate
# position by position over SF10 lineitem
UPLOAD_TOPK = ("select l_extendedprice, l_shipdate, l_quantity from lineitem "
               "where l_quantity < 3 order by l_extendedprice desc, "
               "l_shipdate, l_quantity limit 20")


def held_bytes(dev_t) -> tuple:
    """(bytes of base columns a position holds, at most; bytes of the same
    columns whole, as the table stores them) of a _LazyDeviceTable held on
    the mesh."""
    import numpy as np

    from lingodb_tpu_torch.parallel.mesh import Sharded

    per_pos, whole = {}, 0
    for key, c in dev_t._cols.items():
        parts = [c] if isinstance(c, Sharded) else [c.data, c.valid]
        for x in parts:
            if isinstance(x, Sharded):
                for i, t in enumerate(x.shards):
                    per_pos[i] = per_pos.get(i, 0) + t.nbytes
        if key != "__pad_mask__":
            col = dev_t._storage.column(key)
            whole += sum(np.asarray(x).nbytes for x in (col.data, col.valid)
                         if x is not None)
    return max(per_pos.values(), default=0), whole


def upload_phase(torch, pg, ldb, gpu_profile, device, sf, seed, launches,
                 smi_line):
    """Phase 13 (see the module docstring)."""
    from lingodb_tpu_torch.parallel import shuffle as sh
    from lingodb_tpu_torch.parallel.mesh import Mesh
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.tools import tpchbig
    from lingodb_tpu_torch.utils import compilestats

    t_phase = time.perf_counter()
    table = tpchbig.generate(10 * sf, seed)
    rows = table.num_rows
    s = ldb.create_in_memory(device=device)
    tpchbig.install(s, table)
    mesh = Mesh([device] * MESH_POSITIONS)
    freeze_heap()
    p13: dict = {}
    report = {"device": smi_line, "rows": rows, "positions": MESH_POSITIONS,
              "statements": {}}
    old = dv._MESH, dv._MESH_INIT

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    try:
        for name, sql in (("q1", open("queries/tpch/1.sql").read()),
                          ("q6", open("queries/tpch/6.sql").read()),
                          ("topk_gather", UPLOAD_TOPK)):
            fused = name != "topk_gather"
            dv._MESH, dv._MESH_INIT = None, True
            want = s.sql(sql).format_rows()  # uploads, captures
            _, one_ms = timed(lambda: s.sql(sql).format_rows())
            one_syncs, one_peak, _ = gpu_profile.syncs_and_peak(
                torch, lambda: s.sql(sql).format_rows())
            pool_one = s.exestore.pool_memory()[0]
            dv._MESH = mesh
            # the uncaptured run: every kernel call checked
            before = dict(sh.STATS)
            with gpu_profile.uncaptured_path():
                got, counts, nchk = run_checked(
                    torch, pg, lambda: s.sql(sql).format_rows())
            moved = {k: sh.STATS[k] - before[k] for k in sh.STATS}
            # captured on the first run, replayed on the second
            caps = []
            for _run in range(2):
                c0 = compilestats.snapshot()
                again = s.sql(sql).format_rows()
                d = compilestats.delta(c0)
                caps.append((d["captures"], d["replays"]))
                if again != want:
                    fail(f"upload {name}: a captured run's rows differ")
            again, mesh_ms = timed(lambda: s.sql(sql).format_rows())
            mesh_syncs, mesh_peak, _ = gpu_profile.syncs_and_peak(
                torch, lambda: s.sql(sql).format_rows())
            pool_mesh = s.exestore.pool_memory()[0]
            dv._MESH = None
            for k, v in counts.items():
                p13[k] = p13.get(k, 0) + v
            if not want or got != want or again != want:
                fail(f"upload {name}: rows on the mesh differ from the "
                     f"one-card session's resident run\nmesh={got[:2]}\n"
                     f"one card={want[:2]}")
            # (a capture on the card is replayed at once: the first run
            # also counts its replays)
            if fused and (caps[0][0] != MESH_POSITIONS
                          or caps[1] != (0, MESH_POSITIONS)):
                fail(f"upload {name}: captures / replays {caps}, not one "
                     f"graph a position captured then replayed")
            if fused and any(moved.values()):
                fail(f"upload {name}: the fused aggregate moved {moved}")
            if not fused and (moved["gathers"] != 1 or not p13.get("K3")):
                fail(f"upload {name}: gathers {moved['gathers']}, K3 "
                     f"{p13.get('K3')}: the input did not leave the mesh once "
                     f"through the positions' compactions")
            per_pos, whole = held_bytes(s.device_table("lineitem"))
            rec = {"rows": len(want), "one_card_ms": one_ms,
                   "mesh_ms": mesh_ms, "one_card_syncs": one_syncs,
                   "mesh_syncs": mesh_syncs,
                   "one_card_peak_mib": one_peak / 2**20,
                   "mesh_peak_mib": mesh_peak / 2**20,
                   "pool_mib_one_card": pool_one / 2**20,
                   "pool_mib_after_mesh": pool_mesh / 2**20,
                   "captures_replays": caps, "stats": moved,
                   "launches": counts, "checked": nchk,
                   "held_bytes_a_position": per_pos,
                   "held_bytes_whole": whole}
            report["statements"][name] = rec
            log(f"# upload {name}: rows={len(want)} wall_ms one card "
                f"{one_ms:.2f} / mesh {mesh_ms:.2f} (second replayed runs); "
                f"syncs {one_syncs} / {mesh_syncs}; peak_mib "
                f"{one_peak / 2**20:.1f} / {mesh_peak / 2**20:.1f}; graph "
                f"pool MiB {pool_one / 2**20:.1f} one card, "
                f"{pool_mesh / 2**20:.1f} after the mesh's graphs; captures/"
                f"replays {caps}; gathers {moved['gathers']}; lineitem's "
                f"base columns held {per_pos} bytes a position against "
                f"{whole} whole; launches {json.dumps(counts)} "
                f"checked={nchk}")
    finally:
        dv._MESH, dv._MESH_INIT = old
        s._evict_device_memory()
        del s, table
        torch.cuda.empty_cache()
    launches["p13"] = {"gather_chunked": p13.get("K1", 0),
                       "gather_sorted": p13.get("K2", 0),
                       "compact_positions": p13.get("K3", 0)}
    report["launches"] = p13
    report["seconds"] = time.perf_counter() - t_phase
    with open(os.path.join("chiprun_out", "upload_phase.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"# p13 launches (K1, K2, K3 over phase 13, each call checked): "
        f"{json.dumps(p13)}")
    log(f"# upload: phase 13 took {report['seconds']:.1f}s ({smi_line}; "
        f"lineitem {rows} rows over {MESH_POSITIONS} positions on one card)")


def processes_phase(torch, smi_line):
    """Phase 14 (see the module docstring)."""
    from lingodb_tpu_torch.tools import mesh_procs

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"# processes: NOT RUN: {cards} card; the mesh across processes "
            f"runs one process a card under NCCL, which takes one card a "
            f"rank (its CPU form runs in tests/test_torch_multiprocess.py)")
        return
    t0 = time.perf_counter()
    reps = mesh_procs.launch(world=2, positions=1, device="cuda", sf=0.05,
                             timeout_s=60.0, limit_s=480.0,
                             out_dir="chiprun_out")
    for rep in reps:
        bad = [k for k, v in rep["functions"].items() if not v]
        if rep["backend"] != "nccl" or bad:
            fail(f"processes: rank {rep['rank']} backend {rep['backend']}, "
                 f"functions unequal to the one-process mesh: {bad}")
        for name, g in rep["sql"].items():
            if not g["equal"] or not g["rows"]:
                fail(f"processes: rank {rep['rank']} {name}: rows differ "
                     f"from the one-process mesh's")
    for name in reps[0]["sql"]:
        if len({rep["sql"][name]["digest"] for rep in reps}) != 1:
            fail(f"processes: {name}: the processes returned other rows")
    log(f"# processes: 2 processes x 1 card under NCCL: "
        f"{len(reps[0]['functions'])} functions and "
        f"{len(reps[0]['sql'])} statements equal to the one-process mesh on "
        f"both ({time.perf_counter() - t0:.1f}s; {smi_line})")


def freeze_heap() -> None:
    """Collect, then move every object the process holds into the cyclic
    garbage collector's permanent generation (gc.freeze), so that a
    generation-2 collection during the timed runs after it scans only
    what they made. The process holds some 400,000 tracked objects by
    phase 10 (the tables, the sessions, the rows kept to compare), and a
    collection over all of them took 213-238 ms on the card's host: one
    landing inside a timed run was C5's spike."""
    gc.collect()
    gc.freeze()


class GcPauses:
    """Within the block: the ms the cyclic garbage collector ran and its
    collections by generation (gc.callbacks)."""

    def __init__(self):
        self.ms = 0.0
        self.by_gen = [0, 0, 0]
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.by_gen[info["generation"]] += 1

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def front_and_execution(torch, session, sql) -> tuple:
    """(ms to parse, bind and optimize, ms to execute and format the rows,
    ms of garbage collection in the execution, its generation-2
    collections, the execution's compilestats delta and the process's CPU
    ms in it) of one run: Session.prepare, then Session.execute_prepared."""
    from lingodb_tpu_torch.utils import compilestats

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepared = session.prepare(sql)
    t1 = time.perf_counter()
    cs0 = compilestats.snapshot()
    cpu0 = time.process_time()
    with GcPauses() as pauses:
        session.execute_prepared(prepared).format_rows()
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    d = compilestats.delta(cs0)
    counts = {k: d[k] for k in ("captures", "replays", "calibrations",
                                "uploads", "evictions")}
    counts["cpu_ms"] = round((time.process_time() - cpu0) * 1e3, 2)
    return ((t1 - t0) * 1e3, (t2 - t1) * 1e3, pauses.ms, pauses.by_gen[2],
            counts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--seed", type=int, default=19920601)
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch

    # ---- phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"# device: {smi_line}")

    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.ops import cuda_build
    from lingodb_tpu_torch.ops import pgather as pg
    from lingodb_tpu_torch.tools import tpchgen

    # ---- phase 2: build
    cuda_build.build_all()
    log(f"# build: {len(cuda_build.SOURCES)} kernels in "
        f"{cuda_build.build_seconds:.1f}s -> {cuda_build.BUILD_DIR}")

    # ---- data (needed for the kernels' shapes and for the queries)
    t0 = time.perf_counter()
    tables = tpchgen.generate(args.sf, args.seed)
    n_li = tables["lineitem"].num_rows
    log(f"# data: TPC-H sf={args.sf:g} seed={args.seed}, lineitem={n_li} rows, "
        f"generated in {time.perf_counter() - t0:.1f}s")
    if n_li < 1_000_000:
        fail("lineitem below 1M rows: not a size the main path is meant for")

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 3")
    # ---- phase 3: kernels against their plain versions
    cases: list = []
    pg.reset_counters()
    mask = check_compact(torch, pg, n_li, cases)
    check_sorted(torch, pg, n_li, mask, cases)
    check_chunked(torch, pg, n_li, cases)
    check_segscan(torch, pg, n_li, cases)
    for c in cases:
        if "ms" not in c:
            log(f"# kernel {c['name']} {c['shape']}: max_abs_err "
                f"{c['max_abs_err']}")
            continue
        log(f"# kernel {c['name']} {c['shape']}: {c['ms']:.4f} ms "
            f"(on the card {c['device_ms']:.4f} ms), plain "
            f"{c['plain_ms']:.4f} ms, library {fmt_ms(c['library_ms'])} ms "
            f"(on the card {fmt_ms(c['library_device_ms'])} ms), "
            f"bound {c['bound_ms']:.4f} ms"
            + (f", sector floor {c['floor_ms']:.4f} ms" if "floor_ms" in c
               else "") + f", max_abs_err {c['max_abs_err']}")
    del mask
    torch.cuda.empty_cache()
    # the checked kernel (phase 15 (a)), timed here while the profiler has
    # traced nothing else
    check_checked_arith(torch, n_li, cases)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 4")
    # ---- phase 4: main path, on the fused program and on the eager operators
    import lingodb_tpu_torch.runtime.executor as ex
    from lingodb_tpu_torch.tools import gpu_profile

    gpu = ldb.create_in_memory()
    cpu = ldb.create_in_memory(device="cpu")
    tpchgen.install(gpu, tables)
    tpchgen.install(cpu, tables)
    sqls = {q: open(f"queries/tpch/{q}.sql").read() for q in QUERIES}
    engaged = []
    orig_fused = ex.Executor._try_fused_agg

    def spy(self, op, epi=None):
        r = orig_fused(self, op, epi)
        engaged.append(r is not None)
        return r

    ex.Executor._try_fused_agg = spy
    launches, checked = {}, {}
    want = {q: cpu.sql(sqls[q]).format_rows() for q in QUERIES}
    for path in ("fused", "eager"):
        with gpu_profile.path_context(path):
            pg.reset_counters()  # launches made to compare kernels do not count
            results, hit = {}, {}
            for q in QUERIES:
                engaged.clear()
                results[q] = gpu.sql(sqls[q]).format_rows()
                hit[q] = any(engaged)
            torch.cuda.synchronize()
            launches[path] = dict(pg.LAUNCHES)
            for q in QUERIES:
                if results[q] != want[q]:
                    fail(f"q{q} [{path}]: GPU rows differ from the CPU "
                         f"session's\ngpu={results[q][:3]}\ncpu={want[q][:3]}")
                if not results[q]:
                    fail(f"q{q} [{path}]: empty result")
                if hit[q] != (path == "fused"):
                    fail(f"q{q} [{path}]: fused aggregate engaged={hit[q]}")
            if results["6"] != [[q6_numpy(tables)]]:
                fail(f"q6 [{path}] {results['6']} != numpy {q6_numpy(tables)}")
            for q in QUERIES:
                pg.reset_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = gpu.sql(sqls[q]).format_rows()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = dict(pg.LAUNCHES)
                syncs, peak, resident = gpu_profile.syncs_and_peak(
                    torch, lambda: gpu.sql(sqls[q]).format_rows())
                if rows != results[q]:
                    fail(f"q{q} [{path}]: second run differs from the first")
                SYNCS[f"p4 {path} q{q}"] = {"syncs": syncs,
                                            "launches": counts}
                log(f"# query q{q} [{path}]: rows={len(rows)} wall_ms={ms:.2f} "
                    f"(second run) launches={json.dumps(counts)} syncs={syncs} "
                    f"peak_mib={peak / 2**20:.1f} resident_mib="
                    f"{resident / 2**20:.1f}")
        log(f"# main path launches [{path}] (five queries, first run): "
            f"{json.dumps(launches[path])}")
    # the fused path once more (steady state), every kernel call held
    # against its plain version on the same inputs
    for q in QUERIES:
        shapes: list = []
        with checked_kernel_calls(torch, pg, shapes):
            if gpu.sql(sqls[q]).format_rows() != want[q]:
                fail(f"q{q} [fused, checked]: GPU rows differ from the CPU "
                     "session's")
        log(f"# fused kernel calls q{q} (each equal to its plain version): "
            + ("; ".join(f"{k} {sh}" for k, sh in shapes) or "none"))
        for k, _sh in shapes:
            checked[k] = checked.get(k, 0) + 1
    ex.Executor._try_fused_agg = orig_fused
    missing = [k for k, p in MAIN_PATH.items()
               if p == "fused" and launches["fused"][k] == 0]
    if missing:
        fail(f"kernels never launched by the fused path: {missing}")
    unchecked = [k for k, p in MAIN_PATH.items()
                 if p == "fused" and not checked.get(k)]
    if unchecked:
        fail(f"kernels never checked at the fused path's shapes: {unchecked}")

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 4b")
    # ---- phase 4b: the fused TopK and the fused chain
    cpu_rows: dict = {}
    chain_checked = topk_chain_phase(torch, pg, ex, gpu_profile, gpu, cpu,
                                     launches, cpu_rows)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 5")
    # ---- phase 5: the other 17 TPC-H queries, card against CPU session
    for q in [str(i) for i in range(1, 23) if str(i) not in QUERIES]:
        sql = open(f"queries/tpch/{q}.sql").read()
        t0 = time.perf_counter()
        got = gpu.sql(sql).format_rows()
        ms = (time.perf_counter() - t0) * 1e3
        if got != (cpu_rows.get(q) or cpu.sql(sql).format_rows()):
            fail(f"q{q}: GPU rows differ from the CPU session's")
        log(f"# extra query q{q}: rows={len(got)} wall_ms={ms:.2f} (first run)")

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 6")
    # ---- phase 6: SQL battery with every column on the tensor tier
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.tools import sql_battery

    small_rows = dv.SMALL_ROWS
    dv.SMALL_ROWS = 2  # small tables would otherwise stay numpy on the host
    gpu_b = ldb.create_in_memory()
    cpu_b = ldb.create_in_memory(device="cpu")
    for stmt in sql_battery.SETUP:
        gpu_b.sql_stmt(stmt)
        cpu_b.sql_stmt(stmt)
    for q in sql_battery.QUERIES:
        if gpu_b.sql(q).format_rows() != cpu_b.sql(q).format_rows():
            fail(f"battery: GPU rows differ from the CPU session's: {q}")
    log(f"# battery: {len(sql_battery.QUERIES)} statements equal on card and CPU")
    dv.SMALL_ROWS = small_rows

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 6 (b)")
    # ---- phase 6 (b): statements held against sqlite3 as well
    sqlite_phase(torch, pg, ldb, launches)
    fused_error_part(torch, gpu, cpu)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 7")
    # ---- phase 7: the kernel bench, the entry point that runs segscan
    t0 = time.perf_counter()
    kb = subprocess.run([sys.executable, "-m", "lingodb_tpu_torch.tools.kbench",
                         "--quick"], capture_output=True, text=True, timeout=900)
    for line in kb.stdout.splitlines()[:-1]:
        log(f"# kbench {line}")
    if kb.returncode != 0:
        fail(f"kbench exited {kb.returncode}: {kb.stderr[-2000:]}")
    kb_out = json.loads(kb.stdout.splitlines()[-1])
    launches["kbench"] = kb_out["launches"]
    for case, shape in (("k4_segscan_w2", "runs of 4"),
                        ("k4_segscan_onerun", "one run")):
        k4 = next(c for c in kb_out["cases"] if c["name"] == case)
        cases.append({"name": "segscan", "shape": f"n={kb_out['n']} W=2 "
                      f"{shape} (kernel bench)", "max_abs_err": 0,
                      "ms": k4["ms"], "device_ms": k4["card_ms"],
                      "plain_ms": k4["plain_ms"], "library_ms": None,
                      "library_device_ms": None, "bound_ms": k4["bound_ms"],
                      "bound_by": "bytes", "bytes": k4["bytes"]})
    # compact_positions at the fused queries' shapes, held bit for bit
    # against the plain version (the bench exits non-zero on a difference)
    # and timed by the kernel bench
    for c in kb_out["cases"]:
        if c["name"].startswith("k3_compact_q"):
            cases.append({"name": "compact_positions",
                          "shape": f"{c['name']} (kernel bench)",
                          "max_abs_err": 0,
                          "ms": c["ms"], "device_ms": c["card_ms"],
                          "plain_ms": c["plain_ms"], "library_ms": None,
                          "library_device_ms": None, "bound_ms": c["bound_ms"],
                          "bound_by": "bytes", "bytes": c["bytes"]})
    log(f"# kbench: {time.perf_counter() - t0:.1f}s, launches "
        f"{json.dumps(launches['kbench'])}")
    if not launches["kbench"]["segscan"]:
        fail("segscan never launched by the kernel bench")

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 8")
    # ---- phase 8: the substrate bench, the entry point that runs T1-T7
    t0 = time.perf_counter()
    from lingodb_tpu_torch.ops import substrate as sb

    check_substrate_edges(torch, sb)
    log(f"# substrate edges: every kernel equal to its plain version "
        f"({time.perf_counter() - t0:.1f}s)")
    sub = subprocess.run([sys.executable, "-m",
                          "lingodb_tpu_torch.tools.substrate_bench", "--quick"],
                         capture_output=True, text=True, timeout=600)
    for line in sub.stdout.splitlines()[:-1]:
        log(f"# substrate {line}")
    if sub.returncode != 0:
        fail(f"substrate_bench exited {sub.returncode}: {sub.stderr[-2000:]}")
    sub_out = json.loads(sub.stdout.splitlines()[-1])
    bad = [c["name"] for c in sub_out["cases"] if not c["correct"]]
    if bad:
        fail(f"substrate_bench: {bad} differ from their plain versions")
    unlaunched = [k for k, v in sub_out["launches"].items() if not v]
    if unlaunched:
        fail(f"kernels never launched by the substrate bench: {unlaunched}")
    launches["substrate"] = {}
    for name, (row, kernel, _head) in SUBSTRATE_ROWS.items():
        mine = [c for c in sub_out["cases"] if c["row"] == row]
        if not mine or any(c["kernel"] != kernel for c in mine):
            fail(f"substrate_bench: no {row} case on {kernel}")
        launches["substrate"][name] = sum(c["launches"] for c in mine)
        if not launches["substrate"][name]:
            fail(f"{name} ({row}) never launched by the substrate bench")
        cases.extend({"name": name, "shape": f"{c['name']} (substrate bench)",
                      "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                      "device_ms": c["card_ms"], "plain_ms": c["plain_ms"],
                      "library_ms": c["library_ms"],
                      "library_device_ms": c["library_card_ms"],
                      "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                      "bytes": c["bytes"]} for c in mine)
    log(f"# substrate: {time.perf_counter() - t0:.1f}s, launches "
        f"{json.dumps(sub_out['launches'])}")

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 9")
    # ---- phase 9: the executor slice
    executor_slice_phase(torch, pg, ldb, gpu_profile, gpu, cpu, tables, args,
                         launches, smi_line)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 10")
    # ---- phase 10: the fused programs as CUDA graphs
    cpu_rows.update(want)
    graphs_phase(torch, pg, ldb, gpu_profile, gpu, cpu, tables, cpu_rows,
                 torch.rand(n_li, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(3)))

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 11")
    # ---- phase 11: UDFs, the CLI, the sqlite3 oracle, the runner, TPC-DS
    tools_phase(torch, pg, ldb, ex, gpu_profile, gpu, cpu, tables, args,
                launches)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 12")
    # ---- phase 12: the sharded operators over a mesh of 8 positions
    mesh_phase(torch, pg, gpu_profile, gpu, launches, smi_line,
               {q: open(f"queries/tpch/{q}.sql").read() for q in MESH_QUERIES})

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 12 (b)")
    # ---- phase 12 (b): the general-mode fused aggregate on the mesh
    general_mesh_phase(torch, pg, gpu_profile, gpu, launches, smi_line)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 13")
    # ---- phase 13: base tables held sharded at upload, SF10 q1 and q6
    upload_phase(torch, pg, ldb, gpu_profile, gpu.device, args.sf, args.seed,
                 launches, smi_line)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 14")
    # ---- phase 14: the mesh across processes (two or more cards)
    processes_phase(torch, smi_line)

    log(f"# at {time.perf_counter() - t_start:.1f}s: phase 15")
    # ---- phase 15: arithmetic past int64 ((a), the kernel, ran in phase 3)
    wide_phase(torch, pg, gpu, cpu, launches, smi_line)

    # ---- report
    headline = {"compact_positions": "sel=0.5", "gather_sorted": "C=2",
                "gather_chunked": "s=10000 n=%d C=1" % n_li,
                "segscan": "kernel bench",
                **{name: head for name, (_r, _k, head) in SUBSTRATE_ROWS.items()},
                "checked_arith": "variance"}
    kernels = []
    for name, meta in KERNEL_META.items():
        mine = [c for c in cases if c["name"] == name]
        head = next(c for c in mine if headline[name] in c["shape"])
        kernels.append({
            "name": name, **meta,
            "launches": launches[MAIN_PATH[name]][name],
            "launches_by_path": {p: launches[p].get(name, 0) for p in launches},
            "chain_calls_checked": chain_checked.get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head.get("bound_by",
                                                                "bytes"),
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
            "shape": head["shape"],
            "cases": mine,
        })
    log("# main path syncs and launches (phase 4 second runs, phase 10 "
        "replays): " + json.dumps({k: v for k, v in SYNCS.items()
                                   if k.split()[-1][1:] in QUERIES}))
    log(f"# total {time.perf_counter() - t_start:.1f}s")
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
