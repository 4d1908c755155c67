"""Counters of the work a query spends before and beside its kernels: the
statements parsed and the plans optimized, the kernel libraries built and
loaded, the fused programs captured as CUDA graphs and replayed, and the
calibration runs that learn their capacities.

The counterpart of lingodb_tpu/utils/compilestats.py, which counts XLA
compiles and compile-cache hits. The port compiles no program: what stands
in for a compile is an nvcc run (ops/cuda_build.py) and a graph capture
(runtime/exestore.py). PERF mode prints a statement's delta
(`# perf captures=...`), and tests assert that a repeated query builds,
captures and calibrates nothing.

  parses, optimizations
                       parse_sql and optimize calls (a query artifact's
                       run makes neither, tools/artifact.py)
  builds, build_secs   nvcc runs and their wall seconds
  loads                kernel libraries loaded into the process
  captures, capture_secs
                       fused programs captured (on a CPU session: taken by
                       the store's stand-in) and the seconds it took
  replays              captured programs replayed
  calibrations         count-only calibration runs of the fused programs
  uploads              table columns copied to the session's device
  evictions            times a session dropped its cached device buffers
                       (an out-of-memory retry, or memory pressure after a
                       statement: Session._evict_device_memory)
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_stats = {"parses": 0, "optimizations": 0, "builds": 0, "build_secs": 0.0,
          "loads": 0, "captures": 0, "capture_secs": 0.0, "replays": 0,
          "calibrations": 0, "uploads": 0, "evictions": 0}


def add(name: str, value=1) -> None:
    with _lock:
        _stats[name] += value


def snapshot() -> dict:
    with _lock:
        return dict(_stats)


def delta(before: dict) -> dict:
    with _lock:
        return {k: _stats[k] - before.get(k, 0) for k in _stats}
