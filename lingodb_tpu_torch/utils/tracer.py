"""Low-overhead event tracing + per-phase timing.

Equivalent of the reference's utility::Tracer
(reference: include/lingodb/utility/Tracer.h:40-90, src/utility/Tracer.cpp) and
execution::TimingProcessor (reference: include/lingodb/execution/Timing.h:14-77).

Events are recorded into thread-local chunked lists and dumped as a Chrome
trace-event JSON file into settings `system.trace_dir` (same idea as the
reference's JSON dump). Phase names match the reference's TimingPrinter so
downstream tooling can consume either engine's output.
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import settings

_local = threading.local()
_all_records = []
_records_lock = threading.Lock()

PHASES = [
    "frontend",
    "QOpt",
    "lowerRelAlg",
    "lowerSubOp",
    "lowerDB",
    "lowerToLLVM",
    "toLLVMIR",
    "llvmOptimize",
    "llvmCodeGen",
    "baselineCodeGen",
    "executionTime",
]


def _chunk():
    if not hasattr(_local, "records"):
        _local.records = []
        with _records_lock:
            _all_records.append(_local.records)
    return _local.records


class Trace:
    """RAII trace event: with Trace("category", "name"): ..."""

    __slots__ = ("category", "name", "meta", "t0")

    def __init__(self, category: str, name: str, meta=None):
        self.category = category
        self.name = name
        self.meta = meta

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _chunk().append(
            (self.category, self.name, self.t0, t1 - self.t0, self.meta)
        )
        return False


def record(category: str, name: str, meta=None):
    t = time.perf_counter_ns()
    _chunk().append((category, name, t, 0, meta))


def dump(path: str | None = None):
    trace_dir = path or settings.TRACE_DIR.get()
    if not trace_dir:
        return None
    os.makedirs(trace_dir, exist_ok=True)
    events = []
    with _records_lock:
        for records in _all_records:
            for cat, name, t0, dur, meta in records:
                ev = {
                    "cat": cat,
                    "name": name,
                    "ph": "X",
                    "ts": t0 / 1000.0,
                    "dur": dur / 1000.0,
                    "pid": os.getpid(),
                    "tid": 0,
                }
                if meta is not None:
                    ev["args"] = {"meta": meta}
                events.append(ev)
    out = os.path.join(trace_dir, f"trace-{os.getpid()}-{int(time.time())}.json")
    with open(out, "w") as f:
        json.dump({"traceEvents": events}, f)
    return out


class Timing:
    """Collects per-phase wall-clock times (reference: Timing.h TimingProcessor)."""

    def __init__(self):
        self.times: dict[str, float] = {}

    def time(self, phase: str):
        return _PhaseTimer(self, phase)

    def add(self, phase: str, seconds: float):
        self.times[phase] = self.times.get(phase, 0.0) + seconds

    def total_compile_ms(self):
        return sum(v for k, v in self.times.items() if k != "executionTime") * 1e3

    def report(self) -> str:
        parts = [f"{k}: {v * 1e3:.2f} ms" for k, v in self.times.items()]
        return ", ".join(parts)


class _PhaseTimer:
    def __init__(self, timing, phase):
        self.timing = timing
        self.phase = phase

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timing.add(self.phase, time.perf_counter() - self.t0)
        return False
