"""Typed, env-bound settings registry.

Equivalent of the reference's GlobalSetting system
(reference: include/lingodb/utility/Setting.h:38-78, src/utility/Setting.cpp):
settings self-register under a dotted key, are initialized from environment
variables named LINGODB_<KEY> (dots -> underscores, leading "system." stripped),
and can be changed at runtime (SQL `SET key = value`).
"""

from __future__ import annotations

import os
import threading

_REGISTRY: dict[str, "Setting"] = {}
_LOCK = threading.Lock()


def _env_name(key: str) -> str:
    k = key
    if k.startswith("system."):
        k = k[len("system."):]
    return "LINGODB_" + k.replace(".", "_").upper()


class Setting:
    def __init__(self, key: str, default, parse=None):
        self.key = key
        self.default = default
        self.parse = parse or type(default)
        self._value = None
        self._has_value = False
        env = os.environ.get(_env_name(key))
        if env is not None:
            self.set(env)
        with _LOCK:
            _REGISTRY[key] = self

    def get(self):
        return self._value if self._has_value else self.default

    def set(self, value):
        if isinstance(value, str) and self.parse is bool:
            value = value.strip().lower() in ("1", "true", "on", "yes")
        elif isinstance(value, str) and self.parse is not str:
            value = self.parse(value)
        self._value = value
        self._has_value = True

    def reset(self):
        self._has_value = False


def set_setting(key: str, value) -> bool:
    s = _REGISTRY.get(key) or _REGISTRY.get("system." + key)
    if s is None:
        return False
    s.set(value)
    return True


def get_setting(key: str):
    s = _REGISTRY.get(key) or _REGISTRY.get("system." + key)
    return s.get() if s else None


def all_settings():
    return dict(_REGISTRY)


# ---- core settings (mirroring reference's ~25 system.* settings) -----------
EXECUTION_MODE = Setting("system.execution_mode", "DEFAULT")
PARALLELISM = Setting("system.parallelism", "")  # "" -> all devices; "OFF" -> 1
TRACE_DIR = Setting("system.trace_dir", "")
SNAPSHOT_PASSES = Setting("system.snapshot_passes", False, bool)
SNAPSHOT_DIR = Setting("system.snapshot_dir", ".")
EAGER_LOADING = Setting("system.eager_loading", False, bool)
OPT_PASSES = Setting("system.opt", "")  # comma list restricting optimizer passes
# iteration cap for Iterate/WITH RECURSIVE (0 = unlimited); the analogue of
# MSSQL's MAXRECURSION — the reference's subop.loop has no cap (explicit
# continue flags), SQL recursion needs a runaway guard
MAX_RECURSION = Setting("system.max_recursion", 10_000, int)
# python UDF execution: "none" = in-process numpy (fastest), "process" =
# persistent isolated worker process (reference: per-worker CPython
# sub-interpreters, Scheduler.cpp:941-954, and the WASM UDF runtime,
# src/runtime/WASM.cpp — crash/hang isolation from user code)
UDF_ISOLATION = Setting("system.udf_isolation", "none")
UDF_MEMORY_MB = Setting("system.udf_memory_mb", 0, int)  # worker RLIMIT_AS
REPORT_TIMES = Setting("sql.report_times", False, bool)
TRACK_TUPLES = Setting("system.track_tuples", False, bool)
JOIN_ORDER = Setting("system.join_order", True, bool)
# device-capacity knobs (no reference equivalent; static-shape device programs)
CAPACITY_SLACK = Setting("system.capacity_slack", 1.25, float)
MIN_CAPACITY = Setting("system.min_capacity", 128, int)
# distributed shuffle: minimum rows on BOTH sides before a join/aggregation
# repartitions by key over the mesh instead of relying on GSPMD placement
SHUFFLE_MIN_ROWS = Setting("system.shuffle_min_rows", 1 << 16, int)
# skew: a destination shard receiving more than this multiple of the mean
# triggers the sampled heavy-hitter split (reference analogue: work stealing)
SHUFFLE_SKEW_FACTOR = Setting("system.shuffle_skew_factor", 4.0, float)
# pipelined multi-query execution: overlap the next query's frontend +
# optimizer + H2D prefetch with the current query's device execution
# (reference: compilation runs inside scheduler tasks, Execution.cpp:294-325)
OVERLAP = Setting("system.overlap", True, bool)
# out-of-core streaming scans: when a query's scan columns exceed this many
# bytes, dense scan+aggregate pipelines stream the base table in chunks
# through device memory instead of uploading whole columns (reference analogue:
# morsel-driven size-oblivious scans, LingoDBTable.cpp:360-470). Default
# sized for a 16 GB accelerator with working-set slack; unmeasured on this card.
DEVICE_BYTE_BUDGET = Setting("system.device_byte_budget", 10 << 30, int)
# learned capacities of the fused programs kept across processes
# (utils/capstore.py): the directory of capacities.json; empty, no store
CAPSTORE_DIR = Setting("system.capstore_dir", "")
# the card's memory bandwidth in GB/s that PERF mode's speed-of-light
# figure (sol) divides bytes by; unset, sol is reported as unknown
HBM_GBPS = Setting("system.hbm_gbps", None, float)
