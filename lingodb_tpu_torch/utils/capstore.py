"""Learned capacities of the fused programs, kept across processes.

The counterpart of lingodb_tpu/utils/capstore.py. A fused program's static
capacities are learned by a count-only calibration run and kept in the
session's stage cache for the process. Kept here too, a FRESH process (or
session) skips the calibration and captures the program at the learned
sizes at once. Keys name the plan, its table versions and the base rows:

  repr((basekey, n))                the aggregate's group capacity kg
  "kbounds::" + repr((basekey, n))  the aggregate's per-key value bounds
                                    (a list, None for a key without), or
                                    False where none is of use
  "stepcaps::" + repr((basekey, n)) survivors of each narrowing join step
                                    ({step index: count}; the aggregate's
                                    and the chain's)
  "outcap::" + repr((basekey, n))   the chain's survivor count

The reference keeps the file beside JAX's compile cache, which the port does
not have: here it is `<system.capstore_dir>/capacities.json`, and with the
setting empty (the default) there is no store, as the reference has none
without a cache directory. A write merges with the file on disk, so
sessions that share the directory keep each other's keys. A file that does
not parse reads as empty: every key a miss.
"""

from __future__ import annotations

import json
import os
import threading

from .settings import CAPSTORE_DIR

_lock = threading.Lock()
_loaded: dict | None = None  # the file's contents as last read or written
_loaded_from: str | None = None


def _path() -> str | None:
    d = CAPSTORE_DIR.get()
    return os.path.join(d, "capacities.json") if d else None


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def _load(path: str) -> dict:
    global _loaded, _loaded_from
    if _loaded is None or _loaded_from != path:
        _loaded, _loaded_from = _read(path), path
    return _loaded


def get(key: str):
    path = _path()
    if path is None:
        return None
    with _lock:
        return _load(path).get(key)


def put(key: str, value) -> None:
    """value: an int or any JSON value (lists, dicts with str keys)."""
    path = _path()
    if path is None:
        return
    with _lock:
        d = _load(path)
        if d.get(key) == value:
            return
        # merge with the file: another session may have written other keys
        # since it was read (ours wins on a conflict)
        d.update({k: v for k, v in _read(path).items() if k not in d})
        d[key] = value
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)


def reset() -> None:
    """Forget the in-memory copy: the next get reads the file again."""
    global _loaded, _loaded_from
    with _lock:
        _loaded, _loaded_from = None, None
