"""Native host-runtime bindings.

Compiles runtime.cpp with g++ on first use (cached by source hash under
.cache/native/) and binds via ctypes. Mirrors the role of the reference's
C++ runtime library that generated code calls through its FFI
(reference: src/runtime/, tools/build-tools/runtime-header-tool.cpp); here
Python orchestration calls these for the host data plane. Falls back to
None (callers use Python paths) if no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("LINGODB_NATIVE", "").upper() == "OFF":
        return None
    src_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runtime.cpp")
    try:
        src = open(src_path, "rb").read()
        h = hashlib.sha256(src).hexdigest()[:16]
        cache = os.path.join(_root(), ".cache", "native")
        so = os.path.join(cache, f"lingodb_native_{h}.so")
        if not os.path.exists(so):
            os.makedirs(cache, exist_ok=True)
            tmp = so + ".tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src_path],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        i64, u8p, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
        for name, argt in {
            "format_decimal": [i64p, u8p, i64, ctypes.c_int, ctypes.c_char_p, i64p, i64],
            "format_date32": [ctypes.POINTER(ctypes.c_int32), u8p, i64, ctypes.c_char_p, i64p, i64],
            "format_ts_us": [i64p, u8p, i64, ctypes.c_char_p, i64p, i64],
            "format_int64": [i64p, u8p, i64, ctypes.c_char_p, i64p, i64],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = argt
            fn.restype = i64
        lib.like_match.argtypes = [ctypes.c_char_p, i64p, i64, ctypes.c_char_p,
                                   i64, ctypes.c_char, ctypes.c_int, u8p]
        lib.like_match.restype = None
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def _run_format(fn, data: np.ndarray, valid, extra=()) -> list:
    """Shared helper: call a format_* kernel, return list of str (None for
    invalid positions when valid given)."""
    n = len(data)
    offsets = np.empty(n + 1, np.int64)
    cap = max(32 * n, 1024)
    vptr = None
    if valid is not None:
        varr = np.ascontiguousarray(valid, dtype=np.uint8)
        vptr = varr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    while True:
        buf = ctypes.create_string_buffer(cap)
        need = fn(data.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
                  if data.dtype == np.int64 else
                  data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                  vptr, n, *extra, buf,
                  offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if need <= cap:
            break
        cap = int(need) + 16
    # zero-copy wrap as Arrow large_string, then one C++ conversion to
    # Python strs (an order of magnitude faster than per-value slicing)
    try:
        import pyarrow as pa
    except ImportError:
        raw = buf.raw
        out = [raw[offsets[i]:offsets[i + 1]].decode() for i in range(n)]
        if valid is not None:
            ok = np.asarray(valid, bool)
            out = [s if ok[i] else None for i, s in enumerate(out)]
        return out

    nullbuf = None
    if valid is not None:
        nullbuf = pa.array(np.asarray(valid, bool)).buffers()[1]
    arr = pa.Array.from_buffers(
        pa.large_string(), n,
        [nullbuf, pa.py_buffer(offsets.tobytes()), pa.py_buffer(buf.raw)],
        null_count=-1,
    )
    return arr.to_pylist()


def format_decimal(vals: np.ndarray, valid, scale: int):
    lib = get_lib()
    if lib is None:
        return None
    return _run_format(lib.format_decimal, np.ascontiguousarray(vals, np.int64),
                       valid, (scale,))


def format_date32(days: np.ndarray, valid):
    lib = get_lib()
    if lib is None:
        return None
    return _run_format(lib.format_date32, np.ascontiguousarray(days, np.int32), valid)


def format_ts_us(us: np.ndarray, valid):
    lib = get_lib()
    if lib is None:
        return None
    return _run_format(lib.format_ts_us, np.ascontiguousarray(us, np.int64), valid)


def format_int64(vals: np.ndarray, valid):
    lib = get_lib()
    if lib is None:
        return None
    return _run_format(lib.format_int64, np.ascontiguousarray(vals, np.int64), valid)


def like_match(dictionary: np.ndarray, pattern: str, escape: str | None,
               case_insensitive: bool):
    """Match a LIKE pattern against every dictionary entry. Returns bool
    ndarray or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    enc = [s.encode() for s in dictionary]
    offsets = np.zeros(len(enc) + 1, np.int64)
    for i, b in enumerate(enc):
        offsets[i + 1] = offsets[i] + len(b)
    blob = b"".join(enc)
    out = np.empty(len(enc), np.uint8)
    pat = pattern.encode()
    lib.like_match(blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                   len(enc), pat, len(pat),
                   (escape or "\0").encode()[0:1], int(case_insensitive),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)
