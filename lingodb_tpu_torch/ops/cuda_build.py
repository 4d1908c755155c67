"""Builds the hand-written CUDA kernels under csrc/ and binds them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for sm_90a into its own shared library, loaded with ctypes (no PyTorch
headers: such a file builds in seconds). All sources are compiled at first
use, one nvcc process per source, all started together. Libraries go to
`<checkout>/build/kernels/`, named by a hash of their source, so an unchanged
source is not rebuilt within one checkout.

Nothing here runs at import time: the CPU tests import every module on
machines that have neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils import compilestats

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("compact_positions", "gather_sorted", "gather_chunked", "segscan",
           "table_gather", "tile_gather", "lane_rotsum", "onehot_compact",
           "checked_arith")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
build_seconds = 0.0  # wall time the last build_all() spent compiling


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found: the CUDA kernels can only be built where the CUDA "
        "toolkit is installed")


def _lib_path(name: str) -> Path:
    # a source's headers (csrc/*.cuh) are part of what it builds from
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def loaded() -> dict[str, str]:
    """{source name: hash of the source and flags} of the kernel libraries
    this process has loaded (none on a CPU session)."""
    return {name: _lib_path(name).stem.rsplit("-", 1)[1] for name in _LIBS}


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (where missing) and load every kernel library."""
    global build_seconds
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise KernelBuildError("nvcc failed for " + "\n".join(failures))
    if procs:
        build_seconds = time.perf_counter() - t0
        compilestats.add("builds", len(procs))
        compilestats.add("build_secs", build_seconds)
    for name in SOURCES:
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        compilestats.add("loads")
    _declare(_LIBS)
    return _LIBS


def _declare(libs) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    f = libs["compact_positions"].ldb_compact_positions
    f.argtypes = [vp, i64, vp, i64, vp, vp, i64, vp]
    f.restype = i32
    t = libs["compact_positions"].ldb_compact_tile
    t.argtypes = []
    t.restype = i32
    for lib_name in ("gather_sorted", "gather_chunked"):  # one packed call
        f = getattr(libs[lib_name], f"ldb_{lib_name}")
        f.argtypes = [ctypes.c_char_p]
        f.restype = i32
    f = libs["segscan"].ldb_segscan
    f.argtypes = [vp, i64, vp, vp, vp, vp, i32, vp, vp]
    f.restype = i32
    t = libs["segscan"].ldb_segscan_tile
    t.argtypes = [i32]
    t.restype = i32
    # the substrate kernels (ops/substrate.py)
    for lib_name, fn_name, args in (
            ("table_gather", "ldb_gather_shift", [vp, i64, vp, i64, vp, i32, vp]),
            ("table_gather", "ldb_gather_small", [vp, i64, vp, i64, vp, i32, vp]),
            ("table_gather", "ldb_gather_shift_edges",
             [ctypes.POINTER(i64), i32]),
            ("table_gather", "ldb_gather_shift_plan",
             [i64, i64, i32, ctypes.POINTER(i64)]),
            ("tile_gather", "ldb_lane_gather", [vp, vp, i64, vp, i32, vp]),
            ("tile_gather", "ldb_sublane_gather",
             [vp, i64, vp, i64, vp, i32, vp]),
            ("tile_gather", "ldb_sublane_band_edges",
             [ctypes.POINTER(i64), i32]),
            ("lane_rotsum", "ldb_lane_rotsum", [vp, i64, vp, i32, vp]),
            ("onehot_compact", "ldb_onehot_compact", [vp, vp, i64, vp, vp]),
            # the checked operators (ops/checked.py)
            ("checked_arith", "ldb_checked_arith",
             [i32, i64, vp, i32, i64, vp, i32, i64, vp, i64, i32, i32, i32,
              i64, i64, i32, i32, i32, i32, vp, i32, vp, i32, vp])):
        f = getattr(libs[lib_name], fn_name)
        f.argtypes = args
        f.restype = i32


def lib(name: str) -> ctypes.CDLL:
    return build_all()[name]
