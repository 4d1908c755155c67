"""Large-SF lineitem subset for out-of-core runs (q1/q6 at SF10 and SF100).

Generates ONLY the lineitem columns TPC-H q1 and q6 read -- quantity,
extendedprice, discount, tax, returnflag, linestatus, shipdate -- slice by
slice with bounded temporaries, so SF100 (~600M rows) generates in minutes
inside host RAM. Value distributions follow the same spec rules as
tools/tpchgen.py's lineitem block (quantity U[1,50], discount 0.00-0.10, tax
0.00-0.08, retail price from the part formula, ship/receipt date offsets,
returnflag/linestatus date rules). Strings and the order linkage are
omitted: q1/q6 never read them, and the subset registers as table
`lineitem`, so those queries run verbatim.

The draws are those of the JAX package's generator of the same name, in the
same order, so a given (sf, seed) gives the same bytes in both packages.

The cache is one `.npy` file per column under `.cache/` (no Arrow
dependency); a cached table loads memory-mapped, so the executor's chunked
scan (runtime/executor.py::_try_chunked_agg) copies slices of it into its
pinned staging buffers without first reading the whole table into RAM.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..sql.types import Type
from ..storage.column import Column
from ..storage.table import TableStorage
from .tpchgen import EPOCH, _cache_dir

SLICE = 1 << 24  # 16M rows per generation slice (~1 GB of temporaries)

RF_DICT = np.array(["A", "N", "R"], dtype=object)   # sorted
LS_DICT = np.array(["F", "O"], dtype=object)        # sorted

COLUMNS = [
    ("l_quantity", Type.decimal(15, 2)),
    ("l_extendedprice", Type.decimal(15, 2)),
    ("l_discount", Type.decimal(15, 2)),
    ("l_tax", Type.decimal(15, 2)),
    ("l_returnflag", Type.char(1)),
    ("l_linestatus", Type.char(1)),
    ("l_shipdate", Type.date()),
]
DICTS = {"l_returnflag": RF_DICT, "l_linestatus": LS_DICT}


def _gen_arrays(sf: float, seed: int) -> dict[str, np.ndarray]:
    n_li = int(6_000_000 * sf)
    n_part = max(int(200_000 * sf), 40)
    d0 = (np.datetime64("1992-01-01") - EPOCH).astype(np.int64)
    d1 = (np.datetime64("1998-08-02") - EPOCH).astype(np.int64)
    current = (np.datetime64("1995-06-17") - EPOCH).astype(np.int64)

    qty = np.empty(n_li, np.int64)
    extp = np.empty(n_li, np.int64)
    disc = np.empty(n_li, np.int64)
    tax = np.empty(n_li, np.int64)
    rf = np.empty(n_li, np.int32)
    ls = np.empty(n_li, np.int32)
    ship = np.empty(n_li, np.int32)

    rng = np.random.default_rng(seed)
    for lo in range(0, n_li, SLICE):
        hi = min(n_li, lo + SLICE)
        m = hi - lo
        q = rng.integers(1, 51, m)
        part = rng.integers(1, n_part + 1, m)
        retail = (90000 + ((part // 10) % 20001) + 100 * (part % 1000))
        qty[lo:hi] = q * 100  # scale-2 decimal
        extp[lo:hi] = q * retail
        disc[lo:hi] = rng.integers(0, 11, m)
        tax[lo:hi] = rng.integers(0, 9, m)
        odate = rng.integers(d0, d1 + 1, m)
        sd = odate + rng.integers(1, 122, m)
        rd = sd + rng.integers(1, 31, m)
        ship[lo:hi] = sd.astype(np.int32)
        # returnflag: R/A when receipt <= current else N (codes into RF_DICT)
        ra = rng.integers(0, 2, m)  # 0 -> A, 1 -> R
        rf[lo:hi] = np.where(rd <= current,
                             np.where(ra == 1, 2, 0), 1).astype(np.int32)
        ls[lo:hi] = (sd > current).astype(np.int32)  # F=0, O=1
    return {"l_quantity": qty, "l_extendedprice": extp, "l_discount": disc,
            "l_tax": tax, "l_returnflag": rf, "l_linestatus": ls,
            "l_shipdate": ship}


def _table(arrays: dict[str, np.ndarray]) -> TableStorage:
    cols = [Column(t, arrays[name], None, DICTS.get(name))
            for name, t in COLUMNS]
    n = len(arrays["l_quantity"])
    return TableStorage("lineitem", [n for n, _t in COLUMNS],
                        [t for _n, t in COLUMNS], cols, n)


def generate(sf: float, seed: int = 19920601) -> TableStorage:
    """The subset in memory (no cache)."""
    return _table(_gen_arrays(sf, seed))


def cache_dir(sf: float, seed: int) -> str:
    # its own directory: the JAX package caches the same subset as Arrow
    # IPC under the name without the "_npy"
    return _cache_dir(sf, seed) + "_li6_npy"


def generate_cached(sf: float, seed: int = 19920601) -> TableStorage:
    """The subset, memoized on disk as one .npy file a column and loaded
    memory-mapped. A cache that cannot be written is skipped."""
    d = cache_dir(sf, seed)
    meta_path = os.path.join(d, "meta.json")
    if os.path.exists(meta_path):
        # copy-on-write maps: writable, so they upload without a copy
        return _table({name: np.load(os.path.join(d, name + ".npy"),
                                     mmap_mode="c")
                       for name, _t in COLUMNS})
    arrays = _gen_arrays(sf, seed)
    if os.environ.get("LINGODB_TPCH_CACHE", "").upper() != "OFF":
        try:
            os.makedirs(d, exist_ok=True)
            for name, a in arrays.items():
                np.save(os.path.join(d, name + ".npy"), a)
            with open(meta_path, "w") as f:
                json.dump({"sf": sf, "seed": seed,
                           "rows": len(arrays["l_quantity"])}, f)
        except OSError:
            pass
    return _table(arrays)


def install(session, t: TableStorage) -> TableStorage:
    """Register an already generated subset as table `lineitem` (two
    sessions may share one: storage is read-only to queries)."""
    from ..catalog.catalog import TableEntry

    session.catalog.tables["lineitem"] = TableEntry(
        "lineitem", t.column_names, t.column_types, [], t)
    session._device_cache.pop("lineitem", None)
    return t

