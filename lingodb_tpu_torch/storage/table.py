"""Table storage: columnar host tables with Arrow IPC persistence.

Equivalent of the reference's LingoDBTable
(reference: src/runtime/storage/LingoDBTable.cpp:27-120 — Arrow IPC load/store,
1024-row sample, append+flush). We persist one Arrow IPC file per table so data
dirs interoperate with Arrow tooling; in memory the table is a set of dense
numpy columns (dictionary-encoded strings), which upload to the device as flat
tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..sql.types import K, IntervalUnit, Type
from .column import Column, physical_dtype

SAMPLE_SIZE = 1024  # reference: LingoDBTable.cpp:78-120


@dataclass
class TableStorage:
    name: str
    column_names: list[str]
    column_types: list[Type]
    columns: list[Column] = field(default_factory=list)
    num_rows: int = 0
    version: int = 0  # bumped on append; invalidates device cache
    # per-column HyperLogLog registers (m=64 uint8 each), maintained
    # incrementally on append and persisted with the catalog (reference:
    # ColumnStatistics::merge, src/catalog/MetaData.cpp:28-35). None = not
    # yet computed (built lazily on first stats request).
    hll_regs: list | None = None
    # column names physically sorted ascending (clustered order) — enables
    # monotone windowed gathers for FK probes (reference analogue: implicit
    # clustering of dbgen data by primary key; TPC-H lineitem by l_orderkey).
    # Cleared on append unless the appended data preserves the order.
    sorted_cols: tuple = ()

    @staticmethod
    def create(name: str, names: list[str], types: list[Type]) -> "TableStorage":
        cols = [
            Column(t, np.zeros(0, dtype=physical_dtype(t)),
                   None if not t.nullable else np.zeros(0, dtype=np.bool_),
                   np.zeros(0, dtype=object) if t.is_string else None)
            for t in types
        ]
        return TableStorage(name, list(names), list(types), cols, 0)

    def col_index(self, name: str) -> int:
        return self.column_names.index(name)

    def column(self, name: str) -> Column:
        return self.columns[self.col_index(name)]

    # ---- mutation ---------------------------------------------------------
    def append_rows(self, rows: list[list]):
        """Append Python-value rows (None = NULL)."""
        if not rows:
            return
        new_cols = []
        for i, t in enumerate(self.column_types):
            vals = [r[i] for r in rows]
            new_cols.append(Column.from_values(t, vals))
        self.append_columns(new_cols)

    def append_columns(self, new_cols: list[Column]):
        n = len(new_cols[0].data)
        if self.num_rows != 0 and self.sorted_cols:
            # appends may break the clustered order; keep a declared column
            # only when the appended segment continues it
            kept = []
            for name in self.sorted_cols:
                i = self.col_index(name)
                old, new = self.columns[i], new_cols[i]
                try:
                    d = np.asarray(new.data)
                    ok = (len(d) == 0 or (
                        np.all(d[1:] >= d[:-1])
                        and (self.num_rows == 0
                             or d[0] >= np.asarray(old.data)[-1])))
                except TypeError:
                    ok = False
                if ok:
                    kept.append(name)
            self.sorted_cols = tuple(kept)
        if self.num_rows == 0:
            self.columns = new_cols
        else:
            self.columns = [c.concat(nc) for c, nc in zip(self.columns, new_cols)]
        self.num_rows += n
        self.version += 1
        if self.hll_regs is not None:
            # incremental sketch merge (reference: ColumnStatistics::merge
            # hashes only the appended segment, MetaData.cpp:28-35); columns
            # never sketched stay lazy (None)
            from ..utils import hll

            self.hll_regs = [
                None if r is None
                else hll.merge(r, _column_regs(c.type, nc))
                for r, c, nc in zip(self.hll_regs, self.columns, new_cols)
            ]

    # ---- statistics (reference: catalog Sample + HLL distinct counts) ------
    def sample_indices(self, rng: np.random.Generator | None = None) -> np.ndarray:
        if self.num_rows <= SAMPLE_SIZE:
            return np.arange(self.num_rows)
        rng = rng or np.random.default_rng(42)
        return np.sort(rng.choice(self.num_rows, size=SAMPLE_SIZE, replace=False))

    def hll_for(self, ci: int):
        """Per-column HLL sketch, computed lazily on first request (the
        optimizer only ever asks about join/group keys; sketching every
        column of a 60M-row table up front costs real minutes of host time).

        String columns stay None: their exact distinct count is the
        dictionary size (the dictionary is precisely the set of values
        present). Export to the reference format builds string sketches on
        demand from the dictionary (hashing each distinct value once yields
        the identical sketch — HLL state depends only on the distinct-hash
        set)."""
        if self.hll_regs is None:
            self.hll_regs = [None] * len(self.columns)
        c = self.columns[ci]
        if self.hll_regs[ci] is None and not c.type.is_string:
            self.hll_regs[ci] = _column_regs(c.type, c)
        return self.hll_regs[ci]

    def ensure_hll(self) -> list:
        """All per-column sketches (None for strings); used by catalog
        persistence/export (reference: sketches built incrementally at load,
        src/catalog/MetaData.cpp:28-35)."""
        for i in range(len(self.columns)):
            self.hll_for(i)
        return self.hll_regs

    def distinct_for(self, ci: int) -> int:
        """Distinct-count estimate for one column (exact for strings via the
        dictionary; HLL otherwise)."""
        from ..utils import hll

        c = self.columns[ci]
        if c.type.is_string:
            return max(1, len(c.dictionary) if c.dictionary is not None else 1)
        regs = self.hll_for(ci)
        d = int(hll.estimate(regs))
        mask = c.is_valid_mask()
        if int(mask.sum()) < self.num_rows:
            d -= 1  # NULLs hash to one fixed value; exclude from distinct
        return max(1, min(d, self.num_rows))

    def export_hll(self) -> list:
        """All-column HLL registers for catalog export: string sketches build
        from the dictionary (each distinct value hashed once — identical
        sketch to hashing every row, as HLL state depends only on the
        distinct-hash set), plus the fixed NULL hash when NULLs exist."""
        from ..utils import hll

        out = []
        for c, regs in zip(self.columns, self.ensure_hll()):
            if regs is None:
                hashes = (_hash_string_values(c.dictionary)
                          if c.dictionary is not None and len(c.dictionary)
                          else np.zeros(0, np.uint64))
                if c.valid is not None and not c.valid.all():
                    hashes = np.append(hashes, np.uint64(0x9E3779B97F4A7C15))
                regs = hll.registers_from_hashes(hashes)
            out.append(regs)
        return out

    def column_stats(self) -> list[dict]:
        """Per-column stats: distinct count (exact on small tables; strings
        exact via the dictionary; otherwise computed LAZILY per column on the
        first distinct_count request — reference: catalog::ColumnStatistics
        HLL sketches, MetaData.h:17-30), null count, min/max for numerics
        (sample-based). A missing "distinct" key means "ask distinct_for"."""
        from ..utils import hll

        stats = []
        idx = self.sample_indices()
        small = len(idx) >= self.num_rows
        for ci, c in enumerate(self.columns):
            s: dict = {}
            if self.num_rows == 0:
                stats.append({"distinct": 0, "nulls": 0})
                continue
            data = c.data if small else c.data[idx]
            mask = c.is_valid_mask()
            m = mask if small else mask[idx]
            vals = data[m]
            if small:
                s["distinct"] = max(len(np.unique(vals)), 1)
            elif c.type.is_string:
                # dictionary == set of present values: distinct is exact
                s["distinct"] = max(
                    len(c.dictionary) if c.dictionary is not None else 1, 1)
            elif self.hll_regs is not None and self.hll_regs[ci] is not None:
                d = int(hll.estimate(self.hll_regs[ci]))
                if int(mask.sum()) < self.num_rows:
                    d -= 1
                s["distinct"] = max(1, min(d, self.num_rows))
            s["nulls"] = int(self.num_rows - mask.sum())
            if c.type.is_numeric or c.type.kind in (K.DATE, K.TIMESTAMP):
                if len(vals) and vals.dtype != np.object_:
                    s["min"] = int(np.min(vals)) if np.issubdtype(vals.dtype, np.integer) else float(np.min(vals))
                    s["max"] = int(np.max(vals)) if np.issubdtype(vals.dtype, np.integer) else float(np.max(vals))
            stats.append(s)
        return stats

    # ---- persistence (Arrow IPC like the reference) -------------------------
    def to_arrow_table(self, ref_compat: bool = False):
        """Materialize as a pyarrow Table. `ref_compat` uses the reference's
        plain physical encodings (utf8 strings, decimal128, fsb(4) chars —
        LingoDBTable.cpp:141-191) instead of our fast internal forms."""
        import pyarrow as pa

        arrays, fields = [], []
        for name, t, c in zip(self.column_names, self.column_types, self.columns):
            arr, f = _to_arrow(name, t, c, decimal_as_int=not ref_compat)
            arrays.append(arr)
            fields.append(f)
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields))

    def save(self, db_dir: str, file_name: str | None = None,
             ref_compat: bool = False):
        import pyarrow.ipc as ipc

        table = self.to_arrow_table(ref_compat)
        path = os.path.join(db_dir, file_name or f"{self.name}.arrow")
        with ipc.RecordBatchFileWriter(path, table.schema) as w:
            w.write_table(table)

    @staticmethod
    def load(name: str, db_dir: str, names: list[str], types: list[Type],
             file_name: str | None = None) -> "TableStorage":
        import pyarrow.ipc as ipc

        import pyarrow as pa

        path = os.path.join(db_dir, file_name or f"{name}.arrow")
        # memory-map: column buffers stay zero-copy views into the page
        # cache (fresh multi-hundred-MB allocations page-fault for seconds
        # in this environment; mapped reads page in lazily at full speed)
        with pa.memory_map(path) as mm, ipc.open_file(mm) as r:
            table = r.read_all()
        t = TableStorage.create(name, names, types)
        cols = []
        for cname, ctype in zip(names, types):
            arr = table.column(cname)
            cols.append(_from_arrow(ctype, arr))
        n = len(cols[0].data) if cols else 0
        t.columns = cols
        t.num_rows = n
        return t


def _hash_string_values(values) -> np.ndarray:
    """Content hash per distinct string (8-byte blake2b). Used only for the
    HLL sketch: stable across dictionary re-encodings and appends."""
    import hashlib

    out = np.empty(len(values), np.uint64)
    for i, v in enumerate(values):
        out[i] = int.from_bytes(
            hashlib.blake2b(str(v).encode(), digest_size=8).digest(), "little")
    return out


def _column_regs(t: Type, c: Column) -> np.ndarray:
    """Chunked HLL register build for one column: bounded temporaries (fresh
    multi-hundred-MB numpy allocations page-fault for seconds in this
    environment; 32MB chunks recycle through the allocator at full speed)."""
    from ..utils import hll

    counts = hll.new_counts()
    n = len(c.data)
    for lo in range(0, max(n, 1), hll.CHUNK):
        sub = Column(t, c.data[lo:lo + hll.CHUNK],
                     None if c.valid is None else c.valid[lo:lo + hll.CHUNK],
                     c.dictionary)
        hll.fold_hashes(column_hashes(t, sub), counts)
    return hll.registers_from_counts(counts)


def column_hashes(t: Type, c: Column) -> np.ndarray:
    """Content-stable uint64 hash per row (NULL -> one fixed hash). String
    hashes depend on string *content*, not per-batch dictionary codes, so
    sketches built from different appends merge correctly (reference hashes
    the raw arrow array the same way: MetaData.cpp:14-18)."""
    from ..ops.hashing import hash_column

    if t.is_string:
        if c.dictionary is None or len(c.data) == 0:
            return np.zeros(len(c.data), np.uint64)
        dh = _hash_string_values(c.dictionary)
        h = dh[np.asarray(c.data, dtype=np.int64)]
        if c.valid is not None:
            h = np.where(c.valid, h, np.uint64(0x9E3779B97F4A7C15))
        return h
    return np.asarray(hash_column(c.data, c.valid))


def _to_arrow(name: str, t: Type, c: Column, decimal_as_int: bool = True):
    import pyarrow as pa

    mask = None if c.valid is None else ~c.valid
    if t.is_string:
        if decimal_as_int:
            # persistence fast path: keep the dictionary encoding (codes +
            # sorted dictionary), no per-value Python loop on either side
            codes = pa.array(c.data.astype(np.int32), mask=mask)
            dct = pa.array(c.dictionary, type=pa.string())
            arr = pa.DictionaryArray.from_arrays(codes, dct)
            return arr, pa.field(name, arr.type, t.nullable)
        # reference-compatible plain encoding (its ArrowView has no
        # dictionary-array path): decode codes -> values in Arrow C++
        import pyarrow.compute as pc

        dct = pa.array(c.dictionary, type=pa.string())
        codes = pa.array(c.data.astype(np.int64), mask=mask)
        arr = pc.take(dct, codes)
        if t.kind == K.CHAR and (t.p or 1) == 1:
            # reference stores char<1> as fixed_size_binary(4), zero-padded
            # utf8 (LingoDBTable.cpp:186, RelationHelper.cpp:149-176)
            pad = [None if v is None else v.encode().ljust(4, b"\0")
                   for v in arr.to_pylist()]
            arr = pa.array(pad, type=pa.binary(4))
            return arr, pa.field(name, arr.type, t.nullable)
        return arr, pa.field(name, pa.string(), t.nullable)
    if t.kind == K.DECIMAL:
        if c.data.dtype == np.object_:
            # wide (Python-int) column: decimal128 round-trips exactly
            from decimal import Decimal

            dt = pa.decimal128(38, t.s)
            vals = [
                None if (mask is not None and mask[i])
                else Decimal(int(c.data[i])).scaleb(-t.s)
                for i in range(len(c.data))
            ]
            arr = pa.array(vals, type=dt)
            return arr, pa.field(name, dt, t.nullable)
        if decimal_as_int:
            # persist the scaled-int64 representation directly (fast bulk
            # path); the logical decimal type lives in catalog.json.
            # _from_arrow accepts both this form and real decimal128 columns
            # (LingoDB data dirs).
            arr = pa.array(c.data, mask=mask)
            return arr, pa.field(name, arr.type, t.nullable)
        # reinterpret scaled int64 as decimal128 by building the 16-byte
        # little-endian two's-complement buffer directly (vectorized)
        dt = pa.decimal128(max(t.p, 1), t.s)
        lo = c.data.astype(np.int64)
        hi = np.where(lo < 0, np.int64(-1), np.int64(0))
        buf = np.empty((len(lo), 2), dtype=np.int64)
        buf[:, 0] = lo
        buf[:, 1] = hi
        validbuf = None
        if mask is not None:
            validbuf = pa.array(~mask).buffers()[1]
        arr = pa.Array.from_buffers(
            dt, len(lo), [validbuf, pa.py_buffer(buf.tobytes())],
            null_count=int(mask.sum()) if mask is not None else 0,
        )
        return arr, pa.field(name, dt, t.nullable)
    if t.kind == K.DATE:
        arr = pa.array(c.data.astype("datetime64[D]"), mask=mask)
        return arr, pa.field(name, pa.date32(), t.nullable)
    if t.kind == K.TIMESTAMP:
        arr = pa.array(c.data.astype("datetime64[us]"), mask=mask)
        return arr, pa.field(name, pa.timestamp("us"), t.nullable)
    arr = pa.array(c.data, mask=mask)
    return arr, pa.field(name, arr.type, t.nullable)


def _from_arrow(t: Type, chunked) -> Column:
    import pyarrow as pa

    arr = chunked.combine_chunks() if hasattr(chunked, "combine_chunks") else chunked
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.chunk(0) if arr.num_chunks == 1 else pa.concat_arrays(arr.chunks)
    valid = None
    if arr.null_count:
        valid = ~np.asarray(arr.is_null())
    if t.is_string:
        from .column import encode_strings

        if pa.types.is_fixed_size_binary(arr.type):
            # reference char<1> storage: fixed_size_binary(4), zero-padded
            # utf8 (LingoDBTable.cpp:186)
            vals = [None if v is None else v.rstrip(b"\0").decode()
                    for v in arr.to_pylist()]
            arr = pa.array(vals, type=pa.string())
        if pa.types.is_dictionary(arr.type):
            dct = np.asarray(arr.dictionary.to_pylist(), dtype=object)
            codes = np.asarray(arr.indices.fill_null(0) if arr.null_count else arr.indices)
            codes = codes.astype(np.int32)
            if len(dct) > 1 and not np.all(dct[:-1] <= dct[1:]):
                # foreign file with unsorted dictionary: re-sort (engine
                # invariant: dictionaries are sorted for order-preserving
                # comparisons on codes)
                order = np.argsort(dct)
                remap = np.empty(len(dct), np.int32)
                remap[order] = np.arange(len(dct), dtype=np.int32)
                dct = dct[order]
                codes = remap[codes]
            return Column(t, codes, valid, dct)
        # plain string column (foreign file): dictionary-encode in Arrow C++
        # (no per-value Python), then sort the dictionary for our order-
        # preserving code invariant
        import pyarrow.compute as pc

        if arr.null_count:
            arr = arr.fill_null("")
        enc = pc.dictionary_encode(arr)
        dct = np.asarray(enc.dictionary.to_pylist(), dtype=object)
        codes = np.asarray(enc.indices).astype(np.int32)
        order = np.argsort(dct)
        remap = np.empty(len(dct), np.int32)
        remap[order] = np.arange(len(dct), dtype=np.int32)
        return Column(t, remap[codes] if len(dct) else codes, valid,
                      dct[order])
    if t.kind == K.DECIMAL:
        if pa.types.is_integer(arr.type):  # our scaled-int64 persistence form
            data = np.asarray(arr.fill_null(0) if arr.null_count else arr)
            return Column(t, data.astype(np.int64, copy=False), valid)
        pyvals = [0 if v is None else int(v.scaleb(t.s)) for v in arr.to_pylist()]
        if all(-(1 << 63) <= v < (1 << 63) for v in pyvals):
            return Column(t, np.array(pyvals, dtype=np.int64), valid)
        return Column(t, np.array(pyvals, dtype=np.object_), valid)
    if t.kind == K.DATE:
        if pa.types.is_date64(arr.type):  # reference date<ms> storage
            ms = np.asarray(arr.cast(pa.int64()).fill_null(0))
            return Column(t, (ms // 86_400_000).astype(np.int32), valid)
        days = np.asarray(arr.cast(pa.int32()).fill_null(0))
        return Column(t, days.astype(np.int32, copy=False), valid)
    if t.kind == K.TIMESTAMP:
        if pa.types.is_timestamp(arr.type) and arr.type.unit != "us":
            arr = arr.cast(pa.timestamp("us"))
        us = np.asarray(arr.cast(pa.int64()).fill_null(0))
        return Column(t, us.astype(np.int64, copy=False), valid)
    if arr.null_count:
        arr = arr.fill_null(False if pa.types.is_boolean(arr.type) else 0)
    data = np.asarray(arr)
    return Column(t, np.ascontiguousarray(data, dtype=physical_dtype(t)), valid)


def arrow_type_for(t: Type):
    """Arrow type to parse a column as (used by the CSV COPY loader)."""
    import pyarrow as pa

    if t.kind == K.DECIMAL:
        return pa.decimal128(max(t.p, 1), t.s)
    if t.kind == K.DATE:
        return pa.date32()
    if t.kind == K.TIMESTAMP:
        return pa.timestamp("us")
    if t.kind == K.BOOL:
        return pa.bool_()
    if t.kind == K.INT:
        return pa.int32()
    if t.kind == K.BIGINT:
        return pa.int64()
    if t.kind == K.FLOAT:
        return pa.float32()
    if t.kind == K.DOUBLE:
        return pa.float64()
    return pa.string()
