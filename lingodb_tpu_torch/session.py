"""Session: the embedding API (parse -> bind -> optimize -> execute).

Equivalent of the reference's Session + QueryExecuter
(reference: src/runtime/Session.cpp, src/execution/Execution.cpp:250-401 —
frontend -> optimizer -> lowering -> backend -> result processing with phase
timing). The Python package mirrors the reference pip API
(reference: tools/python/lingodb/__init__.py:44-67 — Connection.sql,
connect_to_db, create_in_memory).

A session runs on ONE explicit torch device. The default is the CUDA card and
constructing a session raises when there is none: the engine never looks for
a GPU and quietly carries on on the CPU. Tests pass device="cpu"."""

from __future__ import annotations

import csv as csvmod
import os

import numpy as np
import torch

from .catalog.catalog import Catalog, FunctionEntry
from .opt.optimizer import optimize
from .plan import logical as L
from .runtime.executor import Executor
from .runtime.exestore import GraphStore
from .runtime.result import ResultTable
from .runtime.vtable import SCol
from .sql import ast as A
from .sql.binder import Binder, BindError
from .sql.parser import parse_sql
from .storage.column import Column
from .utils import compilestats, tracer
from .utils.settings import get_setting


class Prepared:
    """A parsed + optimized query awaiting execution (its scans uploaded)."""

    def __init__(self, query: str, stmts, plan):
        self.query = query
        self.stmts = stmts
        self.plan = plan


class Session:
    def __init__(self, db_dir: str | None = None, device=None):
        from .runtime.device import resolve_device

        self.device = resolve_device(device)
        self.catalog = Catalog(db_dir)
        self.executor = Executor(self)
        self._device_cache: dict[str, tuple[int, dict]] = {}
        # (table, column) -> (table version, (min, max)): column_bounds
        self._bounds: dict = {}
        # the fused aggregate's per-plan state, keyed by plan and table
        # versions: join preps (uploaded LUTs + payloads), learned
        # capacities, decline markers
        self.stage_cache: dict = {}
        # the fused programs captured as CUDA graphs (runtime/exestore.py);
        # a mesh over several cards keeps one store for each other card
        self.exestore = GraphStore(self.device)
        self._other_stores: dict = {}

    # ----------------------------------------------------------- public API
    def sql(self, query: str):
        """Execute SQL; returns ResultTable for queries, None for statements.
        Multiple statements: executes all, returns the last query's result."""
        stmts = parse_sql(query)
        result = None
        for stmt in stmts:
            result = self._execute_statement(stmt)
        return result

    def sql_stmt(self, query: str) -> None:
        self.sql(query)

    # ------------------------------------------------- pipelined execution
    def prepare(self, query: str) -> "Prepared":
        """Parse, bind and optimize without executing, and upload every scan
        column the plan touches. This is the unit `sql_many` overlaps with
        the previous query's execution (reference: compilation runs inside
        scheduler tasks so one query compiles while another executes over
        warm contexts, src/execution/Execution.cpp:294-325)."""
        stmts = parse_sql(query)
        plan = None
        if stmts and isinstance(stmts[-1], A.SelectStmt):
            plan = optimize(Binder(self.catalog).bind_query(stmts[-1]),
                            self.catalog)
            self._prefetch_plan(plan)
        return Prepared(query, stmts, plan)

    def execute_prepared(self, prepared: "Prepared"):
        result = None
        for i, stmt in enumerate(prepared.stmts):
            if i == len(prepared.stmts) - 1 and prepared.plan is not None:
                result = self._execute_plan(prepared.plan)
            else:
                result = self._execute_statement(stmt)
        return result

    def _prefetch_plan(self, plan) -> None:
        """Upload the plan's scan columns now. On sql_many's worker thread
        the copies go to the card's default stream, which every thread
        shares: the main thread's kernels that read a column are queued
        after the column is cached, so after its copy. A scan the
        out-of-core aggregate would stream (its columns exceed
        system.device_byte_budget) is not uploaded. Best-effort: an error
        is swallowed here and raised again by the execution."""
        for op in L.walk_plan(plan):
            if isinstance(op, L.Scan):
                try:
                    if self.executor.chunked_plan(op.table, op.cols) is not None:
                        continue
                    dev = self.device_table(op.table)
                    dev["__num_rows__"]
                    for c in op.cols:
                        dev[c.name]
                except Exception:
                    pass  # prefetch is best-effort; execution re-raises

    def sql_many(self, queries, overlap: bool | None = None) -> list:
        """Execute a sequence of SQL strings, overlapping each query's
        frontend, optimizer and uploads with the previous one's execution.
        overlap=None follows the system.overlap setting."""
        import concurrent.futures as cf

        if overlap is None:
            overlap = bool(get_setting("system.overlap"))
        queries = list(queries)
        if not overlap or len(queries) <= 1:
            return [self.sql(q) for q in queries]
        out = []
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(self.prepare, queries[0])
            for i in range(len(queries)):
                pq = nxt.result()
                nxt = None
                # only pure SELECTs overlap the next prepare: a DDL/DML
                # statement mutates the catalog the concurrent bind would read
                pure = all(isinstance(st, A.SelectStmt) for st in pq.stmts)
                if pure and i + 1 < len(queries):
                    nxt = pool.submit(self.prepare, queries[i + 1])
                out.append(self.execute_prepared(pq))
                if nxt is None and i + 1 < len(queries):
                    nxt = pool.submit(self.prepare, queries[i + 1])
        return out

    def explain(self, query: str) -> str:
        stmts = parse_sql(query)
        binder = Binder(self.catalog)
        plan = binder.bind_query(stmts[-1])
        plan = optimize(plan, self.catalog)
        return plan.pretty()

    def append_table(self, name: str, table) -> None:
        """Append a pyarrow.Table to an existing table (reference pip API:
        Connection.append_table, tools/python/lingodb/__init__.py:59)."""
        from .storage.table import _from_arrow

        entry = self.catalog.get_table(name)
        if entry is None:
            raise BindError(f"unknown table {name}")
        cols = [_from_arrow(t, table.column(n))
                for n, t in zip(entry.column_names, entry.column_types)]
        entry.storage.append_columns(cols)
        self._device_cache.pop(name, None)

    def add_table(self, name: str, table) -> None:
        """Create + populate a table from a pyarrow.Table (reference pip API:
        Connection.add_table, tools/python/lingodb/__init__.py:62)."""
        from .catalog.catalog import arrow_schema_types

        names, types = arrow_schema_types(table.schema)
        self.catalog.create_table(name, names, types, [])
        self.append_table(name, table)

    def plan_json(self, query: str) -> str:
        """Optimized plan as JSON (reference: relalg-to-json exporters used
        by the ct web tooling, tools/ct/mlir-relalg-to-json.cpp)."""
        from .plan.serial import plan_to_json

        stmts = parse_sql(query)
        plan = optimize(Binder(self.catalog).bind_query(stmts[-1]), self.catalog)
        return plan_to_json(plan)

    def run_plan(self, serialized: str):
        """Execute a serialized plan (the compiler-level entry point — the
        analogue of run-mlir executing pre-built IR, src/tools/run-mlir.cpp)."""
        from .plan.serial import plan_from_json

        return self.executor.execute(plan_from_json(serialized))

    def close(self):
        self.catalog.save()

    def export_reference(self, db_dir: str) -> None:
        """Write the catalog + data as a reference (LingoDB) database
        directory: binary db.lingodb catalog + plain-encoded Arrow IPC files
        (reference: Catalog::persist, src/catalog/Catalog.cpp:63-75)."""
        self.catalog.save_reference(db_dir)

    # ------------------------------------------------------------ statements
    def _execute_plan(self, plan):
        try:
            res = self.executor.execute(plan)
        except torch.cuda.OutOfMemoryError:
            # device memory exhausted (working sets + cached uploads exceed
            # the card): drop every cached device buffer and retry once.
            # Reference analogue: buffer-manager eviction under memory
            # pressure; our unit is whole cached columns.
            import sys

            print("# device OOM: evicting cached buffers and retrying",
                  file=sys.stderr)
            self._evict_device_memory()
            res = self.executor.execute(plan)
        self._relieve_memory_pressure()
        return res

    def _execute_statement(self, stmt):
        t = tracer.Timing()
        if isinstance(stmt, A.SelectStmt):
            with t.time("frontend"):
                binder = Binder(self.catalog)
                plan = binder.bind_query(stmt)
            with t.time("QOpt"):
                plan = optimize(plan, self.catalog)
            with t.time("execution"):
                res = self._execute_plan(plan)
            if get_setting("sql.report_times"):
                print(t.report())
            return res
        if isinstance(stmt, A.ExplainStmt):
            from .sql.types import Type

            binder = Binder(self.catalog)
            plan = binder.bind_query(stmt.query)
            if stmt.verbose:
                lines = ["-- logical plan (pre-optimization)"]
                lines += plan.pretty().splitlines()
                lines.append("-- optimized plan")
            else:
                lines = []
            plan = optimize(plan, self.catalog)
            if stmt.analyze:
                import time as _time

                counts: dict = {}
                self.executor.track_tuples = counts
                t0 = _time.time()
                try:
                    self.executor.execute(plan)
                finally:
                    self.executor.track_tuples = None
                dt = _time.time() - t0

                def annotate(op, indent=0):
                    rows = counts.get(id(op))
                    suffix = f"  [rows={rows}]" if rows is not None else ""
                    ls = ["  " * indent + op._describe() + suffix]
                    for c in op.children():
                        ls.extend(annotate(c, indent + 1))
                    return ls

                lines += annotate(plan)
                lines.append(f"-- execution: {dt * 1e3:.1f} ms")
                from .storage.column import encode_strings

                dct, codes = encode_strings(lines)
                return ResultTable(["plan"], [Type.string()], [codes], [None],
                                   [dct], len(lines))
            lines += plan.pretty().splitlines()
            from .storage.column import encode_strings

            dct, codes = encode_strings(lines)
            return ResultTable(["plan"], [Type.string()], [codes], [None],
                               [dct], len(lines))
        if isinstance(stmt, A.CreateTableStmt):
            names = [c.name for c in stmt.columns]
            types = [
                c.type.as_nullable(not (c.not_null or c.primary_key))
                for c in stmt.columns
            ]
            pk = stmt.primary_key or [c.name for c in stmt.columns if c.primary_key]
            self.catalog.create_table(stmt.name, names, types, pk)
            return None
        if isinstance(stmt, A.DropTableStmt):
            self.catalog.drop_table(stmt.name)
            return None
        if isinstance(stmt, A.CreateIndexStmt):
            self.catalog.create_index(stmt.name, stmt.table, stmt.columns)
            return None
        if isinstance(stmt, A.CreateViewStmt):
            if not hasattr(self.catalog, "views"):
                self.catalog.views = {}
            self.catalog.views[stmt.name] = stmt.query
            return None
        if isinstance(stmt, A.InsertStmt):
            return self._execute_insert(stmt)
        if isinstance(stmt, A.CopyStmt):
            return self._execute_copy(stmt)
        if isinstance(stmt, A.SetStmt):
            from .utils.settings import set_setting

            set_setting(stmt.key, stmt.value)
            return None
        if isinstance(stmt, A.CreateFunctionStmt):
            from .catalog.catalog import compile_function

            entry = FunctionEntry(stmt.name, stmt.arg_types, stmt.return_type,
                                  stmt.language, stmt.body,
                                  arg_names=list(stmt.arg_names))
            compile_function(entry)
            self.catalog.create_function(entry)
            return None
        raise NotImplementedError(type(stmt).__name__)

    def _execute_insert(self, stmt: A.InsertStmt):
        entry = self.catalog.get_table(stmt.table)
        if entry is None:
            raise BindError(f"unknown table {stmt.table}")
        target_cols = stmt.columns or entry.column_names
        binder = Binder(self.catalog)
        plan = binder.bind_query(stmt.query)
        plan = optimize(plan, self.catalog)
        res = self.executor.execute(plan)
        # column-order mapping + type coercion to the table schema: each
        # column cast as CAST casts it (PostgreSQL's assignment casts round
        # and raise as CAST does)
        from .ops.consteval import coerce_values

        cmap = {c: i for i, c in enumerate(target_cols)}
        cols = []
        for name, t in zip(entry.column_names, entry.column_types):
            if name in cmap:
                i = cmap[name]
                vals = coerce_values(res.columns[i], res.valids[i],
                                     res.dictionaries[i], res.types[i], t)
            else:
                vals = [None] * res.num_rows
            cols.append(_column_from_physical(t, vals))
        entry.storage.append_columns(cols)
        self._device_cache.pop(entry.name, None)
        return None

    def _execute_copy(self, stmt: A.CopyStmt):
        """COPY table FROM 'file.csv': bulk load through the Arrow C++ CSV
        reader (native, multithreaded — the same engine the reference's
        copyFromIntoTable uses, RelationHelper.cpp); Python csv fallback for
        options Arrow can't express."""
        entry = self.catalog.get_table(stmt.table)
        if entry is None:
            raise BindError(f"unknown table {stmt.table}")
        delim = stmt.options.get("delimiter", ",")
        nullstr = stmt.options.get("null", "")
        escape = stmt.options.get("escape", None) or None
        try:
            self._copy_arrow(entry, stmt.path, delim, nullstr, escape)
        except Exception:
            self._copy_python(entry, stmt.path, delim, nullstr, escape)
        self._device_cache.pop(entry.name, None)
        return None

    def _copy_arrow(self, entry, path, delim, nullstr, escape):
        import pyarrow as pa
        import pyarrow.csv as pacsv

        from .storage.table import _from_arrow, arrow_type_for

        read = pacsv.ReadOptions(column_names=entry.column_names)
        parse = pacsv.ParseOptions(
            delimiter=delim,
            escape_char=escape if escape else False,
        )
        conv = pacsv.ConvertOptions(
            null_values=[nullstr],
            strings_can_be_null=True,
            quoted_strings_can_be_null=False,
            column_types={n: arrow_type_for(t) for n, t in
                          zip(entry.column_names, entry.column_types)},
        )
        table = pacsv.read_csv(path, read_options=read, parse_options=parse,
                               convert_options=conv)
        cols = [_from_arrow(t, table.column(n))
                for n, t in zip(entry.column_names, entry.column_types)]
        entry.storage.append_columns(cols)

    def _copy_python(self, entry, path, delim, nullstr, escape):
        rows = []
        with open(path, newline="") as f:
            reader = csvmod.reader(f, delimiter=delim, escapechar=escape)
            for rec in reader:
                row = []
                for v, t in zip(rec, entry.column_types):
                    if v == nullstr and t.nullable:
                        row.append(None)
                    else:
                        row.append(v)
                rows.append(row)
        entry.storage.append_rows(rows)

    # ----------------------------------------------------------- device data
    def graph_store(self, device=None) -> GraphStore:
        """The store of the programs captured on `device` (None: the
        session's): a graph replays on the card it was captured on."""
        if device is None or torch.device(device) == self.device:
            return self.exestore
        device = torch.device(device)
        store = self._other_stores.get(device)
        if store is None:
            store = self._other_stores[device] = GraphStore(device)
        return store

    def graph_stores(self) -> list:
        return [self.exestore, *self._other_stores.values()]

    def _evict_device_memory(self) -> None:
        """Drop every cached device buffer this session pins: uploaded table
        columns, fused join preps (LUTs + payloads), the out-of-core
        aggregate's staging slots, the captured programs
        with their memory pool, and one-shot materializations. Everything is
        rebuildable; the next query re-uploads what it actually touches and
        captures its program again."""
        compilestats.add("evictions")
        for store in self.graph_stores():
            store.clear()
        for _version, dev in self._device_cache.values():
            dev.evict()
        for k in [k for k in self.stage_cache
                  if isinstance(k, tuple) and k
                  and k[0] in ("fused_prep", "chunk_stream")]:
            del self.stage_cache[k]
        self.executor._tmp_results.clear()
        self.executor._materialized_bases.clear()
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _relieve_memory_pressure(self) -> None:
        """Proactive eviction when the card sits near capacity after a
        statement (cached uploads approach its memory): prevents the NEXT
        query's working set from hitting the allocator wall mid-operator."""
        if self.device.type != "cuda":
            return
        free, total = torch.cuda.mem_get_info(self.device)
        if not total or free >= 0.2 * total:
            return
        # blocks the caching allocator keeps but no tensor holds serve the
        # next query as well: without them, one large query's working set
        # evicts every cached table after it. The free blocks of the
        # captured programs' pool are not among them: they serve only the
        # graphs' replays
        pool_reserved, pool_allocated = self.exestore.pool_memory()
        free += max(0, torch.cuda.memory_reserved(self.device)
                    - torch.cuda.memory_allocated(self.device)
                    - (pool_reserved - pool_allocated))
        if free < 0.2 * total:
            import sys

            print(f"# device memory {(total - free) / 1e9:.1f}/{total / 1e9:.1f}GB:"
                  f" evicting cached buffers", file=sys.stderr)
            self._evict_device_memory()

    def column_bounds(self, table: str, col: str):
        """(min, max) of an integer, decimal or boolean column's non-NULL
        values, or None for another type or table: the bound its arithmetic
        is proved by (ops/bounds.py). One pass over the column's host copy
        the first time a statement asks, kept for the table's version (a
        streamed table is never uploaded, so it is not read from the card);
        (0, 0) for a column with no value."""
        entry = self.catalog.get_table(table)
        if entry is None:
            return None
        storage = entry.storage
        key = (table, col)
        got = self._bounds.get(key)
        if got is not None and got[0] == storage.version:
            return got[1]
        from .sql.types import K

        c = storage.column(col)
        b = None
        if c.type.kind in (K.INT, K.BIGINT, K.DECIMAL, K.BOOL):
            data = np.asarray(c.data)
            if c.valid is not None:
                data = data[np.asarray(c.valid, dtype=np.bool_)]
            b = (0, 0) if data.size == 0 else (int(data.min()),
                                               int(data.max()))
        self._bounds[key] = (storage.version, b)
        return b

    def device_table(self, name: str) -> dict:
        """Lazily upload (and cache) a table's columns as device tensors —
        columns transfer on first access, mirroring the reference's
        column-projected scans (reference: DataSourceIteration.cpp +
        ScanConfig.columns, TableStorage.h:81-95)."""
        entry = self.catalog.get_table(name)
        storage = entry.storage
        cached = self._device_cache.get(name)
        if cached is not None and cached[0] == storage.version:
            return cached[1]
        dev = _LazyDeviceTable(storage, self)
        self._device_cache[name] = (storage.version, dev)
        return dev


class _LazyDeviceTable:
    """dict-like device view of a table; columns upload on first access.

    On a mesh (runtime/device.get_mesh) a table of at least dv.SMALL_ROWS
    rows is held row-sharded from its upload, as the reference holds it
    (lingodb_tpu/session.py): `__num_rows__` is the count padded to a
    multiple of the mesh axis, `__pad_mask__` a Sharded bool column of the
    true rows (None when the axis divides the count), every fixed-width
    column and its validity a Sharded value, and wide decimals (object
    dtype) stay on the host padded to the sharded count, their validity
    padded false. On a mesh that spans processes each process uploads its
    own positions only. The columns are held in one layout at a time (the
    mesh's, or whole): a change of the mesh drops them."""

    def __init__(self, storage, session):
        self._storage = storage
        self._session = session
        self._cols: dict[str, SCol] = {}
        self._layout = None  # the mesh the columns are held on

    def evict(self) -> bool:
        had = bool(self._cols)
        self._cols.clear()
        return had

    def _evict_others(self) -> bool:
        freed = False
        for _version, t in self._session._device_cache.values():
            if t is not self:
                freed = t.evict() or freed
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        return freed

    def _upload(self, col) -> SCol:
        from .ops.backend import to_device

        dev = self._session.device
        return SCol(
            col.type, to_device(col.data, dev),
            None if col.valid is None else to_device(col.valid, dev),
            col.dictionary,
        )

    def _shard(self, col, mesh) -> SCol:
        from .runtime import device as dv

        dnp = np.asarray(col.data)
        if dnp.dtype == np.object_:
            # wide decimals (host Python ints) never upload: kept on the
            # host, padded to the sharded row count (the exchange
            # limb-splits them when they cross the mesh)
            total = self["__num_rows__"]
            valid = col.valid
            pad = total - dnp.shape[0]
            if pad:
                dnp = np.concatenate([dnp, np.zeros(pad, dtype=object)])
                if valid is not None:
                    valid = np.concatenate([np.asarray(valid),
                                            np.zeros(pad, np.bool_)])
            return SCol(col.type, dnp, valid, col.dictionary)
        data, _ = dv.shard_column(dnp, mesh)
        valid = None
        if col.valid is not None:
            valid, _ = dv.shard_column(np.asarray(col.valid), mesh)
        return SCol(col.type, data, valid, col.dictionary)

    def _mesh(self):
        from .runtime import device as dv

        if self._storage.num_rows < dv.SMALL_ROWS:
            return None
        return dv.get_mesh()

    def __getitem__(self, key):
        from .runtime import device as dv

        mesh = self._mesh()
        rows = self._storage.num_rows
        if key == "__num_rows__":
            return rows if mesh is None else rows + (-rows) % mesh.size
        if mesh is not self._layout:
            self._cols.clear()
            self._layout = mesh
        if key == "__pad_mask__":
            # the rows past the true count are padding on a mesh
            if mesh is None or rows % mesh.size == 0:
                return None
            m = self._cols.get(key)
            if m is None:
                mask = np.zeros(self["__num_rows__"], np.bool_)
                mask[:rows] = True
                m, _ = dv.shard_column(mask, mesh)
                self._cols[key] = m
            return m
        c = self._cols.get(key)
        if c is None:
            col = self._storage.column(key)
            with tracer.Trace("runtime", f"upload:{self._storage.name}.{key}"):
                if mesh is not None:
                    compilestats.add("uploads")
                    c = self._shard(col, mesh)
                elif (rows < dv.SMALL_ROWS
                        or np.asarray(col.data).dtype == np.object_):
                    # small tables stay host numpy: operators run through
                    # the numpy twin backend with no device dispatch. Wide
                    # decimals (host Python ints) never upload.
                    c = SCol(col.type, np.ascontiguousarray(col.data),
                             col.valid, col.dictionary)
                else:
                    compilestats.add("uploads")
                    try:
                        c = self._upload(col)
                    except torch.cuda.OutOfMemoryError:
                        # device memory pressure: evict cached columns of
                        # other tables (reference analogue: buffer-manager
                        # style eviction; our unit is whole columns) and retry
                        if not self._evict_others():
                            raise
                        c = self._upload(col)
            self._cols[key] = c
        return c


def _column_from_physical(t, vals):
    """Build a storage Column from already-physical values (consteval.
    coerce_values')."""
    n = len(vals)
    valid = np.array([v is not None for v in vals], dtype=np.bool_)
    all_valid = bool(valid.all())
    if t.is_string:
        from .storage.column import encode_strings

        dictionary, codes = encode_strings(["" if v is None else str(v) for v in vals])
        return Column(t, codes, None if all_valid else valid, dictionary)
    from .storage.column import physical_dtype

    arr = np.zeros(n, dtype=physical_dtype(t))
    try:
        for i, v in enumerate(vals):
            if v is not None:
                arr[i] = v
    except OverflowError:
        # wide decimal beyond int64: exact Python-int object column
        arr = np.array([0 if v is None else int(v) for v in vals],
                       dtype=np.object_)
    return Column(t, arr, None if all_valid else valid)


def create_in_memory(device=None) -> Session:
    """In-memory session on `device` (default: the CUDA card; raises when
    there is none — pass device="cpu" to run on the host)."""
    return Session(None, device=device)


def connect_to_db(path: str, device=None) -> Session:
    return Session(path, device=device)
