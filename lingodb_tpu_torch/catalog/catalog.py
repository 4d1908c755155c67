"""Catalog: named tables with schema, keys, and statistics.

Equivalent of the reference catalog
(reference: src/catalog/Catalog.cpp, include/lingodb/catalog/Catalog.h:14-92 —
versioned serializable name->entry map persisted in the DB directory;
TableCatalogEntry with Sample + per-column distinct-count statistics,
reference: src/catalog/MetaData.h:17-57). We persist a JSON catalog plus one
Arrow IPC file per table.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from ..sql.types import IntervalUnit, K, Type
from ..storage.table import TableStorage

CATALOG_VERSION = 1


def type_to_json(t: Type) -> dict:
    return {
        "kind": t.kind.value,
        "nullable": t.nullable,
        "p": t.p,
        "s": t.s,
        "unit": t.unit.value if t.unit else None,
    }


def type_from_json(d: dict) -> Type:
    return Type(K(d["kind"]), d["nullable"], d["p"], d["s"],
                IntervalUnit(d["unit"]) if d.get("unit") else None)


@dataclass
class TableEntry:
    name: str
    column_names: list[str]
    column_types: list[Type]
    primary_key: list[str] = field(default_factory=list)
    storage: TableStorage | None = None
    stats: list[dict] = field(default_factory=list)
    stats_version: int = -1
    # hash indexes: index name -> key columns (reference: IndexCatalogEntry,
    # LingoDBHashIndex; execution uses cached key->position lookup tables)
    indexes: dict = field(default_factory=dict)
    # runtime cache of built/loaded index payloads (storage/hashindex.py)
    index_payloads: dict = field(default_factory=dict)

    def index_payload(self, iname: str, db_dir: str | None = None,
                      persist: bool = False) -> dict:
        """The index's probe payload: from the in-session cache, else the
        persisted `<index>.idx` file, else built from the table data (and
        written back when `persist`). Staleness is detected by row count —
        tables are append-only (reference: LingoDBHashIndex::flush rewrites
        the file on append, LingoDBHashIndex.cpp)."""
        import os

        from ..storage import hashindex as hx

        p = self.index_payloads.get(iname)
        if p is not None and p["rows"] == self.num_rows:
            return p
        path = os.path.join(db_dir, f"{iname}.idx") if db_dir else None
        if path and os.path.exists(path):
            p = hx.load(path)
            if p is not None and p["rows"] == self.num_rows:
                self.index_payloads[iname] = p
                return p
        p = hx.build(self, self.indexes[iname])
        self.index_payloads[iname] = p
        if path and persist and p.get("kind") in ("dense", "sorted"):
            hx.save(path, p)
        return p

    def index_on(self, cols: list[str]) -> str | None:
        """Name of an index whose key set equals `cols`, if any."""
        want = set(c.lower() for c in cols)
        for iname, icols in self.indexes.items():
            if set(c.lower() for c in icols) == want:
                return iname
        return None

    @property
    def num_rows(self) -> int:
        return self.storage.num_rows if self.storage else 0

    def col_type(self, name: str) -> Type:
        return self.column_types[self.column_names.index(name)]

    def get_stats(self) -> list[dict]:
        if self.storage and self.stats_version != self.storage.version:
            self.stats = self.storage.column_stats()
            self.stats_version = self.storage.version
        return self.stats

    def distinct_count(self, col: str) -> int:
        st = self.get_stats()
        i = self.column_names.index(col)
        if i >= len(st):
            return max(self.num_rows, 1)
        d = st[i].get("distinct")
        if d is None and self.storage is not None:
            # lazy per-column sketch: computed on first request, cached in
            # the stats (and persisted with them)
            d = st[i]["distinct"] = self.storage.distinct_for(i)
        return d if d is not None else max(self.num_rows, 1)


@dataclass
class FunctionEntry:
    """User-defined function (reference: FunctionCatalogEntry; C/Python UDFs)."""

    name: str
    arg_types: list[Type]
    return_type: Type
    language: str  # "python" | "c" | "sql" | "builtin"
    body: str = ""
    fn: object = None  # compiled callable
    arg_names: list = field(default_factory=list)


def compile_function(entry: FunctionEntry):
    """Compile a UDF entry and register it for scalar eval (used both by
    CREATE FUNCTION and when loading a persisted catalog; reference:
    UDFImplementer + FunctionCatalogEntry)."""
    from ..ops.scalar import udf_register
    from ..runtime import udf as udfmod

    arg_names = list(entry.arg_names) or [f"a{i}" for i in range(len(entry.arg_types))]
    if entry.language == "c":
        entry.fn = udfmod.compile_c_udf(
            entry.name, arg_names, entry.arg_types, entry.return_type, entry.body)
    elif entry.language == "python":
        entry.fn = udfmod.make_python_udf(
            entry.name, arg_names, entry.arg_types, entry.return_type, entry.body)
    else:
        raise NotImplementedError(f"UDF language {entry.language}")
    udf_register(entry.name, entry.fn)
    return entry.fn


class Catalog:
    def __init__(self, db_dir: str | None = None):
        self.db_dir = db_dir
        self.tables: dict[str, TableEntry] = {}
        self.functions: dict[str, FunctionEntry] = {}
        self.persist = bool(db_dir)
        # ref_format: the directory was created by reference (LingoDB) tooling
        # (binary db.lingodb catalog); saves keep writing that format.
        self.ref_format = False
        if db_dir and os.path.exists(os.path.join(db_dir, "catalog.json")):
            self._load()
        elif db_dir and os.path.exists(os.path.join(db_dir, "db.lingodb")):
            self.ref_format = True
            self._load_ref()

    # ---- table management ---------------------------------------------------
    def create_table(self, name, column_names, column_types, primary_key=()):
        if name in self.tables:
            raise ValueError(f"table '{name}' already exists")
        storage = TableStorage.create(name, column_names, column_types)
        entry = TableEntry(name, list(column_names), list(column_types),
                           list(primary_key), storage)
        self.tables[name] = entry
        return entry

    def drop_table(self, name):
        self.tables.pop(name, None)
        if self.persist:
            p = os.path.join(self.db_dir, f"{name}.arrow")
            if os.path.exists(p):
                os.remove(p)

    def get_table(self, name) -> TableEntry | None:
        return self.tables.get(name.lower()) or self.tables.get(name)

    def create_index(self, index_name, table_name, columns):
        entry = self.get_table(table_name)
        if entry is None:
            raise ValueError(f"table '{table_name}' does not exist")
        for c in columns:
            if c not in entry.column_names and c.lower() not in entry.column_names:
                raise ValueError(f"column '{c}' does not exist in '{table_name}'")
        entry.indexes[index_name] = list(columns)
        if self.persist and entry.storage is not None:
            os.makedirs(self.db_dir, exist_ok=True)
            entry.index_payload(index_name, self.db_dir, persist=True)
        return entry

    def create_function(self, entry: FunctionEntry):
        self.functions[entry.name.lower()] = entry

    def get_function(self, name) -> FunctionEntry | None:
        return self.functions.get(name.lower())

    # ---- persistence ----------------------------------------------------------
    def save(self):
        if not self.persist:
            return
        os.makedirs(self.db_dir, exist_ok=True)
        if self.ref_format:
            self.save_reference(self.db_dir)
            return
        meta = {"version": CATALOG_VERSION, "tables": [], "functions": []}
        for entry in self.tables.values():
            regs = entry.storage.hll_regs if entry.storage else None
            meta["tables"].append(
                {
                    "name": entry.name,
                    "columns": [
                        {"name": n, "type": type_to_json(t)}
                        for n, t in zip(entry.column_names, entry.column_types)
                    ],
                    "primary_key": entry.primary_key,
                    "num_rows": entry.num_rows,
                    "stats": entry.get_stats(),
                    # HLL sketches persist so appends keep merging instead of
                    # rescanning (reference: ColumnStatistics in db.lingodb);
                    # string columns carry None (distinct = dictionary size)
                    "hll": None if regs is None else [
                        None if r is None else bytes(r).hex() for r in regs],
                    "indexes": entry.indexes,
                }
            )
            if entry.storage:
                entry.storage.save(self.db_dir)
            for iname in entry.indexes:
                # refresh stale index payload files (appends since last save)
                entry.index_payload(iname, self.db_dir, persist=True)
        for fe in self.functions.values():
            if fe.language not in ("c", "python"):
                continue  # builtins are not persisted
            meta["functions"].append(
                {
                    "name": fe.name,
                    "language": fe.language,
                    "body": fe.body,
                    "arg_names": list(fe.arg_names),
                    "arg_types": [type_to_json(t) for t in fe.arg_types],
                    "return_type": type_to_json(fe.return_type),
                }
            )
        with open(os.path.join(self.db_dir, "catalog.json"), "w") as f:
            json.dump(meta, f, indent=1)

    def _load(self):
        import numpy as np

        with open(os.path.join(self.db_dir, "catalog.json")) as f:
            meta = json.load(f)
        for t in meta["tables"]:
            names = [c["name"] for c in t["columns"]]
            types = [type_from_json(c["type"]) for c in t["columns"]]
            storage = TableStorage.load(t["name"], self.db_dir, names, types)
            entry = TableEntry(t["name"], names, types, t.get("primary_key", []), storage)
            entry.indexes = t.get("indexes", {})
            entry.stats = t.get("stats", [])
            entry.stats_version = storage.version
            if t.get("hll"):
                storage.hll_regs = [
                    None if h is None
                    else np.frombuffer(bytes.fromhex(h), dtype=np.uint8).copy()
                    for h in t["hll"]
                ]
            self.tables[t["name"]] = entry
        for f in meta.get("functions", []):
            fe = FunctionEntry(
                f["name"],
                [type_from_json(t) for t in f["arg_types"]],
                type_from_json(f["return_type"]),
                f["language"], f["body"], None, f.get("arg_names", []),
            )
            compile_function(fe)
            self.functions[fe.name.lower()] = fe

    # ---- reference (LingoDB) format interop -----------------------------------
    def _load_ref(self):
        """Open a database directory created by reference tooling
        (db.lingodb binary catalog + one Arrow IPC file per table;
        reference: Catalog::create, src/catalog/Catalog.cpp:76-95)."""
        from ..storage import refformat
        from ..utils import hll as hllmod

        rc = refformat.read_catalog(self.db_dir)
        ref_indexes = {}
        for ix in rc.indexes:
            ref_indexes.setdefault(ix.table, {})[ix.name] = list(ix.columns)
        for rt in rc.tables:
            if os.path.exists(os.path.join(self.db_dir, rt.file_name)):
                storage = TableStorage.load(
                    rt.name, self.db_dir, rt.column_names, rt.column_types,
                    file_name=rt.file_name)
            else:  # catalog entry with no flushed data yet
                storage = TableStorage.create(
                    rt.name, rt.column_names, rt.column_types)
            entry = TableEntry(rt.name, rt.column_names, rt.column_types,
                               rt.primary_key, storage)
            entry.indexes = ref_indexes.get(rt.name, {})
            # adopt the persisted sketches for distinct estimates; register
            # contents come from the reference's hash so they are NOT merged
            # with ours on append (append recomputes from scratch instead)
            stats = []
            for cname in rt.column_names:
                regs = rt.hll_registers.get(cname)
                st = {}
                if regs is not None:
                    st["distinct"] = max(
                        1, min(int(hllmod.estimate(regs)), storage.num_rows))
                stats.append(st)
            entry.stats = stats
            entry.stats_version = storage.version
            self.tables[rt.name] = entry
        for rf in rc.functions:
            lang = "c" if rf.entry_type == refformat.T_C_FUNCTION else "python"
            arg_names, body = refformat.split_function_code(lang, rf.code)
            fe = FunctionEntry(rf.name, rf.arg_types, rf.return_type, lang,
                               body, None, arg_names)
            compile_function(fe)
            self.functions[fe.name.lower()] = fe

    def save_reference(self, db_dir: str):
        """Write this catalog as a reference-format database directory
        (db.lingodb + plain-encoded Arrow IPC files the reference can scan;
        reference: Catalog::persist, src/catalog/Catalog.cpp:63-75)."""
        import pyarrow.ipc as ipc

        from ..storage import refformat

        os.makedirs(db_dir, exist_ok=True)
        rc = refformat.RefCatalog()
        for entry in self.tables.values():
            st = entry.storage or TableStorage.create(
                entry.name, entry.column_names, entry.column_types)
            file_name = f"{entry.name}.arrow"
            tbl = st.to_arrow_table(ref_compat=True)
            path = os.path.join(db_dir, file_name)
            with ipc.RecordBatchFileWriter(path, tbl.schema) as w:
                w.write_table(tbl)
            sample = tbl.slice(0, min(len(tbl), 1024)).combine_chunks()
            import io

            buf = io.BytesIO()
            with ipc.RecordBatchStreamWriter(buf, tbl.schema) as w:
                w.write_table(sample)
            regs = st.export_hll() if st.num_rows else None
            rc.tables.append(refformat.RefTable(
                entry.name, entry.column_names, entry.column_types,
                entry.primary_key, list(entry.indexes.keys()), file_name,
                st.num_rows, buf.getvalue(),
                tbl.schema.serialize().to_pybytes(),
                {} if regs is None else {
                    n: bytes(r) for n, r in zip(entry.column_names, regs)},
            ))
            for iname, icols in entry.indexes.items():
                rc.indexes.append(refformat.RefIndex(
                    iname, entry.name, list(icols), f"{iname}.idx"))
        for fe in self.functions.values():
            if fe.language not in ("c", "python"):
                continue
            rc.functions.append(refformat.RefFunction(
                fe.name,
                refformat.T_C_FUNCTION if fe.language == "c"
                else refformat.T_PY_FUNCTION,
                refformat.join_function_code(
                    fe.language, fe.name, fe.arg_names, fe.arg_types,
                    fe.return_type, fe.body),
                fe.return_type, list(fe.arg_types)))
        refformat.write_catalog(db_dir, rc)


def arrow_schema_types(schema):
    """Map a pyarrow schema to (names, engine Types) (used by
    Session.add_table; reference: create_create_table_stmt in the pip pkg)."""
    import pyarrow as pa

    from ..sql.types import Type

    names, types = [], []
    for f in schema:
        t = f.type
        if pa.types.is_dictionary(t):
            t = t.value_type
        if pa.types.is_boolean(t):
            ours = Type.bool_(True)
        elif pa.types.is_int8(t) or pa.types.is_int16(t) or pa.types.is_int32(t):
            ours = Type.int_(True)
        elif pa.types.is_integer(t):
            ours = Type.bigint(True)
        elif pa.types.is_float32(t):
            ours = Type.float_(True)
        elif pa.types.is_floating(t):
            ours = Type.double(True)
        elif pa.types.is_decimal(t):
            ours = Type.decimal(t.precision, t.scale, True)
        elif pa.types.is_date(t):
            ours = Type.date(True)
        elif pa.types.is_timestamp(t):
            ours = Type.timestamp(True)
        else:
            ours = Type.string(True)
        names.append(f.name)
        types.append(ours)
    return names, types
