"""Reference (LingoDB) on-disk database format: read AND write.

A LingoDB database directory is
  - `db.lingodb`    — binary catalog (reference: src/catalog/Catalog.cpp:21-24,
                      utility/Serialization.h wire format: little-endian fixed
                      width values, u16 property markers written before and
                      after each value, objects bracketed by 0xFFFE/0xFFFF,
                      optionals/pointers prefixed 0xFFFC present / 0xFFFD not)
  - `<table>.arrow` — one Arrow IPC *file* per table
                      (reference: src/runtime/storage/LingoDBTable.cpp:27-54)
  - `<index>.idx`   — hash-index payloads (not consumed here; indexes rebuild
                      as in-session lookup tables)

This module implements that format so the engine can open database
directories created by reference tooling and export its own catalogs in a
layout the reference can open (plain utf8 / decimal128 arrays — the
reference's ArrowView has no dictionary-array path).

Entry/type tag values are mirrored from:
  CatalogEntryType             include/lingodb/catalog/Catalog.h:16-22
  LogicalTypeId / TypeInfoType include/lingodb/catalog/Types.h:17-42
  LingoDBTable::serialize      src/runtime/storage/LingoDBTable.cpp:306-313
  Sample / ColumnStatistics    src/catalog/MetaData.cpp:21-111
  HyperLogLog registers (m=64) include/lingodb/utility/HyperLogLog.h:13-15
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

from ..sql.types import IntervalUnit, K, Type

PRESENT = 0xFFFC
NOT_PRESENT = 0xFFFD
OBJ_START = 0xFFFE
OBJ_END = 0xFFFF
BINARY_VERSION = 3

# CatalogEntryType (Catalog.h:16)
T_TABLE = 1
T_HASH_INDEX = 2
T_C_FUNCTION = 3
T_PY_FUNCTION = 4

# LogicalTypeId (Types.h:17)
LT_BOOL, LT_INT, LT_FLOAT, LT_DOUBLE = 2, 3, 4, 5
LT_DECIMAL, LT_DATE, LT_TIMESTAMP, LT_INTERVAL = 6, 7, 8, 9
LT_CHAR, LT_STRING, LT_NONE = 10, 11, 12

# TypeInfoType (Types.h:35)
TI_INT, TI_DECIMAL, TI_STRING, TI_TIMESTAMP, TI_CHAR, TI_DATE, TI_INTERVAL = range(7)

HLL_M = 64  # registers (HyperLogLog.h: p=6)


class _Reader:
    def __init__(self, data: bytes):
        self.b = data
        self.o = 0

    def raw(self, n: int) -> bytes:
        v = self.b[self.o:self.o + n]
        if len(v) != n:
            raise ValueError("refformat: truncated db.lingodb")
        self.o += n
        return v

    def u8(self):
        return self.raw(1)[0]

    def u16(self):
        return struct.unpack("<H", self.raw(2))[0]

    def u64(self):
        return struct.unpack("<Q", self.raw(8))[0]

    def boolean(self):
        return self.raw(1)[0] != 0

    def string(self) -> bytes:
        return self.raw(self.u64())

    def marker(self, want: int | None = None) -> int:
        m = self.u16()
        if want is not None and m != want:
            raise ValueError(f"refformat: marker {m:#x}, expected {want:#x}")
        return m

    def prop(self, pid: int, read_value):
        self.marker(pid)
        v = read_value()
        self.marker(pid)
        return v

    def obj(self, read_body):
        self.marker(OBJ_START)
        v = read_body()
        self.marker(OBJ_END)
        return v

    def optional(self, read_value):
        if self.u16() == NOT_PRESENT:
            return None
        return read_value()

    def vec(self, read_item) -> list:
        return [read_item() for _ in range(self.u64())]


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def u8(self, v):
        self.raw(struct.pack("<B", v))

    def u16(self, v):
        self.raw(struct.pack("<H", v))

    def u64(self, v):
        self.raw(struct.pack("<Q", v))

    def boolean(self, v):
        self.raw(b"\x01" if v else b"\x00")

    def string(self, s):
        b = s if isinstance(s, bytes) else str(s).encode()
        self.u64(len(b))
        self.raw(b)

    def prop(self, pid: int, write_value):
        self.u16(pid)
        write_value()
        self.u16(pid)

    def obj(self, write_body):
        self.u16(OBJ_START)
        write_body()
        self.u16(OBJ_END)

    def optional(self, value, write_value):
        if value is None:
            self.u16(NOT_PRESENT)
        else:
            self.u16(PRESENT)
            write_value(value)

    def vec(self, items, write_item):
        self.u64(len(items))
        for it in items:
            write_item(it)

    def bytes_(self) -> bytes:
        return b"".join(self.parts)


# --------------------------------------------------------------------- types
def _read_type(r: _Reader) -> Type:
    def body():
        lt = r.prop(0, r.u8)  # LogicalTypeId (u8 enum)

        def info_body():
            ti = r.prop(42, r.u8)
            if ti == TI_INT:
                signed = r.prop(0, r.boolean)
                width = r.prop(1, r.u64)
                return ("int", signed, width)
            if ti == TI_DECIMAL:
                p = r.prop(0, r.u64)
                s = r.prop(1, r.u64)
                return ("dec", p, s)
            if ti == TI_STRING:
                collation = r.prop(0, r.string)
                maxlen = r.prop(1, lambda: r.optional(r.u64))
                return ("str", collation, maxlen)
            if ti == TI_TIMESTAMP:
                tz = r.prop(0, lambda: r.optional(r.string))
                unit = r.prop(1, r.u8)
                return ("ts", tz, unit)
            if ti == TI_CHAR:
                return ("char", r.prop(0, r.u64))
            if ti == TI_DATE:
                return ("date", r.prop(0, r.u8))
            if ti == TI_INTERVAL:
                return ("iv", r.prop(0, r.u8))
            raise ValueError(f"refformat: TypeInfoType {ti}")

        info = r.prop(1, lambda: r.optional(lambda: r.obj(info_body)))
        return lt, info

    lt, info = r.obj(body)
    # nullability lives on the Column, not the Type: default nullable here,
    # the column reader overrides it
    if lt == LT_BOOL:
        return Type.bool_(True)
    if lt == LT_INT:
        width = info[2] if info else 32
        return Type.bigint(True) if width > 32 else Type.int_(True)
    if lt == LT_FLOAT:
        return Type.float_(True)
    if lt == LT_DOUBLE:
        return Type.double(True)
    if lt == LT_DECIMAL:
        return Type.decimal(info[1], info[2], True)
    if lt == LT_DATE:
        return Type.date(True)  # day or ms: values normalize to days on load
    if lt == LT_TIMESTAMP:
        return Type.timestamp(True)
    if lt == LT_INTERVAL:
        return Type.interval(
            IntervalUnit.MONTH if info[1] == 0 else IntervalUnit.DAYTIME, True)
    if lt == LT_CHAR:
        return Type.char(info[1], True)
    if lt == LT_STRING:
        maxlen = info[2] if info else None
        return Type(K.STRING, True, p=maxlen or 0)
    raise ValueError(f"refformat: LogicalTypeId {lt}")


def _write_type(w: _Writer, t: Type):
    def info(ti, body):
        def whole():
            w.u16(PRESENT)

            def b():
                w.prop(42, lambda: w.u8(ti))
                body()

            w.obj(b)

        return whole

    def body():
        if t.kind == K.BOOL:
            w.prop(0, lambda: w.u8(LT_BOOL))
            w.prop(1, lambda: w.u16(NOT_PRESENT))
        elif t.kind in (K.INT, K.BIGINT):
            w.prop(0, lambda: w.u8(LT_INT))
            width = 64 if t.kind == K.BIGINT else 32
            w.prop(1, info(TI_INT, lambda: (
                w.prop(0, lambda: w.boolean(True)),
                w.prop(1, lambda: w.u64(width)))))
        elif t.kind == K.FLOAT:
            w.prop(0, lambda: w.u8(LT_FLOAT))
            w.prop(1, lambda: w.u16(NOT_PRESENT))
        elif t.kind == K.DOUBLE:
            w.prop(0, lambda: w.u8(LT_DOUBLE))
            w.prop(1, lambda: w.u16(NOT_PRESENT))
        elif t.kind == K.DECIMAL:
            w.prop(0, lambda: w.u8(LT_DECIMAL))
            w.prop(1, info(TI_DECIMAL, lambda: (
                w.prop(0, lambda: w.u64(t.p)),
                w.prop(1, lambda: w.u64(t.s)))))
        elif t.kind == K.DATE:
            w.prop(0, lambda: w.u8(LT_DATE))
            w.prop(1, info(TI_DATE, lambda: w.prop(0, lambda: w.u8(0))))  # DAY
        elif t.kind == K.TIMESTAMP:
            w.prop(0, lambda: w.u8(LT_TIMESTAMP))
            w.prop(1, info(TI_TIMESTAMP, lambda: (
                w.prop(0, lambda: w.u16(NOT_PRESENT)),  # no timezone
                w.prop(1, lambda: w.u8(2)))))  # MICROS
        elif t.kind == K.INTERVAL:
            w.prop(0, lambda: w.u8(LT_INTERVAL))
            unit = 0 if t.unit == IntervalUnit.MONTH else 1
            w.prop(1, info(TI_INTERVAL, lambda: w.prop(0, lambda: w.u8(unit))))
        elif t.kind == K.CHAR:
            w.prop(0, lambda: w.u8(LT_CHAR))
            w.prop(1, info(TI_CHAR, lambda: w.prop(0, lambda: w.u64(t.p or 1))))
        elif t.is_string:
            w.prop(0, lambda: w.u8(LT_STRING))
            w.prop(1, info(TI_STRING, lambda: (
                w.prop(0, lambda: w.string("")),
                w.prop(1, lambda: (
                    w.optional(t.p if t.p else None, w.u64))))))
        else:
            raise ValueError(f"refformat: cannot serialize type {t}")

    w.obj(body)


# ------------------------------------------------------------------- entries
@dataclass
class RefTable:
    name: str
    column_names: list[str]
    column_types: list[Type]
    primary_key: list[str]
    index_names: list[str]
    file_name: str
    num_rows: int
    sample_ipc: bytes = b""
    schema_ipc: bytes = b""  # arrow-serialized schema (write side)
    hll_registers: dict = field(default_factory=dict)  # col -> bytes(64) | None


@dataclass
class RefIndex:
    name: str
    table: str
    columns: list[str]
    file_name: str


@dataclass
class RefFunction:
    name: str
    entry_type: int  # T_C_FUNCTION | T_PY_FUNCTION
    code: str
    return_type: Type | None
    arg_types: list[Type] = field(default_factory=list)


@dataclass
class RefCatalog:
    tables: list[RefTable] = field(default_factory=list)
    indexes: list[RefIndex] = field(default_factory=list)
    functions: list[RefFunction] = field(default_factory=list)


def _read_hll(r: _Reader):
    def body():
        regs = bytearray(HLL_M)
        for i in range(HLL_M):
            regs[i] = r.prop(i, r.u8)
        return bytes(regs)

    return r.obj(body)


def _read_column_stats(r: _Reader):
    def body():
        return r.prop(1, lambda: r.optional(_readwrap(r, _read_hll)))

    return r.obj(body)


def _readwrap(r, fn):
    return lambda: fn(r)


def _read_table_entry(r: _Reader) -> RefTable:
    name = r.prop(2, r.string).decode()
    ncols = r.prop(3, r.u64)
    cols = []
    for _ in range(ncols):
        # Column::serialize (src/catalog/Column.cpp:6-10): 1=name, 2=type,
        # 3=isNullable
        def col_body():
            cname = r.prop(1, r.string).decode()
            ctype = r.prop(2, lambda: _read_type(r))
            is_nullable = r.prop(3, r.boolean)
            return cname, ctype, is_nullable

        cname, ctype, is_nullable = r.prop(4, lambda: r.obj(col_body))
        cols.append((cname, _set_nullable(ctype, is_nullable)))
    pk = [s.decode() for s in r.prop(8, lambda: r.vec(r.string))]
    indices = [s.decode() for s in r.prop(9, lambda: r.vec(r.string))]

    # impl: unique_ptr<LingoDBTable> (LingoDBTable.cpp:306-313)
    def impl_body():
        file_name = r.prop(1, r.string).decode()

        def sample_body():
            return r.prop(1, r.string)

        sample_ipc = r.prop(2, lambda: r.obj(sample_body))
        r.prop(3, r.string)  # serialized arrow schema (redundant with types)
        hll = {}

        def stats_map():
            out = {}
            for _ in range(r.u64()):
                cname = r.string().decode()
                out[cname] = _read_column_stats(r)
            return out

        hll = r.prop(4, stats_map)
        num_rows = r.prop(5, r.u64)
        return file_name, sample_ipc, hll, num_rows

    def impl():
        if r.u16() == NOT_PRESENT:
            return "", b"", {}, 0
        return r.obj(impl_body)

    file_name, sample_ipc, hll, num_rows = r.prop(10, impl)
    return RefTable(name, [c[0] for c in cols], [c[1] for c in cols], pk,
                    indices, file_name or f"{name}.arrow", num_rows,
                    sample_ipc, hll)


def _set_nullable(t: Type, nullable: bool) -> Type:
    return Type(t.kind, nullable, t.p, t.s, t.unit)


def _read_index_entry(r: _Reader) -> RefIndex:
    name = r.prop(2, r.string).decode()
    table = r.prop(3, r.string).decode()
    cols = [s.decode() for s in r.prop(4, lambda: r.vec(r.string))]

    def impl_body():
        fn = r.prop(0, r.string).decode()
        r.prop(1, lambda: r.vec(r.string))
        return fn

    def impl():
        if r.u16() == NOT_PRESENT:
            return ""
        return r.obj(impl_body)

    file_name = r.prop(5, impl)
    return RefIndex(name, table, cols, file_name)


def _read_function_entry(r: _Reader, outer_type: int) -> RefFunction:
    # FunctionCatalogEntry::serializeEntry repeats the entry type as prop 1
    et = r.prop(1, r.u8)
    name = r.prop(2, r.string).decode()
    code = r.prop(3, r.string).decode()
    rt = r.prop(4, lambda: _read_type(r))
    args = r.prop(5, lambda: r.vec(lambda: _read_type(r)))
    return RefFunction(name, et or outer_type, code, rt, args)


def read_catalog(db_dir: str) -> RefCatalog:
    """Parse `db.lingodb` (reference: Catalog::persist writes the whole catalog
    as `writeProperty(0, *this)` — Catalog.cpp:63-75 — so the file is one
    property-0-wrapped object holding {prop 0: version, prop 1: entry map})."""
    with open(os.path.join(db_dir, "db.lingodb"), "rb") as f:
        r = _Reader(f.read())
    r.marker(0)            # outer writeProperty(0, catalog)
    r.marker(OBJ_START)
    version = r.prop(0, r.u64)
    if version != BINARY_VERSION:
        raise ValueError(f"refformat: binary version {version}, expected {BINARY_VERSION}")
    out = RefCatalog()

    def read_entry():
        # shared_ptr<CatalogEntry>: present marker + object
        m = r.u16()
        if m == NOT_PRESENT:
            return None

        def body():
            et = r.prop(1, r.u8)
            if et == T_TABLE:
                return _read_table_entry(r)
            if et == T_HASH_INDEX:
                return _read_index_entry(r)
            if et in (T_C_FUNCTION, T_PY_FUNCTION):
                return _read_function_entry(r, et)
            raise ValueError(f"refformat: entry type {et}")

        return r.obj(body)

    def entries():
        n = r.u64()
        for _ in range(n):
            r.string()  # map key repeats the entry name
            e = read_entry()
            if isinstance(e, RefTable):
                out.tables.append(e)
            elif isinstance(e, RefIndex):
                out.indexes.append(e)
            elif isinstance(e, RefFunction):
                out.functions.append(e)

    r.prop(1, entries)
    r.marker(OBJ_END)
    r.marker(0)
    return out


# -------------------------------------------------------------------- write
def _write_column(w: _Writer, name: str, t: Type):
    def body():
        w.prop(1, lambda: w.string(name))
        w.prop(2, lambda: _write_type(w, t))
        w.prop(3, lambda: w.boolean(t.nullable))

    w.obj(body)


def _write_hll(w: _Writer, regs: bytes):
    def body():
        for i in range(HLL_M):
            w.prop(i, lambda v=regs[i]: w.u8(v))

    w.obj(body)


def _write_table_entry(w: _Writer, t: RefTable):
    w.prop(2, lambda: w.string(t.name))
    w.prop(3, lambda: w.u64(len(t.column_names)))
    for cname, ctype in zip(t.column_names, t.column_types):
        w.prop(4, lambda cn=cname, ct=ctype: _write_column(w, cn, ct))
    w.prop(8, lambda: w.vec(t.primary_key, w.string))
    w.prop(9, lambda: w.vec(t.index_names, w.string))

    def impl_body():
        w.prop(1, lambda: w.string(t.file_name))
        w.prop(2, lambda: w.obj(lambda: w.prop(1, lambda: w.string(t.sample_ipc))))
        w.prop(3, lambda: w.string(t.schema_ipc))

        def stats_map():
            w.u64(len(t.column_names))
            for cname in t.column_names:
                w.string(cname)
                regs = t.hll_registers.get(cname)

                def stats_body(rg=regs):
                    w.prop(1, lambda: w.optional(rg, lambda v: _write_hll(w, v)))

                w.obj(stats_body)

        w.prop(4, stats_map)
        w.prop(5, lambda: w.u64(t.num_rows))

    def impl():
        w.u16(PRESENT)
        w.obj(impl_body)

    w.prop(10, impl)


def write_catalog(db_dir: str, cat: RefCatalog):
    """Write `db.lingodb` (reference: Catalog::persist, Catalog.cpp:63-75:
    the whole catalog is one property-0-wrapped object)."""
    w = _Writer()

    def catalog_body():
        w.prop(0, lambda: w.u64(BINARY_VERSION))

        def entries():
            items = [(t.name, T_TABLE, t) for t in cat.tables]
            items += [(i.name, T_HASH_INDEX, i) for i in cat.indexes]
            items += [(f.name, f.entry_type, f) for f in cat.functions]
            w.u64(len(items))
            for name, et, obj in items:
                w.string(name)
                w.u16(PRESENT)

                def body(e=et, o=obj):
                    w.prop(1, lambda: w.u8(e))
                    if e == T_TABLE:
                        _write_table_entry(w, o)
                    elif e == T_HASH_INDEX:
                        _write_index_entry(w, o)
                    else:
                        _write_function_entry(w, o)

                w.obj(body)

        w.prop(1, entries)

    w.prop(0, lambda: w.obj(catalog_body))
    with open(os.path.join(db_dir, "db.lingodb"), "wb") as f:
        f.write(w.bytes_())


_C_TYPE_NAMES = {
    K.INT: "int64_t", K.BIGINT: "int64_t",
    K.CHAR: "char", K.DOUBLE: "double", K.FLOAT: "float", K.BOOL: "bool",
}


def join_function_code(language: str, name: str, arg_names, arg_types,
                       return_type: Type, body: str) -> str:
    """Produce the `code` string the reference stores in its catalog. For C
    the SQL frontend wraps the $$ body in a full function definition
    (sql_mlir_translator.cpp:231-243); python bodies are stored verbatim
    (they are complete `def`s)."""
    if language != "c":
        return body
    names = list(arg_names) or [f"a{i}" for i in range(len(arg_types))]
    args = ", ".join(
        f"{_C_TYPE_NAMES.get(t.kind, 'int64_t')} {n}"
        for n, t in zip(names, arg_types))
    ret = _C_TYPE_NAMES.get(return_type.kind, "int64_t")
    return f"{ret} {name}({args}) {{ {body}}}"


def split_function_code(language: str, code: str) -> tuple[list, str]:
    """Invert join_function_code: recover (arg_names, body) from a stored
    reference `code` string."""
    import re

    if language != "c":
        return [], code
    m = re.match(r"\s*\w+\s+\w+\s*\(([^)]*)\)\s*\{(.*)\}\s*$", code, re.S)
    if not m:
        return [], code  # unrecognized wrapper: treat whole code as body
    arg_names = [a.split()[-1].lstrip("*") for a in m.group(1).split(",") if a.strip()]
    return arg_names, m.group(2)


def _write_function_entry(w: _Writer, fn: RefFunction):
    # FunctionCatalogEntry::serializeEntry (FunctionCatalogEntry.cpp:12-17)
    # repeats the entry type as prop 1 inside the entry body
    w.prop(1, lambda: w.u8(fn.entry_type))
    w.prop(2, lambda: w.string(fn.name))
    w.prop(3, lambda: w.string(fn.code))
    w.prop(4, lambda: _write_type(w, fn.return_type))
    w.prop(5, lambda: w.vec(fn.arg_types, lambda t: _write_type(w, t)))


def _write_index_entry(w: _Writer, ix: RefIndex):
    w.prop(2, lambda: w.string(ix.name))
    w.prop(3, lambda: w.string(ix.table))
    w.prop(4, lambda: w.vec(ix.columns, w.string))

    def impl_body():
        w.prop(0, lambda: w.string(ix.file_name))
        w.prop(1, lambda: w.vec(ix.columns, w.string))

    def impl():
        w.u16(PRESENT)
        w.obj(impl_body)

    w.prop(5, impl)
