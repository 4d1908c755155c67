"""The port's counterpart of tests/test_refformat.py (the reference's on-disk
database directory): the same cases on the port's sessions (device="cpu"),
each held against the JAX package on the same statements, and cases across
the two packages: a directory that either exports opens in the other with
the exporting session's rows, and the two exports of the same statements
are byte-equal. What the reference file says of its subject:

The binary db.lingodb catalog format is implemented byte-for-byte from the
reference serializer (reference: src/catalog/Catalog.cpp:21-75,
utility/Serialization.h wire format, src/runtime/storage/LingoDBTable.cpp:
306-313). These tests round-trip write->open through that format, verify the
marker/property structure directly, and exercise the persisted HyperLogLog
sketches (include/lingodb/utility/HyperLogLog.h)."""

import io
import os
import struct

import numpy as np
import pytest

import lingodb_tpu as ref_ldb
import lingodb_tpu_torch as ldb

TYPES_DDL = (
    "create table t (i int not null, b bigint, f float, d double,"
    " dec decimal(8,2), wide decimal(30,4), dt date, ts timestamp,"
    " s varchar(20), c char(1), bo boolean)")
TYPES_ROWS = (
    "insert into t values"
    " (1, 100, 1.5, 2.5, 12.34, 12345678901234567890.1234,"
    "  '2020-01-02', '2020-01-02 03:04:05', 'hello', 'x', true),"
    " (2, null, null, null, null, null, null, null, null, null, null),"
    " (3, -7, 0.5, -0.25, -99.99, -1.0001,"
    "  '1999-12-31', '1999-12-31 23:59:59', 'wörld', 'y', false)")
TYPES_SQL = [TYPES_DDL, TYPES_ROWS,
             "create table d (id int not null primary key, v varchar(5))",
             "insert into d values (1,'a'),(2,'b'),(3,'c')",
             "create index d_id on d(id)"]
TYPES_QUERIES = ["select * from t order by i",
                 "select d.v, t.s from d, t where d.id = t.i order by d.v"]

PKGS = {"ref": ref_ldb, "port": ldb}


def _new(pkg):
    return (ldb.create_in_memory(device="cpu") if pkg is ldb
            else pkg.create_in_memory())


def _open(pkg, d):
    return (ldb.connect_to_db(d, device="cpu") if pkg is ldb
            else pkg.connect_to_db(d))


def _mkdb(tmp_path, name="refdb"):
    d = str(tmp_path / name)
    os.makedirs(d, exist_ok=True)
    return d


def _exported(tmp_path, pkg, sql, name):
    """Run `sql` in a fresh session of `pkg`, export it; (session, dir)."""
    s = _new(pkg)
    for q in sql:
        s.sql(q)
    d = _mkdb(tmp_path, name)
    s.export_reference(d)
    return s, d


@pytest.fixture()
def session():
    return ldb.create_in_memory(device="cpu")


@pytest.fixture()
def ref_session():
    return ref_ldb.create_in_memory()


def test_reference_roundtrip_types(tmp_path):
    """Every exportable column type survives session -> reference dir ->
    fresh session opened directly on the reference dir; the port's rows are
    the JAX package's."""
    got = {}
    for name, pkg in PKGS.items():
        _s, ref = _exported(tmp_path, pkg, [TYPES_DDL, TYPES_ROWS], name)
        assert os.path.exists(os.path.join(ref, "db.lingodb"))
        assert os.path.exists(os.path.join(ref, "t.arrow"))
        s2 = _open(pkg, ref)
        assert s2.catalog.ref_format
        got[name] = s2.sql("select * from t order by i").format_rows()
    r = got["port"]
    assert r[0] == ["1", "100", "1.5", "2.5", "12.34",
                    "12345678901234567890.1234", "2020-01-02",
                    "2020-01-02 03:04:05", "hello", "x", "t"]
    assert r[1][1:] == ["NULL"] * 10
    assert r[2][8:] == ["wörld", "y", "f"]
    assert r == got["ref"]


def test_reference_arrow_files_are_plain(tmp_path, session):
    """Exported .arrow files use the reference's physical encodings (plain
    utf8, decimal128, fsb(4) chars - LingoDBTable.cpp:141-191), so reference
    scan kernels (no dictionary-array path) can read them."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    session.sql("create table t (s varchar(10), dec decimal(6,2), c char(1))")
    session.sql("insert into t values ('aa', 1.25, 'z'), ('bb', -3.5, 'q')")
    ref = _mkdb(tmp_path)
    session.export_reference(ref)
    with ipc.open_file(os.path.join(ref, "t.arrow")) as rd:
        tbl = rd.read_all()
    assert pa.types.is_string(tbl.schema.field("s").type)
    assert pa.types.is_decimal(tbl.schema.field("dec").type)
    assert pa.types.is_fixed_size_binary(tbl.schema.field("c").type)
    assert tbl.schema.field("c").type.byte_width == 4
    assert tbl.column("s").to_pylist() == ["aa", "bb"]
    assert [str(v) for v in tbl.column("dec").to_pylist()] == ["1.25", "-3.50"]


def test_reference_catalog_wire_structure(tmp_path, session):
    """The db.lingodb byte stream has the exact outer structure the reference
    deserializer expects (Catalog.cpp:63-75: writeProperty(0, catalog) ->
    marker 0, object start, version prop, entry map)."""
    session.sql("create table x (a int)")
    session.sql("insert into x values (1)")
    ref = _mkdb(tmp_path)
    session.export_reference(ref)
    raw = open(os.path.join(ref, "db.lingodb"), "rb").read()
    # marker 0 | OBJ_START | prop-0 marker | version u64 | prop-0 marker ...
    assert struct.unpack_from("<H", raw, 0)[0] == 0
    assert struct.unpack_from("<H", raw, 2)[0] == 0xFFFE
    assert struct.unpack_from("<H", raw, 4)[0] == 0
    assert struct.unpack_from("<Q", raw, 6)[0] == 3  # binaryVersion
    assert struct.unpack_from("<H", raw, 14)[0] == 0
    # stream ends with OBJ_END + closing marker 0
    assert struct.unpack_from("<H", raw, len(raw) - 4)[0] == 0xFFFF
    assert struct.unpack_from("<H", raw, len(raw) - 2)[0] == 0


def test_reference_pk_index_and_stats(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        _s, ref = _exported(tmp_path, pkg, TYPES_SQL[2:], name)
        e = _open(pkg, ref).catalog.get_table("d")
        assert e.primary_key == ["id"]
        assert e.index_on(["id"]) == "d_id"
        assert e.distinct_count("id") >= 1
        got[name] = e.distinct_count("id")
    assert got["port"] == got["ref"]


def test_reference_udf_roundtrip(tmp_path):
    """C and python UDFs persist through the reference catalog's code-string
    convention (full C definition / verbatim python def,
    sql_mlir_translator.cpp:231-263) and recompile on open."""
    sql = ["create table ints (i int not null)",
           "insert into ints values (1),(2),(3)",
           "create function add_one(x int) returns int language c as"
           " $$ return x+1; $$",
           "create function py_dbl(x int) returns int as $$\n"
           "def py_dbl(x):\n    return x * 2\n$$ language python"]
    got = {}
    for name, pkg in PKGS.items():
        _s, ref = _exported(tmp_path, pkg, sql, name)
        got[name] = _open(pkg, ref).sql(
            "select add_one(i), py_dbl(i) from ints order by i").format_rows()
    assert got["port"] == [["2", "2"], ["3", "4"], ["4", "6"]] == got["ref"]


def test_reference_format_resaves_on_close(tmp_path, session):
    """A session opened on a reference dir keeps writing the reference format
    on close (appended rows + catalog survive a second open)."""
    session.sql("create table t (a int)")
    session.sql("insert into t values (1),(2)")
    ref = _mkdb(tmp_path)
    session.export_reference(ref)

    s2 = ldb.connect_to_db(ref, device="cpu")
    s2.sql("insert into t values (3)")
    s2.close()
    assert not os.path.exists(os.path.join(ref, "catalog.json"))

    s3 = ldb.connect_to_db(ref, device="cpu")
    assert s3.sql("select count(*), sum(a) from t").format_rows() == [["3", "6"]]
    # and the JAX package reads what the port wrote back
    assert ref_ldb.connect_to_db(ref).sql(
        "select count(*), sum(a) from t").format_rows() == [["3", "6"]]


def _hashes(lo, hi):
    from lingodb_tpu_torch.ops.hashing import splitmix64

    return np.asarray(splitmix64(np.arange(lo, hi, dtype=np.uint64)))


def test_hll_estimate_accuracy():
    """m=64 HLL standard error is ~1.04/sqrt(64) = 13%; check the Ertl
    estimator lands within 3 sigma across scales (HyperLogLog.cpp:41-56),
    with the JAX package's registers and estimate."""
    from lingodb_tpu.ops.hashing import splitmix64 as ref_splitmix64
    from lingodb_tpu.utils import hll as ref_hll
    from lingodb_tpu_torch.utils import hll

    for n in (10, 1000, 100_000):
        h = _hashes(0, n)
        assert np.array_equal(
            h, np.asarray(ref_splitmix64(np.arange(n, dtype=np.uint64))))
        regs = hll.registers_from_hashes(h)
        assert np.array_equal(regs, ref_hll.registers_from_hashes(h))
        est = hll.estimate(regs)
        assert est == ref_hll.estimate(regs)
        assert abs(est - n) <= max(3, 0.40 * n), (n, est)


def test_hll_merge_matches_union():
    from lingodb_tpu.utils import hll as ref_hll
    from lingodb_tpu_torch.utils import hll

    a, b = _hashes(0, 5000), _hashes(2500, 7500)
    ra, rb = hll.registers_from_hashes(a), hll.registers_from_hashes(b)
    merged = hll.merge(ra, rb)
    both = hll.registers_from_hashes(np.concatenate([a, b]))
    assert np.array_equal(merged, both)
    assert np.array_equal(merged, ref_hll.merge(ra, rb))


def test_hll_incremental_append_and_json_persist(tmp_path):
    """Sketches merge per append (reference: ColumnStatistics::merge) and
    persist through catalog.json, so re-opened tables do not rescan; the
    JAX package computes the same registers from the same statements."""
    n, k = 3000, 257
    rows = ",".join(f"({i % k}, 's{i % 101}')" for i in range(n))
    regs = {}
    for name, pkg in PKGS.items():
        db = _mkdb(tmp_path, f"jsondb_{name}")
        s = _open(pkg, db)
        s.sql("create table t (a int not null, s varchar(8))")
        s.sql(f"insert into t values {rows}")
        st = s.catalog.get_table("t").storage
        st.ensure_hll()
        # append AFTER sketches exist: must merge, not recompute
        s.sql("insert into t values (999999, 'brand-new')")
        stats = s.catalog.get_table("t").storage.column_stats()
        assert abs(stats[0]["distinct"] - (k + 1)) <= 0.4 * (k + 1)
        assert abs(stats[1]["distinct"] - 102) <= 45
        s.close()

        got = _open(pkg, db).catalog.get_table("t").storage.hll_regs
        assert got is not None and len(got) == 2
        assert np.array_equal(got[0], st.hll_regs[0])
        regs[name] = got
    for a, b in zip(regs["port"], regs["ref"]):
        assert np.array_equal(a, b)


def test_string_hll_stable_across_dictionaries():
    """String sketches hash content, not per-batch dictionary codes, so
    appends with different dictionaries merge correctly."""
    from lingodb_tpu.storage.table import column_hashes as ref_column_hashes
    from lingodb_tpu_torch.sql.types import Type
    from lingodb_tpu_torch.storage.column import Column
    from lingodb_tpu_torch.storage.table import column_hashes
    from lingodb_tpu_torch.utils import hll

    t = Type.string(False)
    c1 = Column.from_values(t, ["b", "a", "c"])
    c2 = Column.from_values(t, ["c", "d"])  # different dictionary
    whole = Column.from_values(t, ["b", "a", "c", "c", "d"])
    merged = hll.merge(
        hll.registers_from_hashes(column_hashes(t, c1)),
        hll.registers_from_hashes(column_hashes(t, c2)))
    assert np.array_equal(
        merged, hll.registers_from_hashes(column_hashes(t, whole)))
    from lingodb_tpu.sql.types import Type as RefType
    from lingodb_tpu.storage.column import Column as RefColumn

    rt = RefType.string(False)
    assert np.array_equal(
        np.asarray(column_hashes(t, whole)),
        np.asarray(ref_column_hashes(
            rt, RefColumn.from_values(rt, ["b", "a", "c", "c", "d"]))))


def test_refformat_c_code_wrapping():
    from lingodb_tpu.sql.types import Type as RefType
    from lingodb_tpu.storage import refformat as ref_rf
    from lingodb_tpu_torch.sql.types import Type
    from lingodb_tpu_torch.storage.refformat import (join_function_code,
                                                     split_function_code)

    code = join_function_code(
        "c", "addOne", ["x"], [Type.int_(False)], Type.int_(False),
        " return x+1; ")
    assert code == "int64_t addOne(int64_t x) {  return x+1; }"
    assert code == ref_rf.join_function_code(
        "c", "addOne", ["x"], [RefType.int_(False)], RefType.int_(False),
        " return x+1; ")
    names, body = split_function_code("c", code)
    assert names == ["x"]
    assert "return x+1;" in body
    assert (names, body) == ref_rf.split_function_code("c", code)


def test_reference_catalog_handwritten_bytes(tmp_path):
    """Parse a db.lingodb built BYTE-BY-BYTE here from the reference
    serializer spec (Serialization.h wire format; Catalog.cpp:21-75;
    TableCatalogEntry.cpp:37-48; Column.cpp; Types.cpp:49-97;
    LingoDBTable.cpp:306-313) — independent of our own writer, so a
    self-consistent-but-wrong implementation cannot pass."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    def u16(v):
        return struct.pack("<H", v)

    def u64(v):
        return struct.pack("<Q", v)

    def s(b):
        b = b.encode() if isinstance(b, str) else b
        return u64(len(b)) + b

    def prop(pid, body):
        return u16(pid) + body + u16(pid)

    OBJ, END, PRESENT, NOTP = u16(0xFFFE), u16(0xFFFF), u16(0xFFFC), u16(0xFFFD)

    def int_type(width):  # Type{ INT, IntTypeInfo{signed,width} }
        info = OBJ + prop(42, b"\x00") + prop(0, b"\x01") + prop(1, u64(width)) + END
        return OBJ + prop(0, b"\x03") + prop(1, PRESENT + info) + END

    def string_type():
        info = OBJ + prop(42, b"\x02") + prop(0, s("")) + prop(1, NOTP) + END
        return OBJ + prop(0, b"\x0b") + prop(1, PRESENT + info) + END

    def column(name, type_bytes, nullable):
        return prop(4, OBJ + prop(1, s(name)) + prop(2, type_bytes)
                    + prop(3, b"\x01" if nullable else b"\x00") + END)

    # the arrow data file + sample + schema the impl section points at
    tbl = pa.table({"id": pa.array([7, 8, 9], pa.int64()),
                    "nm": pa.array(["x", "y", None], pa.string())})
    d = str(tmp_path / "refdb")
    os.makedirs(d)
    with ipc.RecordBatchFileWriter(os.path.join(d, "tt.arrow"), tbl.schema) as w:
        w.write_table(tbl)
    buf = io.BytesIO()
    with ipc.RecordBatchStreamWriter(buf, tbl.schema) as w:
        w.write_table(tbl)
    sample_ipc = buf.getvalue()
    schema_ipc = tbl.schema.serialize().to_pybytes()

    hll_regs = b"".join(prop(i, bytes([1])) for i in range(64))
    stats_present = OBJ + prop(1, PRESENT + OBJ + hll_regs + END) + END
    stats_absent = OBJ + prop(1, NOTP) + END
    impl = PRESENT + OBJ + prop(1, s("tt.arrow")) \
        + prop(2, OBJ + prop(1, s(sample_ipc)) + END) \
        + prop(3, s(schema_ipc)) \
        + prop(4, u64(2) + s("id") + stats_present + s("nm") + stats_absent) \
        + prop(5, u64(3)) + END
    entry = PRESENT + OBJ + prop(1, b"\x01") \
        + prop(2, s("tt")) + prop(3, u64(2)) \
        + column("id", int_type(64), False) + column("nm", string_type(), True) \
        + prop(8, u64(1) + s("id")) + prop(9, u64(0)) + prop(10, impl) + END
    catalog = prop(0, OBJ + prop(0, u64(3))
                   + prop(1, u64(1) + s("tt") + entry) + END)
    with open(os.path.join(d, "db.lingodb"), "wb") as f:
        f.write(catalog)

    s2 = ldb.connect_to_db(d, device="cpu")
    assert s2.catalog.ref_format
    e = s2.catalog.get_table("tt")
    assert e.primary_key == ["id"]
    r = s2.sql("select id, nm from tt order by id").format_rows()
    assert r == [["7", "x"], ["8", "y"], ["9", "NULL"]]
    assert r == ref_ldb.connect_to_db(d).sql(
        "select id, nm from tt order by id").format_rows()


# ------------------------------------------------ across the two packages
@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_export_opens_in_the_other_package(tmp_path, src, dst):
    """A directory that one package exports opens in the other with the
    exporting session's rows, its primary key and its index."""
    s, d = _exported(tmp_path, PKGS[src], TYPES_SQL, src)
    other = _open(PKGS[dst], d)
    assert other.catalog.ref_format
    for q in TYPES_QUERIES:
        want = s.sql(q).format_rows()
        assert want and other.sql(q).format_rows() == want
    e = other.catalog.get_table("d")
    assert (e.primary_key, e.index_on(["id"])) == (["id"], "d_id")


def test_exports_are_byte_equal(tmp_path):
    """The same statements export to the same bytes from both packages:
    the catalog (db.lingodb) and every table's Arrow file."""
    dirs = {name: _exported(tmp_path, pkg, TYPES_SQL, name)[1]
            for name, pkg in PKGS.items()}
    for f in ("db.lingodb", "t.arrow", "d.arrow"):
        a, b = (open(os.path.join(dirs[n], f), "rb").read()
                for n in ("ref", "port"))
        assert a == b, f
