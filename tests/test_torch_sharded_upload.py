"""Base tables held sharded from their upload on a mesh (lingodb_tpu_torch/
session.py _LazyDeviceTable, runtime/device.shard_column, the executor's
scan, Select, Map, gathers and fused aggregate over a mesh), held against
the JAX package's on the CPU.

The port's mesh is 8 x "cpu", set as device._MESH; the reference's the 8
virtual CPU devices of tests/conftest.py. Inputs are made from numpy seeds.
Module level: the layout of an uploaded table (padded row count, pad mask,
every column's shards, wide decimals kept on the host) and a scan's
selection vector, shard for shard against the reference's global arrays,
for a row count the axis divides and one it does not. Slice level: TPC-H
q1, q6, q3 and q18 on the mesh against the one-card session (sf 0.01) and
the reference's meshed session (sf 0.005, where the reference compiles
its sharded programs in about 30 s on this CPU); the 14 SQL checks of the
JAX package's tests/test_shuffle.py over tables held on the mesh against
the one-card session and sqlite3 (tests/test_torch_shuffle.py holds 9 of
them against the reference too, on the same layout); the fused
aggregate's per-position programs and their graphs; the gather counter.
Rows are compared exactly, floats within the sqlite oracle's relative
1e-9.
"""

import sqlite3
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import lingodb_tpu as ref_ldb
from lingodb_tpu.catalog.catalog import TableEntry as RefEntry
from lingodb_tpu.runtime import device as ref_dv
from lingodb_tpu.tools import tpchgen as ref_gen
from lingodb_tpu.utils import settings as ref_settings

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.parallel import mesh as msh
from lingodb_tpu_torch.parallel import shuffle as sh
from lingodb_tpu_torch.plan import logical as L
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_oracle as so
from lingodb_tpu_torch.tools import tpchgen
from lingodb_tpu_torch.utils import compilestats, settings

import test_torch_shuffle as ts

N = 8
SEED = 19920601
QUERIES = (1, 6, 3, 18)


@pytest.fixture(scope="module")
def meshes():
    """(port mesh, reference mesh) of 8 positions each, with SMALL_ROWS 64
    and system.shuffle_min_rows 32 in both engines; restored after."""
    ref_settings.PARALLELISM.set("")
    old_ref = ref_dv._MESH, ref_dv._MESH_INIT, ref_dv.SMALL_ROWS
    old = dv._MESH, dv._MESH_INIT, dv.SMALL_ROWS
    ref_dv._MESH, ref_dv._MESH_INIT = None, False
    ref_mesh = ref_dv.get_mesh()
    assert ref_mesh is not None and ref_mesh.shape["dp"] == N
    dv.SMALL_ROWS = ref_dv.SMALL_ROWS = 64
    settings.set_setting("system.shuffle_min_rows", 32)
    ref_settings.set_setting("system.shuffle_min_rows", 32)
    yield msh.Mesh(["cpu"] * N), ref_mesh
    ref_dv._MESH, ref_dv._MESH_INIT, ref_dv.SMALL_ROWS = old_ref
    dv._MESH, dv._MESH_INIT, dv.SMALL_ROWS = old
    settings.SHUFFLE_MIN_ROWS.reset()
    ref_settings.SHUFFLE_MIN_ROWS.reset()


class _on_mesh:
    """Run the port's sessions on `mesh` (None: one card) inside."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.old = dv._MESH, dv._MESH_INIT
        dv._MESH, dv._MESH_INIT = self.mesh, True

    def __exit__(self, *exc):
        dv._MESH, dv._MESH_INIT = self.old


def _ref_shards(x) -> np.ndarray:
    return np.asarray(x).reshape(N, -1)


def _port_shards(x) -> np.ndarray:
    assert isinstance(x, msh.Sharded) and len(x.shards) == N
    return np.stack([s.numpy() for s in x.shards])


def _table(rows: int):
    rng = np.random.default_rng(rows)
    vals = rng.integers(-1000, 1000, rows)
    nullable = [None if i % 7 == 0 else int(v) for i, v in enumerate(vals)]
    return pa.table({
        "k": pa.array(np.arange(rows, dtype=np.int64)),
        "i": pa.array(rng.integers(-100, 100, rows).astype(np.int32)),
        "f": pa.array(rng.standard_normal(rows)),
        "b": pa.array(rng.random(rows) < 0.3),
        "s": pa.array(rng.choice(["ab", "cd", "ef", "gh"], rows)),
        "n": pa.array(nullable, type=pa.int64()),
        "d": pa.array([Decimal(10) ** 20 + Decimal(i) if i % 5 else None
                       for i in range(rows)], type=pa.decimal128(38, 0)),
    })


# ------------------------------------------------------------ module level
@pytest.mark.parametrize("rows", [8000, 8003])
def test_upload_layout_equals_the_reference(meshes, rows):
    """__num_rows__, __pad_mask__ (None when the axis divides the count)
    and every column's data and validity shards, against the reference;
    the wide decimals stay host arrays padded with zeros, validity padded
    false."""
    pm, _rm = meshes
    t = _table(rows)
    s = ldb.create_in_memory(device="cpu")
    rs = ref_ldb.create_in_memory()
    s.add_table("t", t)
    rs.add_table("t", t)
    with _on_mesh(pm):
        dev = s.device_table("t")
        got = {c: dev[c] for c in ["__num_rows__", "__pad_mask__"] + t.column_names}
    ref = rs.device_table("t")
    total = rows + (-rows) % N
    assert got["__num_rows__"] == ref["__num_rows__"] == total
    pad = got["__pad_mask__"]
    if rows % N == 0:
        assert pad is None and ref["__pad_mask__"] is None
    else:
        assert np.array_equal(_port_shards(pad),
                              _ref_shards(ref["__pad_mask__"]))
        assert int(_port_shards(pad).sum()) == rows
    for name in t.column_names:
        c, r = got[name], ref[name]
        if name == "d":
            assert isinstance(c.data, np.ndarray) and c.data.dtype == object
            assert c.data.shape == (total,)
            assert list(c.data) == list(np.asarray(r.data))
            assert np.array_equal(c.valid, np.asarray(r.valid))
            assert not c.valid[rows:].any()
            continue
        a, b = _port_shards(c.data), _ref_shards(r.data)
        assert a.shape == b.shape == (N, total // N)
        assert np.array_equal(a.view(np.int64) if a.dtype == np.float64 else a,
                              b.view(np.int64) if b.dtype == np.float64 else b)
        assert (c.valid is None) == (r.valid is None)
        if c.valid is not None:
            assert np.array_equal(_port_shards(c.valid), _ref_shards(r.valid))
    # off the mesh the table is held whole, its shards dropped
    dev1 = s.device_table("t")
    assert dev1["__num_rows__"] == rows and dev1["__pad_mask__"] is None
    assert isinstance(dev1["k"].data, torch.Tensor)
    assert not any(isinstance(c.data, msh.Sharded)
                   for c in dev1._cols.values())


@pytest.mark.parametrize("rows", [8000, 8003])
def test_scan_selection_vector_equals_the_reference(meshes, rows):
    """The scan's restrictions evaluated shard by shard and anded with the
    pad mask: the lazy selection vector, against the reference's."""
    pm, _rm = meshes
    t = _table(rows)
    q = "select k, f, s from t where i > 10 and s <> 'cd'"
    s = ldb.create_in_memory(device="cpu")
    rs = ref_ldb.create_in_memory()
    s.add_table("t", t)
    rs.add_table("t", t)
    scan = next(op for op in L.walk_plan(s.prepare(q).plan)
                if isinstance(op, L.Scan))
    ref_scan = next(op for op in _ref_walk(rs.prepare(q).plan)
                    if type(op).__name__ == "Scan")
    with _on_mesh(pm):
        vt = s.executor.run_sharded(scan)
    ref_vt = rs.executor.run(ref_scan)
    assert dv.is_sharded(vt) and vt.num_rows == ref_vt.num_rows
    assert np.array_equal(_port_shards(vt.row_valid),
                          _ref_shards(ref_vt.row_valid))
    for cid, c in vt.cols.items():
        assert np.array_equal(_port_shards(c.data),
                              _ref_shards(ref_vt.cols[cid].data))


def _ref_walk(op):
    yield op
    for c in op.children():
        yield from _ref_walk(c)


# ------------------------------------------------------------- slice level
def _ref_install(session, tables):
    for name, storage in tables.items():
        key = ref_gen.PRIMARY_KEYS.get(name, [])
        session.catalog.tables[name] = RefEntry(
            name, storage.column_names, storage.column_types, key, storage)


@pytest.fixture(scope="module")
def tpch(meshes):
    """(meshed session, one-card session) over the same sf 0.01 tables."""
    tables = tpchgen.generate(0.01, SEED)
    meshed = ldb.create_in_memory(device="cpu")
    one = ldb.create_in_memory(device="cpu")
    tpchgen.install(meshed, tables)
    tpchgen.install(one, tables)
    return meshed, one


def _sql(q) -> str:
    return open(f"{ts.__file__.rsplit('/tests/', 1)[0]}/queries/tpch/{q}.sql").read()


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_on_tables_held_on_the_mesh(meshes, tpch, q):
    """Rows equal the one-card session's; the big tables are held sharded
    (lineitem, orders, customer, part's columns are Sharded) and no base
    column is whole on the session's device."""
    pm, _rm = meshes
    meshed, one = tpch
    sql = _sql(q)
    with _on_mesh(None):
        want = one.sql(sql)
    before = dict(sh.STATS)
    with _on_mesh(pm):
        got = meshed.sql(sql)
    moved = {k: sh.STATS[k] - before[k] for k in sh.STATS}
    assert got.format_rows() == want.format_rows()
    assert want.num_rows > 0
    assert moved["gathers"] == 0, moved  # no operator asked for a whole table
    held = {}
    for name, (_version, dev) in meshed._device_cache.items():
        rows = meshed.catalog.get_table(name).storage.num_rows
        assert dev._layout is pm, name  # never whole on a mesh
        for key, c in dev._cols.items():
            data = c if isinstance(c, msh.Sharded) else c.data
            if isinstance(data, np.ndarray):  # a wide decimal: host only
                continue
            assert isinstance(data, msh.Sharded), (name, key, type(data))
            assert data.local_len == -(-rows // N)
            assert all(int(x.shape[0]) == data.local_len for x in data.shards)
            held[name] = held.get(name, 0) + 1
    assert held.get("lineitem"), held


def test_tpch_against_the_reference_mesh(meshes):
    """q1, q6, q3 and q18 at sf 0.005 over tables held on both meshes: the
    port's rows equal the reference's."""
    pm, _rm = meshes
    tables = tpchgen.generate(0.005, SEED)
    s = ldb.create_in_memory(device="cpu")
    tpchgen.install(s, tables)
    rs = ref_ldb.create_in_memory()
    _ref_install(rs, ref_gen.generate(0.005, SEED))
    for q in QUERIES:
        with _on_mesh(pm):
            got = s.sql(_sql(q))
        ref = rs.sql(_sql(q))
        assert got.format_rows() == ref.format_rows(), q


def test_fused_aggregate_runs_on_every_position(meshes, tpch):
    """q1 (dense string keys) and q6 (a global aggregate) run the fused
    program position by position, each position its own graph (captured
    on the first run, replayed on the second), the lanes reduced across
    positions; no exchange, no gather."""
    pm, _rm = meshes
    meshed, one = tpch
    for q in (1, 6):
        sql = _sql(q)
        with _on_mesh(None):
            want = one.sql(sql)
        with _on_mesh(pm):
            meshed.stage_cache.clear()
            meshed.exestore.clear()
            for run in range(2):
                c0 = compilestats.snapshot()
                before = dict(sh.STATS)
                got = meshed.sql(sql)
                d = compilestats.delta(c0)
                assert got.format_rows() == want.format_rows()
                assert not any(sh.STATS[k] - before[k] for k in sh.STATS)
                assert (d["captures"], d["replays"]) == \
                    ((N, 0) if run == 0 else (0, N)), (q, run, d)
        keys = [k for k in meshed.exestore.entries if k[1] == "mesh"]
        assert len(keys) == N


@pytest.fixture(scope="module")
def checks(meshes):
    """The tables of the 14 shuffle checks (tests/test_torch_shuffle.py),
    with SMALL_ROWS 16 as there: held on the mesh at upload."""
    old = dv.SMALL_ROWS
    dv.SMALL_ROWS = 16
    tables = ts._tables()
    s = ldb.create_in_memory(device="cpu")
    con = sqlite3.connect(":memory:")
    for name, t in tables.items():
        s.add_table(name, t)
        if name == "widep":
            continue
        cols = t.column_names
        con.execute(f"create table {name}({', '.join(cols)})")
        con.executemany(
            f"insert into {name} values ({', '.join('?' * len(cols))})",
            list(zip(*[t.column(c).to_pylist() for c in cols])))
    yield s, con
    dv.SMALL_ROWS = old


@pytest.mark.parametrize("name,q,ordered,stats,_against_ref", ts.SQL_CHECKS,
                         ids=[c[0] for c in ts.SQL_CHECKS])
def test_shuffle_checks_over_tables_held_on_the_mesh(meshes, checks, name, q,
                                                     ordered, stats,
                                                     _against_ref):
    pm, _rm = meshes
    s, con = checks
    with _on_mesh(None):
        one = s.sql(q)
    before = dict(sh.STATS)
    with _on_mesh(pm):
        res = s.sql(q)
        scans = [op for op in L.walk_plan(s.prepare(q).plan)
                 if isinstance(op, L.Scan) and op.cols]
        assert scans and all(dv.is_sharded(s.executor.run_sharded(op))
                             for op in scans)
    moved = {k: sh.STATS[k] - before[k] for k in sh.STATS}
    ok, msg = so.rows_equal(so.our_rows(res), con.execute(q).fetchall(),
                            ordered=ordered)
    assert ok, f"{name} against sqlite3: {msg}"
    assert (res.format_rows() == one.format_rows() if ordered
            else sorted(res.format_rows()) == sorted(one.format_rows()))
    for k, v in stats.items():
        assert moved[k] >= v, f"{k}: {moved[k]} < {v} for {name}"


@pytest.mark.parametrize("q,gathers", [
    # a window function: no sharded form; one gather of the filtered scan
    ("select k, rank() over (order by v) from skewed where v > 5", 1),
    # a TopK over a filtered scan (its fused form declines on a mesh)
    ("select okey, qty from lines where qty > 45 order by qty desc, okey "
     "limit 7", 1),
    # the sharded join and grouping take both sides as they are held
    ("select l.okey, count(*) from lines l, orders o where l.okey = o.okey "
     "group by l.okey", 0),
    # the fused aggregate over lines, position by position: its dimension
    # join's build side (orders) is gathered once, whole
    ("select count(*) from lines l, orders o where l.okey = o.okey", 1),
])
def test_gathers_at_operators_inputs(meshes, checks, q, gathers):
    """shuffle.STATS["gathers"] counts the tables that leave the mesh
    whole for an operator without a sharded form: one for its input."""
    pm, _rm = meshes
    s, con = checks
    with _on_mesh(None):
        want = s.sql(q)
    before = sh.STATS["gathers"]
    with _on_mesh(pm):
        got = s.sql(q)
    assert sh.STATS["gathers"] - before == gathers
    assert sorted(got.format_rows()) == sorted(want.format_rows())


def test_a_missed_gather_raises(meshes, checks, monkeypatch):
    """An operator that would compute on a table held on the mesh without
    its gather raises instead (the dispatch's check)."""
    from lingodb_tpu_torch.runtime.executor import ExecError, Executor

    pm, _rm = meshes
    s, _con = checks
    monkeypatch.setattr(Executor, "_run_limit",
                        lambda self, op: self.run_sharded(op.child))
    with _on_mesh(pm), pytest.raises(ExecError, match="Sharded"):
        s.sql("select okey from lines limit 3")


# ---------------------------- the general-mode fused aggregate on a mesh
# Where the reference keeps its fused program on a mesh (every key a
# string or a bool, or a subtree below system.shuffle_min_rows) and the
# program takes the general (sorted) mode, the port gathers the base
# columns once onto the session's device and runs the one-card program
# there. At sf 0.01 the dense limit is lowered to 64 so that customer's
# and supplier's names (1,500 and 100) take the general mode, as
# customer's 150,000 names do at SF1; system.shuffle_min_rows is raised to
# 1,000 so that supplier (100 rows, held sharded at SMALL_ROWS 64) is below
# it, as its 10,000 rows are below 65,536 at SF1.
# Each case: its name, its statement (None: TPC-H q21), and the base the
# gather moves: the table and the scan's own restriction, under which only
# its surviving rows are gathered.
GENERAL = [
    ("names", "select c_name, count(*), sum(c_acctbal) from customer, nation "
              "where c_nationkey = n_nationkey and n_name <> 'CHINA' "
              "group by c_name", ("customer", "")),
    ("acctbal", "select s_acctbal, count(*) from supplier "
                "group by s_acctbal", ("supplier", "")),
    ("q21", None, ("lineitem", "where l_receiptdate > l_commitdate")),
]


@pytest.fixture()
def general_mode(meshes, monkeypatch):
    from lingodb_tpu_torch.ops import groupby as gb

    monkeypatch.setattr(gb, "DENSE_DOMAIN_LIMIT", 64)
    settings.set_setting("system.shuffle_min_rows", 1000)
    yield
    settings.set_setting("system.shuffle_min_rows", 32)


def _forget(session):
    session.stage_cache.clear()
    for store in session.graph_stores():
        store.clear()


@pytest.mark.parametrize("name,sql,base", GENERAL,
                         ids=[g[0] for g in GENERAL])
def test_general_mode_runs_the_gathered_program(meshes, tpch, general_mode,
                                                monkeypatch, name, sql, base):
    """The first run tries a position's program, finds the general mode,
    marks the plan and runs the one-card program over the scan's surviving
    rows gathered once; the second goes straight there: one gather (the
    base: the dimension builds are kept), no capture, one replay. Rows
    equal the one-card session's."""
    from lingodb_tpu_torch.runtime.executor import Executor

    pm, _rm = meshes
    meshed, one = tpch
    sql = sql or _sql(21)
    with _on_mesh(None):
        want = one.sql(sql).format_rows()
    gathered = []
    orig = Executor._materialized_base

    def spy(self, cur):
        got = orig(self, cur)
        gathered.append((cur.table, got[1]))
        return got

    monkeypatch.setattr(Executor, "_materialized_base", spy)
    runs = []
    with _on_mesh(pm):
        _forget(meshed)
        for _run in range(2):
            c0, g0 = compilestats.snapshot(), sh.STATS["gathers"]
            got = meshed.sql(sql).format_rows()
            runs.append((compilestats.delta(c0), sh.STATS["gathers"] - g0))
            assert sorted(got) == sorted(want)
    assert any(k[0] == "fused_mesh_general" for k in meshed.stage_cache
               if isinstance(k, tuple))
    table, where = base
    with _on_mesh(None):
        rows = int(one.sql(f"select count(*) from {table} {where}")
                   .format_rows()[0][0])
    assert gathered and all(g == (table, rows) for g in gathered)
    (d1, g1), (d2, g2) = runs
    assert g1 >= 1 and d1["captures"] >= 1
    assert g2 == 1 and (d2["captures"], d2["replays"]) == (0, 1), runs


def test_general_mode_equals_the_reference_mesh(meshes, tpch, general_mode):
    """The statements of the gathered route against the reference's meshed
    session over the same sf 0.01 tables (its own dense limit: its rows do
    not depend on the mode)."""
    pm, _rm = meshes
    meshed, _one = tpch
    rs = ref_ldb.create_in_memory()
    _ref_install(rs, ref_gen.generate(0.01, SEED))
    ref_settings.set_setting("system.shuffle_min_rows", 1000)
    try:
        for _name, sql, _base in GENERAL:
            sql = sql or _sql(21)
            with _on_mesh(pm):
                got = meshed.sql(sql).format_rows()
            assert sorted(got) == sorted(rs.sql(sql).format_rows()), _name
    finally:
        ref_settings.set_setting("system.shuffle_min_rows", 32)


def test_non_dense_keys_over_a_big_subtree_stay_sharded(meshes, tpch):
    """Where the reference declines its fused program on a mesh (a key that
    is not a string or a bool over a subtree of at least
    system.shuffle_min_rows rows), the port declines too: the sharded
    aggregate runs, nothing is gathered, no plan is marked."""
    pm, _rm = meshes
    meshed, one = tpch
    sql = "select o_custkey, count(*) from orders group by o_custkey"
    with _on_mesh(None):
        want = one.sql(sql).format_rows()
    before = dict(sh.STATS)
    with _on_mesh(pm):
        _forget(meshed)
        got = meshed.sql(sql).format_rows()
    moved = {k: sh.STATS[k] - before[k] for k in sh.STATS}
    assert sorted(got) == sorted(want)
    assert moved["groupbys"] >= 1 and moved["gathers"] == 0, moved
    assert not any(k[0] == "fused_mesh_general" for k in meshed.stage_cache
                   if isinstance(k, tuple))


def test_names_over_orders_group_below_the_join(meshes, tpch, general_mode):
    """c_name's sum of o_totalprice over orders and customer: the
    optimizer's eager aggregation groups orders by o_custkey below the join
    (a sharded aggregate: an integer key over a big subtree), so the fused
    aggregate's base is that grouping's result, not a table held on the
    mesh, and it runs the one-card program over it: no plan is marked.
    Rows equal the one-card session's."""
    pm, _rm = meshes
    meshed, one = tpch
    sql = ("select c_name, sum(o_totalprice) from orders, customer "
           "where o_custkey = c_custkey group by c_name")
    plan = meshed.prepare(sql).plan
    top = next(op for op in L.walk_plan(plan) if isinstance(op, L.Aggregate))
    assert any(isinstance(op, L.Aggregate)
               for op in L.walk_plan(top.child))
    with _on_mesh(None):
        want = one.sql(sql).format_rows()
    with _on_mesh(pm):
        _forget(meshed)
        got = meshed.sql(sql).format_rows()
    assert sorted(got) == sorted(want)
    assert not any(k[0] == "fused_mesh_general" for k in meshed.stage_cache
                   if isinstance(k, tuple))


def test_take_keeps_a_wide_columns_validity_on_the_host():
    """VTable.take with a device index: a wide-decimal (host object)
    column's data and validity both gathered on the host. A validity left
    on the device beside host data broke the next expression (q17 on the
    mesh: numpy & tensor in _eval_and)."""
    from lingodb_tpu_torch.runtime.vtable import SCol, VTable
    from lingodb_tpu_torch.sql.types import K, Type

    wide = Type(K.DECIMAL, nullable=True, p=36, s=22)
    data = np.array([10 ** 30 + i for i in range(5)], dtype=object)
    valid = np.array([True, False, True, True, False])
    vt = VTable({1: SCol(wide, data, valid),
                 2: SCol(Type(K.INT), torch.arange(5, dtype=torch.int32))}, 5)
    out = vt.take(torch.tensor([4, 0, 2]), 3)
    c = out.col(1)
    assert isinstance(c.valid, np.ndarray)
    assert list(c.data) == [data[4], data[0], data[2]]
    assert list(c.valid) == [False, True, True]
    assert out.col(2).data.tolist() == [4, 0, 2]


@pytest.mark.parametrize("min_rows", [32, 1000])
def test_q17_on_the_mesh(meshes, tpch, min_rows):
    """q17's scalar subquery yields a wide decimal (0.2 * avg) that the
    sharded single join carries: rows equal the one-card session's."""
    pm, _rm = meshes
    meshed, one = tpch
    sql = _sql(17)
    settings.set_setting("system.shuffle_min_rows", min_rows)
    try:
        with _on_mesh(None):
            want = one.sql(sql).format_rows()
        with _on_mesh(pm):
            got = meshed.sql(sql).format_rows()
    finally:
        settings.set_setting("system.shuffle_min_rows", 32)
    assert got == want
