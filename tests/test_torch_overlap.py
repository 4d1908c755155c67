"""The port's counterpart of tests/test_overlap.py (pipelined statements
(sql_many, prepare / execute_prepared)): the same cases on the port's
sessions (device="cpu"), asserting the values the reference file asserts.
What the reference file says of its subject:

Pipelined multi-query execution: sql_many overlaps the next query's
frontend/optimizer/H2D prefetch with the current query's execution and
produces identical results (reference: compilation inside scheduler tasks,
src/execution/Execution.cpp:294-325).
"""

import os
import sqlite3

import pytest

QDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "queries", "tpch")


@pytest.fixture(scope="module")
def env():
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import tpchgen

    s = ldb.create_in_memory(device="cpu")
    tables = tpchgen.load_into(s, sf=0.005)
    conn = sqlite3.connect(":memory:")
    tpchgen.to_sqlite(conn, tables)
    return s, conn


def test_sql_many_overlap_matches_sequential(env):
    from lingodb_tpu_torch.tools import sqlite_oracle as so

    s, conn = env
    qs = [open(os.path.join(QDIR, f"{q}.sql")).read() for q in (1, 3, 6, 12, 14)]
    seq = [so.our_rows(r) for r in s.sql_many(qs, overlap=False)]
    ove = [so.our_rows(r) for r in s.sql_many(qs, overlap=True)]
    assert seq == ove
    for q, rows in zip((1, 3, 6, 12, 14), seq):
        sql = open(os.path.join(QDIR, f"{q}.sql")).read()
        ok, msg = so.rows_equal(rows, so.run_sqlite(conn, sql), ordered=True)
        assert ok, f"Q{q}: {msg}"


def test_prepare_execute_split(env):
    import lingodb_tpu as ref_ldb
    from lingodb_tpu.tools import tpchgen as ref_tpchgen

    s, _ = env
    sql = "select count(*) c from lineitem where l_quantity > 10"
    pq = s.prepare(sql)
    assert pq.plan is not None
    r1 = s.execute_prepared(pq).format_rows()
    r2 = s.sql(sql).format_rows()
    assert r1 == r2
    # the reference file computes its expected rows at run time: the
    # reference's session on the same data
    r = ref_ldb.create_in_memory()
    ref_tpchgen.load_into(r, sf=0.005)
    assert r1 == r.sql(sql).format_rows()


def test_sql_many_mixed_statements(env):
    import lingodb_tpu_torch as ldb

    s2 = ldb.create_in_memory(device="cpu")
    out = s2.sql_many([
        "create table t(a int)",
        "insert into t values (1),(2),(3)",
        "select sum(a) s from t",
    ], overlap=True)
    assert out[-1].format_rows() == [["6"]]

