"""The port's Session.prepare / execute_prepared / sql_many held against the
JAX package: sql_many with overlap on and off (the next query's parse, bind,
optimize and uploads on a worker thread while the current one executes)
equals sequential Session.sql and the JAX package's sql_many, on TPC-H at sf
0.005 with every table on the tensor tier, and on a mix of DDL, DML and
SELECT statements (as in tests/test_overlap.py).
"""

import pytest

import lingodb_tpu as ref_ldb
from lingodb_tpu.tools import tpchgen as ref_tpchgen

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import carry, tpchgen

from test_torch_engine import _extract

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

QUERIES = ["1", "3", "6", "12", "14", "13", "9"]


@pytest.fixture(scope="module")
def sessions():
    rs = ref_ldb.create_in_memory()
    ref_tables = ref_tpchgen.load_into(rs, sf=0.005, seed=19920601)
    ps = ldb.create_in_memory(device="cpu")
    tpchgen.install(ps, carry.tables_from_numpy(_extract(ref_tables)))
    qs = [open(f"queries/tpch/{q}.sql").read() for q in QUERIES]
    want = [r.format_rows() for r in rs.sql_many(qs, overlap=True)]
    return rs, ps, qs, want


@pytest.mark.parametrize("overlap", [False, True])
def test_sql_many_equals_reference(sessions, overlap, monkeypatch):
    _rs, ps, qs, want = sessions
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    ps._device_cache.clear()
    got = [r.format_rows() for r in ps.sql_many(qs, overlap=overlap)]
    assert got == want
    assert got == [ps.sql(q).format_rows() for q in qs]


def test_prepare_execute_split(sessions):
    rs, ps, _qs, _want = sessions
    q = "select count(*) c from lineitem where l_quantity > 10"
    pq = ps.prepare(q)
    assert pq.plan is not None
    assert ps.execute_prepared(pq).format_rows() == rs.sql(q).format_rows()


def test_sql_many_mixed_statements():
    stmts = [
        "create table t(a int)",
        "insert into t values (1),(2),(3)",
        "select sum(a) s from t",
        "insert into t values (4)",
        "select count(*), sum(a) from t",
        "create table u(b int)",
        "insert into u values (10); select * from t",
        "select * from u",
        "select sum(a) + 1 from t",
    ]
    want = [None if r is None else r.format_rows()
            for r in ref_ldb.create_in_memory().sql_many(stmts, overlap=True)]
    for overlap in (True, False):
        got = [None if r is None else r.format_rows()
               for r in ldb.create_in_memory(device="cpu").sql_many(
                   stmts, overlap=overlap)]
        assert got == want
    assert want[-1] == [["11"]]
