"""The port's Iterate / WITH RECURSIVE held against the JAX package.

The recursive queries of tests/test_iterate.py (ORACLE_QUERIES: counters, a
UNION fixpoint on a cyclic graph, reachability, an org chart, recursive CTEs
under joins) run through `lingodb_tpu` and through `lingodb_tpu_torch` on
device="cpu", the port with its tables on the host tier and on the tensor
tier, in DEBUG mode (which checks that no host array sits in a table of
tensors). Also: the UNION ALL cycle guard (max_iters) and a working table
that is empty after round 1.
"""

import pytest

import lingodb_tpu as ref_ldb
from lingodb_tpu.runtime.executor import ExecError as RefExecError

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.runtime.executor import ExecError
from lingodb_tpu_torch.utils.settings import EXECUTION_MODE

from test_iterate import ORACLE_QUERIES

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

SETUP = [
    "create table edges (src int not null, dst int not null)",
    "insert into edges values (0,1),(1,2),(2,4),(3,4),(4,1),(0,3)",
    "create table emp (id int, mgr int, name varchar(10))",
    "insert into emp values (1,null,'ceo'),(2,1,'vp1'),(3,1,'vp2'),"
    "(4,2,'m1'),(5,2,'m2'),(6,4,'e1'),(7,4,'e2'),(8,3,'e3')",
]
TIERS = [dv.SMALL_ROWS, 2]


@pytest.fixture(scope="module")
def sessions():
    rs = ref_ldb.create_in_memory()
    ps = ldb.create_in_memory(device="cpu")
    for stmt in SETUP:
        rs.sql_stmt(stmt)
        ps.sql_stmt(stmt)
    EXECUTION_MODE.set("DEBUG")
    yield rs, ps
    EXECUTION_MODE.set("DEFAULT")


def _both(sessions, q, monkeypatch):
    rs, ps = sessions
    want = rs.sql(q).format_rows()
    for small in TIERS:
        monkeypatch.setattr(dv, "SMALL_ROWS", small)
        ps._device_cache.clear()
        assert ps.sql(q).format_rows() == want, (small, q)
    return want


@pytest.mark.parametrize("q", range(len(ORACLE_QUERIES)))
def test_recursive_equals_reference(sessions, q, monkeypatch):
    assert _both(sessions, ORACLE_QUERIES[q], monkeypatch)


def test_union_all_cycle_guard(sessions):
    """UNION ALL over a cycle never reaches a fixpoint: both engines stop
    at max_iters with the same error."""
    rs, ps = sessions
    q = ("with recursive r(v) as (select 0 union all"
         " select edges.dst from r, edges where edges.src = r.v)"
         " select count(*) from r")
    for s, err in ((rs, RefExecError), (ps, ExecError)):
        s.sql_stmt("set max_recursion = 50")
        try:
            with pytest.raises(err, match="max_iters=50"):
                s.sql(q)
        finally:
            s.sql_stmt("set max_recursion = 10000")


@pytest.mark.parametrize("union", ["union", "union all"])
def test_working_table_empty_after_round_one(sessions, union, monkeypatch):
    """The step finds no rows in round 1: the result is the base alone."""
    q = (f"with recursive r(v) as (select 7 {union} select edges.dst from r, "
         f"edges where edges.src = r.v) select v from r order by v")
    assert _both(sessions, q, monkeypatch) == [["7"]]
    assert sessions[1].executor.last_iterate_rounds == 1
