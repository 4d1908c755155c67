"""The port's counterpart of tests/test_cse.py (shared-subtree elimination
(Tmp)): the same cases on the port's sessions (device="cpu"), asserting the
values the reference file asserts. What the reference file says of its
subject:

Shared-subtree elimination (Tmp) tests.

A CTE or view referenced more than once must materialize ONCE and be reused
(reference: CommonSubtreeElimination.cpp + IntroduceTmp, RelAlg/Passes.cpp:
46-47; relalg.tmp RelAlgOps.td:499).
"""

import pytest


@pytest.fixture()
def session():
    import lingodb_tpu_torch as ldb

    return ldb.create_in_memory(device="cpu")


def _setup(session):
    session.sql_stmt("create table t(a int, b int)")
    session.sql_stmt("insert into t values (1,10),(2,20),(3,30),(2,25),(1,5)")


def _optimized(session, q):
    from lingodb_tpu_torch.opt.optimizer import optimize
    from lingodb_tpu_torch.sql.binder import Binder
    from lingodb_tpu_torch.sql.parser import parse_sql

    return optimize(Binder(session.catalog).bind_query(parse_sql(q)[-1]),
                    session.catalog)


def _tmp_stats(plan):
    from lingodb_tpu_torch.plan import logical as L

    tmps = [n for n in L.walk_plan(plan) if isinstance(n, L.Tmp)]
    holders = {id(t.holder) for t in tmps}
    return tmps, holders


def test_cte_used_twice_shares_one_holder(session):
    _setup(session)
    q = ("with agg as (select a, sum(b) as sb from t group by a) "
         "select x.a, x.sb + y.sb from agg x, agg y where x.a = y.a "
         "order by x.a")
    plan = _optimized(session, q)
    tmps, holders = _tmp_stats(plan)
    assert len(tmps) == 2 and len(holders) == 1
    rows = session.sql(q).to_pylist()
    assert rows == [[1, 30], [2, 90], [3, 60]]


def test_shared_subtree_executes_once(session):
    """The shared aggregate runs ONE time (the r1 gap: each CTE reference
    re-executed its clone)."""
    from lingodb_tpu_torch.runtime.executor import Executor

    _setup(session)
    q = ("with agg as (select a, sum(b) as sb from t group by a) "
         "select x.a from agg x, agg y where x.a = y.a order by x.a")
    plan = _optimized(session, q)
    calls = []
    orig = Executor._run_aggregate
    try:
        def counting(self, op):
            calls.append(op)
            return orig(self, op)

        Executor._run_aggregate = counting
        session.executor.execute(plan)
    finally:
        Executor._run_aggregate = orig
    assert len(calls) == 1


def test_view_used_twice_shares(session):
    """Q15 pattern: a view joined against its own aggregate scans once."""
    _setup(session)
    session.sql_stmt("create view v as select a, sum(b) as total from t group by a")
    q = ("select v.a, v.total from v "
         "where v.total = (select max(total) from v) order by v.a")
    plan = _optimized(session, q)
    tmps, holders = _tmp_stats(plan)
    assert len(holders) == 1 and len(tmps) == 2
    rows = session.sql(q).to_pylist()
    assert rows == [[2, 45]]


def test_correlated_duplicates_only_match_same_outer(session):
    """Subtrees referencing DIFFERENT outer columns must not merge."""
    _setup(session)
    # two scalar subqueries referencing different outer predicates: results
    # must stay independent (regression guard against over-merging)
    q = ("select (select sum(b) from t where a = 1), "
         "(select sum(b) from t where a = 2)")
    rows = session.sql(q).to_pylist()
    assert rows == [[15, 45]]


def test_tmp_plan_json_roundtrip(session):
    _setup(session)
    q = ("with agg as (select a, sum(b) as sb from t group by a) "
         "select x.a from agg x, agg y where x.a = y.a order by x.a")
    from lingodb_tpu_torch.plan.serial import plan_from_json, plan_to_json

    plan = _optimized(session, q)
    p2 = plan_from_json(plan_to_json(plan))
    tmps, holders = _tmp_stats(p2)
    assert len(tmps) == 2 and len(holders) == 1
    rows = session.executor.execute(p2).to_pylist()
    assert rows == [[1], [2], [3]]


def test_repeated_execution_fresh_results(session):
    """Tmp result caching is per-execution: data changes must be visible."""
    _setup(session)
    q = ("with agg as (select sum(b) as sb from t) "
         "select x.sb from agg x, agg y where x.sb = y.sb")
    assert session.sql(q).to_pylist() == [[90]]
    session.sql_stmt("insert into t values (9, 10)")
    assert session.sql(q).to_pylist() == [[100]]

