"""The port's counterpart of tests/test_window_frames.py (window-frame
conformance against sqlite3): the same cases on the port's sessions
(device="cpu"), asserting the values the reference file asserts. What the
reference file says of its subject:

Window-frame conformance vs the sqlite3 differential oracle.

Sweeps ROWS / RANGE / GROUPS frame specs (bounded, unbounded, following-only)
across aggregate and positional window functions, partitions, ASC/DESC order
and NULL order keys (reference: frame modeling in RelAlgOps.td:257-260,
lowering RelAlgToSubOp.cpp:2193, runtime SegmentTreeView.cpp). Includes the
exact silent-wrong-answer query (sum over ROWS BETWEEN 1 PRECEDING
AND CURRENT ROW).
"""

import sqlite3

import pytest

ROWS = [(1, 1, 10), (1, 2, 20), (1, 2, 25), (1, 3, None), (1, 5, 50),
        (2, 1, 5), (2, 4, None), (2, 4, 40), (2, 9, 90),
        (3, None, 7), (3, None, 8), (3, 2, 30)]

FRAMES = [
    "rows between 1 preceding and current row",
    "rows between 2 preceding and 1 following",
    "rows between current row and unbounded following",
    "rows between 1 following and 2 following",
    "rows between unbounded preceding and 1 preceding",
    "range between 1 preceding and 1 following",
    "range between current row and unbounded following",
    "range between 2 preceding and current row",
    "range between current row and 3 following",
    "groups between 1 preceding and 1 following",
    "groups between current row and current row",
]

FNS = ["sum(v)", "count(v)", "count(*)", "min(v)", "max(v)", "avg(v)",
       "first_value(v)", "last_value(v)", "nth_value(v, 2)"]

ORDERS = ["order by i nulls last", "order by i desc nulls first",
          "order by i nulls first", "order by i desc nulls last"]


@pytest.fixture(scope="module")
def oracle():
    con = sqlite3.connect(":memory:")
    con.execute("create table t(p int, i int, v int)")
    con.executemany("insert into t values (?,?,?)", ROWS)
    yield con
    con.close()


@pytest.fixture(scope="module")
def engine():
    import lingodb_tpu_torch as ldb

    s = ldb.create_in_memory(device="cpu")
    s.sql_stmt("create table t(p int, i int, v int)")
    vals = ",".join(
        "(%s,%s,%s)" % tuple("NULL" if x is None else x for x in r) for r in ROWS
    )
    s.sql_stmt("insert into t values " + vals)
    return s


def _norm(rows):
    return sorted(
        repr(tuple(float(x) if isinstance(x, (bool, int, float)) else x for x in r))
        for r in rows
    )


def test_round1_regression(engine):
    """The exact query that silently returned whole-partition sums in r1."""
    engine.sql_stmt("create table r(i int, v int)")
    engine.sql_stmt("insert into r values (1,10),(2,20),(3,30),(4,40)")
    q = ("select sum(v) over (order by i rows between 1 preceding and"
         " current row) from r order by i")
    got = [r[0] for r in engine.sql(q).to_pylist()]
    assert got == [10, 30, 50, 70]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("frame", FRAMES)
def test_frame_sweep(engine, oracle, order, frame):
    for fn in FNS:
        q = (f"select p, i, v, {fn} over (partition by p {order} {frame})"
             " from t order by p, i, v")
        ours = [tuple(r) for r in engine.sql(q).to_pylist()]
        theirs = [tuple(r) for r in oracle.execute(q).fetchall()]
        assert _norm(ours) == _norm(theirs), f"{fn} / {order} / {frame}"


def test_nth_value_default_frame(engine, oracle):
    q = ("select p, i, v, nth_value(v, 2) over (partition by p"
         " order by i nulls last) from t order by p, i, v")
    ours = [tuple(r) for r in engine.sql(q).to_pylist()]
    theirs = [tuple(r) for r in oracle.execute(q).fetchall()]
    assert _norm(ours) == _norm(theirs)


def test_last_value_default_frame_peers(engine, oracle):
    """Default frame is RANGE ... CURRENT ROW: last_value must extend
    through the current row's full peer group (regression: r1 used pos)."""
    q = ("select p, i, v, last_value(v) over (partition by p"
         " order by i nulls last) from t order by p, i, v")
    ours = [tuple(r) for r in engine.sql(q).to_pylist()]
    theirs = [tuple(r) for r in oracle.execute(q).fetchall()]
    assert _norm(ours) == _norm(theirs)

