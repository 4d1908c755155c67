"""Statements the JAX package answers wrongly, held against sqlite3 on both
storage tiers: lag / lead's default and their offsets 0 and NULL, ntile's
buckets and its argument 0 or NULL, substring's positions outside the
string and a negative length, replace with an empty search string, a NULL
literal as a constant argument of a string or date function, concat()
with NULL arguments, nth_value's position 0 or NULL, and an exact wide
decimal (a division's quotient) beside a column on the tensor tier.

LingoDB parses with PostgreSQL's grammar, so PostgreSQL's semantics are
the target; sqlite3 is the oracle where it agrees with PostgreSQL. Where it
does not (a substring's start below 1, a NULL argument sqlite3 refuses,
integer division of an integral decimal) the statement carries PostgreSQL's
result spelled for sqlite3, and the two errors carry PostgreSQL's words.
Each statement runs through the port (device="cpu", the dispatcher on its
kernel route) over the same rows of w(id, g, v, m, x, s, dt): 300 rows made
from a seed, seven partitions, NULLs in every column but id and g
(lingodb_tpu_torch/tools/sqlite_battery.py)."""

import sqlite3

import pytest

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_battery as sb
from lingodb_tpu_torch.tools import sqlite_oracle as so

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

TIERS = [dv.SMALL_ROWS, 2]
STATEMENTS = sb.SEMANTICS_STATEMENTS


@pytest.fixture(scope="module")
def engines():
    conn = sqlite3.connect(":memory:")
    old = pgather.FORCE_KERNELS, dv.SMALL_ROWS
    pgather.FORCE_KERNELS = True
    ps = {}
    for small_rows in TIERS:
        dv.SMALL_ROWS = small_rows  # read when a column is first uploaded
        ps[small_rows] = ldb.create_in_memory(device="cpu")
    for st in sb.semantics_setup():
        conn.execute(st)
        for s in ps.values():
            s.sql_stmt(st)
    yield ps, conn
    conn.close()
    pgather.FORCE_KERNELS, dv.SMALL_ROWS = old


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_gives_postgresql_result(engines, name, small_rows,
                                           monkeypatch):
    ps, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    sql, oracle = STATEMENTS[name]
    if isinstance(oracle, sb.Raises):
        with pytest.raises(Exception, match=str(oracle)):
            ps[small_rows].sql(sql)
        return
    ours = so.our_rows(ps[small_rows].sql(sql))
    ok, msg = so.rows_equal(ours, so.run_sqlite(conn, oracle or sql),
                            ordered=True)
    assert ok, f"{sql}: {msg}"


LAG_DEFAULTS = ["lag(v, 1, -99)", "lag(v, 1, 7)", "lag(v, 1)",
                "lag(v, 2, 7)"]


def _window_plan(session, expr):
    from lingodb_tpu_torch.opt.optimizer import optimize
    from lingodb_tpu_torch.sql.binder import Binder
    from lingodb_tpu_torch.sql.parser import parse_sql

    stmt = parse_sql(_over(expr))[-1]
    return optimize(Binder(session.catalog).bind_query(stmt),
                    session.catalog)


def _over(expr):
    return (f"SELECT id, {expr} OVER (PARTITION BY g ORDER BY id) FROM w "
            "ORDER BY id")


def test_lag_default_keys_the_plan_and_survives_json(engines):
    """lag / lead's default is part of the plan: the plan key (which keys
    the fused programs' caches and the learned capacities) tells two
    defaults apart, and the plan's JSON (a query artifact's plan) carries
    it back."""
    from lingodb_tpu_torch.plan import logical as L
    from lingodb_tpu_torch.plan.serial import (plan_from_json, plan_key,
                                               plan_to_json)

    s = engines[0][dv.SMALL_ROWS]
    plans = [_window_plan(s, e) for e in LAG_DEFAULTS]
    assert len({plan_key(p) for p in plans}) == len(LAG_DEFAULTS)
    for p in plans:
        back = plan_from_json(plan_to_json(p))
        assert plan_key(back) == plan_key(p)
        fns = [f for n in L.walk_plan(back) if isinstance(n, L.Window)
               for f in n.funcs]
        want = [f for n in L.walk_plan(p) if isinstance(n, L.Window)
                for f in n.funcs]
        assert [(f.extra, repr(f.default)) for f in fns] == [
            (f.extra, repr(f.default)) for f in want]


def test_lag_with_two_defaults_in_one_statement(engines):
    """Two lag calls that differ only in their default are two columns (the
    common-subexpression pass keys on the default too)."""
    ps, conn = engines
    sql = ("SELECT id, lag(v, 1, -99) OVER (ORDER BY id), "
           "lag(v, 1, 7) OVER (ORDER BY id) FROM w ORDER BY id")
    for s in ps.values():
        ok, msg = so.rows_equal(so.our_rows(s.sql(sql)),
                                so.run_sqlite(conn, sql), ordered=True)
        assert ok, msg


def test_query_artifact_carries_the_lag_default(engines, tmp_path):
    from lingodb_tpu_torch.tools import artifact

    ps, conn = engines
    s = ps[dv.SMALL_ROWS]
    sql = _over("lag(s, 1, 'none')")
    art = str(tmp_path / "lag.zip")
    artifact.build_artifact(s, sql, art)
    ok, msg = so.rows_equal(so.our_rows(artifact.run_artifact(s, art)),
                            so.run_sqlite(conn, sql), ordered=True)
    assert ok, msg
