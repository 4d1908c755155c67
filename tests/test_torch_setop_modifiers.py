"""A trailing ORDER BY, LIMIT or OFFSET after a set operation orders, limits
and offsets the whole result, not the set operation's last branch.

The JAX package binds them to the last branch, so sqlite3 is the oracle
here: each statement runs through the port (device="cpu", the dispatcher on
its kernel route) on both storage tiers and through sqlite3, over
a(x) = 1, 5, 3 and bb(y) = 4, 2, 6 (the statements, and sqlite3's spelling
of them, are in lingodb_tpu_torch/tools/sqlite_battery.py). A parenthesized
branch keeps its own modifiers, a plain SELECT and the pipe operator's set
operation are parsed as before: those statements are held against the JAX
package too."""

import sqlite3

import pytest

import lingodb_tpu as ref_ldb

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_battery as sb
from lingodb_tpu_torch.tools import sqlite_oracle as so

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

TIERS = [dv.SMALL_ROWS, 2]
SETUP = sb.SETOP_SETUP
WHOLE_RESULT = sb.SETOP_WHOLE_RESULT
UNCHANGED = sb.SETOP_UNCHANGED


@pytest.fixture(scope="module")
def engines():
    conn = sqlite3.connect(":memory:")
    rs = ref_ldb.create_in_memory()
    old = pgather.FORCE_KERNELS, dv.SMALL_ROWS
    pgather.FORCE_KERNELS = True
    ps = {}
    for small_rows in TIERS:
        dv.SMALL_ROWS = small_rows  # read when a column is first uploaded
        ps[small_rows] = ldb.create_in_memory(device="cpu")
    for st in SETUP:
        conn.execute(st)
        rs.sql_stmt(st)
        for s in ps.values():
            s.sql_stmt(st)
    yield ps, rs, conn
    conn.close()
    pgather.FORCE_KERNELS, dv.SMALL_ROWS = old


def _check(engines, small_rows, monkeypatch, sql, sqlite_sql):
    ps, _rs, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    res = ps[small_rows].sql(sql)
    ok, msg = so.rows_equal(so.our_rows(res),
                            so.run_sqlite(conn, sqlite_sql or sql),
                            ordered=True)
    assert ok, f"{sql}: {msg}"
    return res


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("name", list(WHOLE_RESULT))
def test_modifiers_bind_to_the_whole_set_result(engines, name, small_rows,
                                                 monkeypatch):
    _check(engines, small_rows, monkeypatch, *WHOLE_RESULT[name])


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("name", list(UNCHANGED))
def test_branch_and_plain_modifiers_are_unchanged(engines, name, small_rows,
                                                  monkeypatch):
    sql = UNCHANGED[name][0]
    res = _check(engines, small_rows, monkeypatch, *UNCHANGED[name])
    assert res.format_rows() == engines[1].sql(sql).format_rows(), sql
