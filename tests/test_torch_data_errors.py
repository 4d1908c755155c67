"""Errors the data raises, raised as PostgreSQL raises them, held against
sqlite3 on both storage tiers: INT and BIGINT arithmetic beyond the type's
range ("integer out of range", "bigint out of range"; the JAX package
wraps), a cast from a string that parses only the rows that are live
(PostgreSQL's input grammar: no fraction or exponent in an integer, blanks
around it allowed, '' refused; the JAX package parses every dictionary
entry and raises Python's ValueError), and a cast of a decimal or a double
to an integer that rounds (half away from zero, half to even; the JAX
package truncates).

The statements and sqlite3's spelling of PostgreSQL's result, or
PostgreSQL's words, live in lingodb_tpu_torch/tools/sqlite_battery.py
(ERROR_STATEMENTS). Each runs through the port (device="cpu", the
dispatcher on its kernel route) over w(id, g, v, m, x, s, dt) and z(i, k);
on the tensor tier the aggregates and chains run as the fused programs, so
their errors come back through the programs' packed fetch."""

import re
import sqlite3

import pytest
import torch

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.ops import scalar as sc
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_battery as sb
from lingodb_tpu_torch.tools import sqlite_oracle as so

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

TIERS = [dv.SMALL_ROWS, 2]
STATEMENTS = sb.ERROR_STATEMENTS


@pytest.fixture(scope="module")
def engines():
    conn = sqlite3.connect(":memory:")
    old = pgather.FORCE_KERNELS, dv.SMALL_ROWS
    pgather.FORCE_KERNELS = True
    ps = {}
    for small_rows in TIERS:
        dv.SMALL_ROWS = small_rows  # read when a column is first uploaded
        ps[small_rows] = ldb.create_in_memory(device="cpu")
    for st in sb.semantics_setup() + sb.errors_setup():
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
        with pytest.raises(sc.EvalError, match=f"^{re.escape(oracle)}$"):
            ps[small_rows].sql(sql)
        return
    ours = so.our_rows(ps[small_rows].sql(sql))
    ok, msg = so.rows_equal(ours, so.run_sqlite(conn, oracle or sql),
                            ordered=True)
    assert ok, f"{sql}: {msg}"



@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("name", list(sb.INSERT_STATEMENTS))
def test_insert_coerces_as_a_cast(engines, name, small_rows, monkeypatch):
    """INSERT coerces to the table's types as CAST does: rounding, and
    raising PostgreSQL's errors (the JAX package floors a decimal, parses
    '12.7' as 12 and stores 2147483648 in an INT column)."""
    ps, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    sql, oracle = sb.INSERT_STATEMENTS[name]
    table = f"ins_{name}"
    ps[small_rows].sql_stmt(f"CREATE TABLE {table}(a INT, b BIGINT)")
    if isinstance(oracle, sb.Raises):
        with pytest.raises(sc.EvalError, match=f"^{re.escape(oracle)}$"):
            ps[small_rows].sql_stmt(sql.format(t=table))
        return
    ps[small_rows].sql_stmt(sql.format(t=table))
    ours = so.our_rows(ps[small_rows].sql(
        f"SELECT a, b FROM {table} ORDER BY a"))
    ok, msg = so.rows_equal(ours, so.run_sqlite(conn, oracle), ordered=True)
    assert ok, f"{sql}: {msg}"


# statements whose joins, filters and select lists run through the sharded
# operators on a mesh of 8 positions (runtime/executor.py: the sharded
# join's keys and its full predicate, the masks, the Maps)
MESH_CASES = ["int_overflow_in_join_filter", "int_overflow_in_join_filter_removed",
              "cast_in_join_filter", "cast_after_join", "int_mul_chain",
              "cast_live_rows_only", "cast_in_predicate", "cast_every_row"]


@pytest.fixture(scope="module")
def mesh_session():
    from lingodb_tpu_torch.parallel import mesh as msh
    from lingodb_tpu_torch.utils import settings

    old = dv.SMALL_ROWS, (dv._MESH, dv._MESH_INIT)
    dv.SMALL_ROWS = 2
    settings.set_setting("system.shuffle_min_rows", 2)
    s = ldb.create_in_memory(device="cpu")
    for st in sb.semantics_setup() + sb.errors_setup():
        s.sql_stmt(st)
    yield s, msh.Mesh(["cpu"] * 8)
    dv.SMALL_ROWS = old[0]
    dv._MESH, dv._MESH_INIT = old[1]
    settings.SHUFFLE_MIN_ROWS.reset()


@pytest.mark.parametrize("name", MESH_CASES)
def test_statement_on_a_mesh(engines, mesh_session, name, monkeypatch):
    """The sharded operators raise as the one-card session does, on the
    rows that are live; the joins run as the sharded join."""
    from lingodb_tpu_torch.parallel import shuffle as sh

    s, mesh = mesh_session
    _ps, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    monkeypatch.setattr(dv, "_MESH", mesh)
    monkeypatch.setattr(dv, "_MESH_INIT", True)
    sql, oracle = STATEMENTS[name]
    joins = sh.STATS["joins"]
    if isinstance(oracle, sb.Raises):
        with pytest.raises(sc.EvalError, match=f"^{re.escape(oracle)}$"):
            s.sql(sql)
    else:
        ok, msg = so.rows_equal(so.our_rows(s.sql(sql)),
                                so.run_sqlite(conn, oracle or sql),
                                ordered=True)
        assert ok, f"{sql}: {msg}"
    if " JOIN " in sql:
        assert sh.STATS["joins"] > joins, "the sharded join did not run"


@pytest.mark.parametrize("p,s,code", [(10, 2, False), (11, 2, False),
                                      (12, 2, True), (15, 2, True)])
def test_decimal_to_int_builds_a_code_only_where_it_can_overflow(p, s, code):
    """A DECIMAL(p, s) below 10^9 (p - s <= 9) fits an INT even rounded: its
    cast builds no error code; a wider one does, and raises past the
    range."""
    from lingodb_tpu_torch.runtime.vtable import SCol
    from lingodb_tpu_torch.sql.types import Type

    top = 10**(p - s) - 1  # the largest integral part
    data = torch.tensor([top * 10**s + 10**s // 2, -5, 250], dtype=torch.int64)
    out = sc.eval_cast(SCol(Type.decimal(p, s), data), Type.int_())
    assert (out.err is not None) == code
    fits = top + 1 <= 2**31 - 1
    if out.err is not None:
        first = int(sc.first_error(out.err, None, 3)[0])
        assert (first == 0) == fits
    if fits:
        assert out.data.tolist() == [top + 1, 0, 3]
