"""A battery of SQL features, port against reference, row for row.

Small tables with NULLs, decimals, doubles, dates and strings go through
`lingodb_tpu` and through `lingodb_tpu_torch` (device="cpu", DEBUG mode, the
dispatcher on its kernel route) on both storage tiers: at the real
SMALL_ROWS threshold these tables are numpy arrays (host tier), with the
threshold at 2 rows every column is a tensor, as for large tables.
`format_rows()` must be equal string for string.

The statements that end in an ORDER BY after a set operation are held
against sqlite3 instead: the JAX package binds that ORDER BY to the last
branch, the port to the whole result. sqlite3 has no EXCEPT ALL, so that
one is held against the JAX package's rows as a multiset, its order against
its ORDER BY. A cast of a decimal to an integer rounds half away from zero
in PostgreSQL and in the port, a double's rounds half to even, and the JAX
package truncates both: there its rows for the statement with the rounding
spelled out are the oracle (its round() goes half away from zero, which is
half to even on the doubles of the battery: 1.5 and 3.5)."""

import re
import sqlite3

import pytest

import lingodb_tpu as ref_ldb

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_oracle as so
from lingodb_tpu_torch.tools.sql_battery import QUERIES, SETUP
from lingodb_tpu_torch.utils.settings import EXECUTION_MODE

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

TIERS = [dv.SMALL_ROWS, 2]
# the statements with an ORDER BY after a set operation
SET_ORDERED = {i for i, q in enumerate(QUERIES)
               if re.search(r"\b(union|intersect|except)\b.*\border by\b",
                            q, re.IGNORECASE)}
# decimal and double to integer, as PostgreSQL casts them, spelled for the
# JAX package
ROUNDED_CASTS = {"cast(salary AS INT)": "cast(round(salary) AS INT)",
                 "cast(bonus AS INT)": "cast(round(bonus) AS INT)"}


def _reference_form(q: str) -> str:
    for ours, theirs in ROUNDED_CASTS.items():
        q = q.replace(ours, theirs)
    return q


def _session(mod, **kw):
    s = mod.create_in_memory(**kw)
    for st in SETUP:
        s.sql_stmt(st)
    return s


@pytest.fixture(scope="module")
def sessions():
    rs = _session(ref_ldb)
    want = {}
    ps = {}
    old = pgather.FORCE_KERNELS, dv.SMALL_ROWS
    pgather.FORCE_KERNELS = True
    EXECUTION_MODE.set("DEBUG")
    for small_rows in TIERS:
        dv.SMALL_ROWS = small_rows  # read when a column is first uploaded
        ps[small_rows] = _session(ldb, device="cpu")
    conn = sqlite3.connect(":memory:")
    for st in SETUP:
        conn.execute(so.adapt_for_sqlite(st))
    yield rs, ps, want, conn
    conn.close()
    EXECUTION_MODE.set("DEFAULT")
    pgather.FORCE_KERNELS, dv.SMALL_ROWS = old


def _held_against_sqlite(rs, port, conn, q):
    res = port.sql(q)
    if re.search(r"\bexcept all\b", q, re.IGNORECASE):
        rows = res.format_rows()
        assert sorted(rows) == sorted(rs.sql(q).format_rows()), q
        # ORDER BY 1 NULLS FIRST over one integer column
        keys = [(v is not None, v) for (v,) in res.to_pylist()]
        assert keys == sorted(keys), q
        return
    ok, msg = so.rows_equal(so.our_rows(res), so.run_sqlite(conn, q),
                            ordered=True)
    assert ok, f"{q}: {msg}"


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_query_equals_reference(sessions, i, small_rows, monkeypatch):
    rs, ps, want, conn = sessions
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    q = QUERIES[i]
    if i in SET_ORDERED:
        _held_against_sqlite(rs, ps[small_rows], conn, q)
        return
    if i not in want:
        want[i] = rs.sql(_reference_form(q)).format_rows()
    assert ps[small_rows].sql(q).format_rows() == want[i], q
