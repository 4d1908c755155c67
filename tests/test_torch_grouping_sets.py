"""The grouping-sets rewrite (ROLLUP, CUBE, either beside plain keys, and
grouping()) on the port's sessions (device="cpu"), over tools/tpcdsgen.py's
tables at sf 0.002 from each package: the port's counterpart of
tests/test_tpcds.py::test_rollup_matches_expanded_union and
::test_grouping_function, which need no reference checkout here. ROLLUP is
held against its UNION ALL expansion run by sqlite3, as the reference file
holds it; every statement is held against the JAX package's rows. Neither
package parses an explicit GROUPING SETS clause: the sets come from ROLLUP
and CUBE (sql/binder.py's rewrite into a union of aggregates)."""

import sqlite3

import pytest

import lingodb_tpu as ref_ldb
import lingodb_tpu_torch as ldb
from lingodb_tpu.tools import tpcdsgen as ref_tpcdsgen
from lingodb_tpu_torch.tools import sqlite_oracle as so
from lingodb_tpu_torch.tools import tpcdsgen

SF = 0.002


@pytest.fixture(scope="module")
def tpcds():
    ps = ldb.create_in_memory(device="cpu")
    tables = tpcdsgen.load_into(ps, sf=SF)
    rs = ref_ldb.create_in_memory()
    ref_tpcdsgen.load_into(rs, sf=SF)
    conn = sqlite3.connect(":memory:")
    tpcdsgen.to_sqlite(conn, tables)
    yield ps, rs, conn
    conn.close()


def _same_rows(ps, rs, sql):
    """The port's rows equal the JAX package's as strings (a multiset:
    genuine NULL keys tie with rolled-up subtotal rows under ORDER BY)."""
    got = ps.sql(sql).format_rows()
    assert got and sorted(got) == sorted(rs.sql(sql).format_rows())
    return got


def test_rollup_matches_expanded_union(tpcds):
    """GROUP BY ROLLUP must equal the explicit UNION ALL expansion (which
    sqlite can also run): validates the grouping-sets rewrite end to end."""
    ps, rs, conn = tpcds
    rollup_sql = """
        SELECT i_category, i_class, SUM(i_current_price)
        FROM item GROUP BY ROLLUP(i_category, i_class)
        ORDER BY i_category NULLS LAST, i_class NULLS LAST"""
    expanded_sql = """
        SELECT i_category, i_class, SUM(i_current_price) AS s
        FROM item GROUP BY i_category, i_class
        UNION ALL
        SELECT i_category, NULL, SUM(i_current_price) FROM item GROUP BY i_category
        UNION ALL
        SELECT NULL, NULL, SUM(i_current_price) FROM item
        ORDER BY i_category NULLS LAST, i_class NULLS LAST"""
    ours = so.our_rows(ps.sql(rollup_sql))
    theirs = so.run_sqlite(conn, expanded_sql)
    ok, msg = so.rows_equal(ours, theirs, ordered=False)
    assert ok, msg
    _same_rows(ps, rs, rollup_sql)


def test_grouping_function(tpcds):
    ps, rs, _conn = tpcds
    r = ps.sql("""
        SELECT grouping(i_category), grouping(i_class), count(*)
        FROM item GROUP BY ROLLUP(i_category, i_class)
        ORDER BY 1, 2 LIMIT 1""")
    assert r.format_rows()[0][:2] == ["0", "0"]
    # every level's flags, against the JAX package
    got = _same_rows(ps, rs, """
        SELECT i_category, i_class, grouping(i_category), grouping(i_class),
               count(*)
        FROM item GROUP BY ROLLUP(i_category, i_class)""")
    assert {tuple(r[2:4]) for r in got} == {("0", "0"), ("0", "1"),
                                            ("1", "1")}


GROUPING_SQL = {
    "cube": """
        SELECT i_category, i_class, SUM(i_current_price), count(*)
        FROM item GROUP BY CUBE(i_category, i_class)""",
    "cube_grouping": """
        SELECT i_category, i_brand, grouping(i_category) + grouping(i_brand),
               max(i_current_price)
        FROM item GROUP BY CUBE(i_category, i_brand)""",
    # a plain key beside ROLLUP / CUBE: the grouping sets (c, l, b),
    # (c, l), (c), and (s, c), (s) over a join
    "grouping_sets": """
        SELECT i_category, i_class, i_brand, SUM(i_current_price), count(*)
        FROM item GROUP BY i_category, ROLLUP(i_class, i_brand)""",
    "grouping_sets_join": """
        SELECT s_state, i_category, grouping(i_category), SUM(ss_net_paid),
               count(*)
        FROM store_sales, item, store
        WHERE ss_item_sk = i_item_sk AND ss_store_sk = s_store_sk
        GROUP BY s_state, CUBE(i_category)""",
    "rollup_having": """
        SELECT i_category, i_class, avg(i_current_price)
        FROM item GROUP BY ROLLUP(i_category, i_class)
        HAVING count(*) > 2""",
}


@pytest.mark.parametrize("name", list(GROUPING_SQL))
def test_grouping_sets_match_the_reference(tpcds, name):
    ps, rs, _conn = tpcds
    _same_rows(ps, rs, GROUPING_SQL[name])
