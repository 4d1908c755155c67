"""The port's counterpart of tests/test_decimal_wide.py (wide-decimal
(precision > 18) exactness): the same cases on the port's sessions
(device="cpu"), asserting the values the reference file asserts. What the
reference file says of its subject:

Wide-decimal (precision > 18) exactness torture tests.

The reference computes high-precision decimals in i128
(src/compiler/Dialect/DB/Transforms DBToStd lowering, LowerToStd.cpp:128-330).
This engine's tiered representation (scaled int64 physical + host Python-int
object arrays past 63 bits, ops/decwide.py) must be EXACT — no float fallback
for any precision <= 38. Every expectation here is computed with Python ints /
decimal.Decimal, not an oracle, so there is no tolerance to hide behind.
"""

import pytest

from decimal import Decimal


@pytest.fixture()
def session():
    import lingodb_tpu_torch as ldb

    return ldb.create_in_memory(device="cpu")


def one(res):
    return res.format_rows()[0][0]


def test_wide_literal_roundtrip(session):
    # 25 significant digits: far beyond int64
    r = session.sql("select 1234567890123456789012345.67::decimal(38,2)")
    assert str(one(r)) == "1234567890123456789012345.67"


def test_wide_sum_exact(session):
    # sum of int64-boundary values overflows int64 but must stay exact
    session.sql("create table t (v decimal(38,0))")
    big = 9223372036854775807  # int64 max
    session.sql(f"insert into t values ({big}), ({big}), ({big}), (1)")
    r = session.sql("select sum(v) from t")
    assert int(str(one(r))) == 3 * big + 1


def test_wide_sum_group_by(session):
    session.sql("create table t (k int, v decimal(38,4))")
    rows = []
    vals = {1: [], 2: []}
    for i in range(50):
        k = 1 + (i % 2)
        v = (10**20 + i * 7) if i % 3 else -(10**19 + i)
        vals[k].append(v)
        rows.append(f"({k}, {Decimal(v).scaleb(-4)})")
    session.sql("insert into t values " + ", ".join(rows))
    r = session.sql("select k, sum(v) from t group by k order by k")
    got = {int(str(row[0])): Decimal(str(row[1])) for row in r.format_rows()}
    for k in (1, 2):
        assert got[k] == Decimal(sum(vals[k])).scaleb(-4), k


def test_wide_avg_exact(session):
    session.sql("create table t (v decimal(38,2))")
    session.sql("insert into t values (100000000000000000000.01), "
                "(200000000000000000000.02), (300000000000000000000.03)")
    r = session.sql("select avg(v) from t")
    # avg = 200000000000000000000.02 exactly
    assert Decimal(str(one(r))) == Decimal("200000000000000000000.02")


def test_wide_arith_mul(session):
    # 10^15 * 10^15 = 10^30: product exceeds int64
    r = session.sql(
        "select (1000000000000000.5::decimal(38,1)) * (1000000000000000.5::decimal(38,1))")
    # exact: (10^15 + 0.5)^2 = 10^30 + 10^15 + 0.25 (Decimal ** would round
    # to context precision, so compare against the digit string)
    assert str(one(r)).rstrip("0") == "1000000000000001000000000000000.25"


def test_wide_arith_div(session):
    r = session.sql(
        "select (1000000000000000000000000000::decimal(38,0)) / (7::decimal(38,0))")
    txt = str(one(r))
    # exact rational: 10^27/7 rounded half-away at the result scale; compare
    # as scaled integers (Decimal arithmetic would round at context precision)
    s = len(txt.split(".")[1]) if "." in txt else 0
    got_scaled = int(txt.replace(".", ""))
    want_scaled = (2 * 10**27 * 10**s + 7) // (2 * 7)
    assert got_scaled == want_scaled, (txt, want_scaled, s)


def test_wide_compare_and_filter(session):
    session.sql("create table t (v decimal(38,0))")
    session.sql("insert into t values (99999999999999999999999999999999999998), "
                "(99999999999999999999999999999999999999), (5)")
    r = session.sql(
        "select count(*) from t where v > 99999999999999999999999999999999999998")
    assert int(str(one(r))) == 1


def test_wide_order_by(session):
    session.sql("create table t (v decimal(38,0))")
    vals = [10**37, -(10**37), 10**20, -5, 0, 10**37 - 1, -(10**30)]
    session.sql("insert into t values " + ", ".join(f"({v})" for v in vals))
    r = session.sql("select v from t order by v")
    got = [int(str(row[0])) for row in r.format_rows()]
    assert got == sorted(vals)


def test_wide_min_max(session):
    session.sql("create table t (v decimal(38,0))")
    vals = [10**37, -(10**37), 42]
    session.sql("insert into t values " + ", ".join(f"({v})" for v in vals))
    r = session.sql("select min(v), max(v) from t")
    row = r.format_rows()[0]
    assert int(str(row[0])) == -(10**37)
    assert int(str(row[1])) == 10**37


def test_wide_join_key_and_null(session):
    session.sql("create table a (k decimal(38,0), x int)")
    session.sql("create table b (k decimal(38,0), y int)")
    session.sql(f"insert into a values ({10**30}, 1), ({10**31}, 2), (null, 3)")
    session.sql(f"insert into b values ({10**30}, 10), (null, 30)")
    r = session.sql("select a.x, b.y from a join b on a.k = b.k")
    assert [[str(v) for v in row] for row in r.format_rows()] == [["1", "10"]]


def test_narrow_decimal_still_int64(session):
    # the common case must stay on the fast scaled-int64 path
    session.sql("create table t (v decimal(12,2))")
    session.sql("insert into t values (1.25), (2.50), (3.25)")
    r = session.sql("select sum(v), avg(v) from t")
    row = r.format_rows()[0]
    assert Decimal(str(row[0])) == Decimal("7.00")
    assert str(row[1]).startswith("2.333333")  # exact at the widened scale


def test_high_scale_exact(session):
    # scale > 18 (previously float64 fallback — now exact)
    r = session.sql("select 0.12345678901234567890123::decimal(38,23) + "
                    "0.00000000000000000000001::decimal(38,23)")
    assert str(one(r)) == "0.12345678901234567890124"

