"""The port's window functions (ops/window.py) held against the JAX package.

The same SQL runs through `lingodb_tpu` (its CPU backend, as its own tests
run it) and through `lingodb_tpu_torch` on device="cpu", over the same rows:
a small table with NULLs in the order key and the argument (the frame sweep
of tests/test_window_frames.py), a table of 4,100 rows with frames whose
length is exactly a power of two (the sparse table's level), an empty
table, and SF-0.005 TPC-H `orders`. The port runs each query twice: with its
tables on the host tier and on the tensor tier. Integers and decimals must
be equal; floats (avg, percent_rank, cume_dist) within a relative 1e-12.
"""

import math

import numpy as np
import pytest

import lingodb_tpu as ref_ldb
from lingodb_tpu.tools import tpchgen as ref_tpchgen

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import carry, tpchgen

from test_torch_engine import _extract

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

REL = 1e-12
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
N_POW = 4100


def _setup(s, tensors):
    s.sql_stmt("create table t(p int, i int, v int)")
    s.sql_stmt("insert into t values " + ",".join(
        "(%s,%s,%s)" % tuple("NULL" if x is None else x for x in r)
        for r in ROWS))
    s.sql_stmt("create table e(p int, i int, v int)")
    rng = np.random.default_rng(7)
    vals = rng.integers(-1000, 1000, N_POW)
    s.sql_stmt("create table w(p int, i int, v bigint)")
    s.sql_stmt("insert into w values " + ",".join(
        f"({k % 3},{k},{int(x)})" for k, x in enumerate(vals)))


@pytest.fixture(scope="module")
def sessions():
    rs = ref_ldb.create_in_memory()
    _setup(rs, False)
    ref_tables = ref_tpchgen.load_into(rs, sf=0.005, seed=19920601)
    carried = carry.tables_from_numpy(_extract(ref_tables))
    ps = ldb.create_in_memory(device="cpu")
    _setup(ps, True)
    tpchgen.install(ps, carried)
    return rs, ps


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                if math.isnan(b):
                    assert math.isnan(a)
                else:
                    assert a == pytest.approx(b, rel=REL, abs=0.0), (g, w)
            else:
                assert a == b, (g, w)


def _check(sessions, q, monkeypatch, tiers=(dv.SMALL_ROWS, 2)):
    rs, ps = sessions
    want = rs.sql(q).to_pylist()
    for small in tiers:
        monkeypatch.setattr(dv, "SMALL_ROWS", small)
        ps._device_cache.clear()
        _rows_close(ps.sql(q).to_pylist(), want)
    return want


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("frame", FRAMES)
def test_frame_sweep_equals_reference(sessions, order, frame, monkeypatch):
    sel = ", ".join(f"{fn} over (partition by p {order} {frame})" for fn in FNS)
    _check(sessions, f"select p, i, v, {sel} from t order by p, i, v",
           monkeypatch)


RANKING = [
    "row_number() over (partition by p order by i nulls last, v)",
    "rank() over (partition by p order by i nulls first)",
    "dense_rank() over (partition by p order by i desc nulls last)",
    "percent_rank() over (partition by p order by i nulls last)",
    "cume_dist() over (partition by p order by i nulls first)",
    "ntile(2) over (partition by p order by i nulls last, v)",
    "lag(v) over (partition by p order by i nulls last, v)",
    "lead(v, 2) over (partition by p order by i nulls first, v)",
    "first_value(v) over (partition by p order by i nulls last)",
    "last_value(v) over (partition by p order by i nulls last)",
    "nth_value(v, 2) over (partition by p order by i nulls last)",
    "sum(v) over (partition by p order by i nulls last)",
    "avg(v) over (partition by p)",
    "min(v) over (partition by p order by i desc nulls first)",
    "max(v) over ()",
    "count(*) over (order by i nulls first)",
]


@pytest.mark.parametrize("fn", RANKING)
def test_default_frames_and_ranking_equal_reference(sessions, fn, monkeypatch):
    _check(sessions, f"select p, i, v, {fn} from t order by p, i, v",
           monkeypatch)


@pytest.mark.parametrize("k", [1, 2, 3, 10, 12])
def test_frame_of_exactly_2k_rows(sessions, k, monkeypatch):
    """Frames of exactly 2^k rows read level k of the sparse table: the
    level comes from log2 of a float64 power of two in both engines."""
    span = (1 << k) - 1
    q = (f"select p, i, min(v) over (partition by p order by i rows between "
         f"{span} preceding and current row), max(v) over (order by i rows "
         f"between current row and {span} following), sum(v) over (order by "
         f"i rows between {span} preceding and current row) from w "
         f"order by i limit 50 offset 4000")
    _check(sessions, q, monkeypatch)


def test_row_number_over_a_two_row_table(monkeypatch):
    """The window query that tests/test_torch_engine.py expected to raise
    while window functions were not ported."""
    rs = ref_ldb.create_in_memory()
    ps = ldb.create_in_memory(device="cpu")
    for s in (rs, ps):
        s.sql_stmt("CREATE TABLE t(a INT)")
        s.sql_stmt("INSERT INTO t VALUES (1), (2)")
    q = "SELECT a, row_number() OVER (ORDER BY a) FROM t"
    assert _check((rs, ps), q, monkeypatch) == [[1, 1], [2, 2]]


def test_empty_input(sessions, monkeypatch):
    q = ("select p, row_number() over (partition by p order by i), sum(v) "
         "over (order by i rows between 1 preceding and current row), "
         "min(v) over (order by i rows between 2 preceding and 1 following) "
         "from e")
    assert _check(sessions, q, monkeypatch) == []


TPCH = [
    # ranking per customer over orders, wrapped in an aggregate
    "select sum(rn), sum(rk), sum(drk) from (select row_number() over "
    "(partition by o_custkey order by o_orderdate, o_orderkey) rn, rank() over "
    "(partition by o_custkey order by o_orderdate) rk, dense_rank() over "
    "(partition by o_custkey order by o_orderdate) drk from orders) x",
    # running sum (RANGE) and a bounded ROWS avg
    "select o_custkey, o_orderdate, sum(o_totalprice) over (partition by "
    "o_custkey order by o_orderdate), avg(o_totalprice) over (partition by "
    "o_custkey order by o_orderdate, o_orderkey rows between 2 preceding and "
    "current row) from orders order by o_custkey, o_orderdate, o_orderkey "
    "limit 40",
    # min/max over a bounded frame: the sparse table
    "select min(m), max(x) from (select min(o_totalprice) over (order by "
    "o_orderkey rows between 5 preceding and 5 following) m, max(o_totalprice) "
    "over (partition by o_orderpriority order by o_orderdate rows between "
    "3 preceding and 1 following) x from orders) y",
    # lag / lead / nth_value
    "select sum(o_orderkey - coalesce(prev, 0)), count(nxt), count(n3) from "
    "(select o_orderkey, lag(o_orderkey) over (partition by o_custkey order by "
    "o_orderkey) prev, lead(o_orderkey) over (partition by o_custkey order by "
    "o_orderkey) nxt, nth_value(o_orderkey, 3) over (partition by o_custkey "
    "order by o_orderkey) n3 from orders) z",
]


@pytest.mark.parametrize("q", range(len(TPCH)))
def test_tpch_orders_windows_equal_reference(sessions, q, monkeypatch):
    assert _check(sessions, TPCH[q], monkeypatch)


# ------------------------------------------------------------ device LIKE
# ops/bytestr.py shares this file: its end-to-end case needs the TPC-H pair

LIKE_PATTERNS = [
    "abc", "%", "", "a%", "%a", "%bc%", "a%c", "a%b%c", "ab_", "_b_",
    "%b_d%", "a__%", "%%x%%", "ab\\%cd", "ab\\_cd", "%\\%%",
    "abc%def%", "%abc%def", "a%a%a", "aa%", "%aa", "_",
]
WORDS = [
    "", "a", "b", "ab", "abc", "abcd", "aabc", "abab", "aaa", "aa",
    "ab%cd", "ab_cd", "abcdef", "abcxdef", "xabc", "abcx", "a c",
    "abc def", "aXbXc", "zzz", "ab", "ba", "abca", "aabbcc", "a_c",
    "abcdefghij" * 13,  # > 128 bytes: exercises padding width
]


@pytest.mark.parametrize("ci", [False, True])
@pytest.mark.parametrize("pat", LIKE_PATTERNS)
def test_device_like_mask_equals_reference(pat, ci):
    from lingodb_tpu.ops import bytestr as ref_bytestr

    from lingodb_tpu_torch.ops import bytestr, strings

    dictionary = np.asarray(WORDS + [w.upper() for w in WORDS], dtype=object)
    got = bytestr.device_like_mask(dictionary, pat, ci, "cpu")
    want = ref_bytestr.device_like_mask(dictionary, pat, ci)
    assert got is not None and want is not None
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), strings.like_lut(dictionary, pat, ci))


@pytest.mark.parametrize("pat,ci", [("h%o", False), ("h_llo", False),
                                    ("h%o", True), ("%é%", False)])
def test_device_like_mask_non_ascii(pat, ci):
    """Non-ASCII data: a plain segment pattern matches byte-wise; `_` and
    ILIKE (which count or fold characters) and a non-ASCII pattern return
    None in both packages (the host matches)."""
    from lingodb_tpu.ops import bytestr as ref_bytestr

    from lingodb_tpu_torch.ops import bytestr, strings

    d = np.asarray(["héllo", "hello", "ünïcode"], dtype=object)
    got = bytestr.device_like_mask(d, pat, ci, "cpu")
    want = ref_bytestr.device_like_mask(d, pat, ci)
    assert (got is None) == (want is None)
    if pat == "h%o" and not ci:
        assert got.tolist() == [True, True, False]
        assert got.tolist() == strings.like_lut(d, pat, ci).tolist()
    else:
        assert got is None


def test_device_length():
    from lingodb_tpu_torch.ops import bytestr

    for words in (WORDS, ["héllo", "hello", "ünïcode", ""]):
        d = np.asarray(words, dtype=object)
        assert bytestr.device_length(d, "cpu").tolist() == [len(w) for w in words]


def test_q13_device_like_equals_reference(sessions, monkeypatch):
    """q13's `o_comment not like '%special%requests%'` on the tensor tier
    with DEVICE_DICT_MIN lowered in both packages: the device mask engages
    in the port, and the rows equal the JAX package's."""
    from lingodb_tpu.ops import bytestr as ref_bytestr

    from lingodb_tpu_torch.ops import bytestr

    rs, ps = sessions
    monkeypatch.setattr(ref_bytestr, "DEVICE_DICT_MIN", 16)
    monkeypatch.setattr(bytestr, "DEVICE_DICT_MIN", 16)
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    ps._device_cache.clear()
    bytestr._MASK_CACHE.clear()
    engaged = []
    orig = bytestr.device_like_mask

    def spy(*a, **k):
        r = orig(*a, **k)
        engaged.append(r is not None)
        return r

    monkeypatch.setattr(bytestr, "device_like_mask", spy)
    sql = open("queries/tpch/13.sql").read()
    assert ps.sql(sql).format_rows() == rs.sql(sql).format_rows()
    assert engaged and all(engaged)
