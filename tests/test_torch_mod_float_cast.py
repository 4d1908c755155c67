"""DECIMAL % and casts from DOUBLE and REAL to DECIMAL, exact as PostgreSQL
gives them, on both storage tiers:

- C27: `%` rescaled both operands to the result's scale in int64 with no
  check, so a dividend past int64 at that scale wrapped and gave a wrong
  remainder (123456789012 % 1.5 at scale 10 gave -0.8539958272). It goes
  through the checked operator now (ops/checked.py, "mod"): the truncated
  remainder computed in 128 bits, int64 kept where the bounds prove it.
- C29: a cast from DOUBLE (REAL) to DECIMAL rounded the binary value at the
  target scale (the double 0.285 gave 0.28). PostgreSQL first prints the
  value to 15 (6) significant digits, then rounds half away from zero at
  the scale: 0.29 ("cast_f").

The statements live in lingodb_tpu_torch/tools/sqlite_battery.py
(MOD_CAST_STATEMENTS) over mc(k, g, a, b, c, e, d, i, f, r, h) and mdim(g,
label). The oracle is sqlite3 over the same rows with its decimals held as
text and computed by Python's decimal module (exact_functions: dmod, ddiv,
dcastf), or PostgreSQL's words. The JAX package shares both faults and is no
oracle here. On the tensor tier the aggregates, chains and TopK epilogues
run as the fused programs."""

import math
import re
import sqlite3

import numpy as np
import pytest
import torch

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import checked as ck
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.ops import scalar as sc
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_battery as sb

TIERS = [dv.SMALL_ROWS, 2]
STATEMENTS = sb.MOD_CAST_STATEMENTS


@pytest.fixture(scope="module")
def engines():
    conn = sqlite3.connect(":memory:")
    sb.exact_functions(conn)
    for st in sb.mod_cast_setup(sqlite=True):
        conn.execute(st)
    old = pgather.FORCE_KERNELS, dv.SMALL_ROWS
    pgather.FORCE_KERNELS = True
    ps = {}
    for small_rows in TIERS:
        dv.SMALL_ROWS = small_rows  # read when a column is first uploaded
        ps[small_rows] = ldb.create_in_memory(device="cpu")
        for st in sb.mod_cast_setup():
            ps[small_rows].sql_stmt(st)
    pgather.FORCE_KERNELS, dv.SMALL_ROWS = old
    yield ps, conn
    conn.close()


_tables = iter(range(1 << 30))


def _run(s, sql):
    """The statement's rows; a tuple runs its first entries as statements
    over a fresh table {t}."""
    if isinstance(sql, str):
        return s.sql(sql)
    t = f"mct_{next(_tables)}"
    for st in sql[:-1]:
        s.sql_stmt(st.format(t=t))
    return s.sql(sql[-1].format(t=t))


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_is_exact(engines, name, small_rows, monkeypatch):
    ps, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    monkeypatch.setattr(pgather, "FORCE_KERNELS", True)
    sql, oracle = STATEMENTS[name]
    s = ps[small_rows]
    if isinstance(oracle, sb.Raises):
        with pytest.raises(sc.EvalError, match=f"^{re.escape(oracle)}$"):
            _run(s, sql)
        return
    calls = []
    orig = ck.checked_arith

    def spy(op, *a, **k):
        calls.append(op)
        return orig(op, *a, **k)

    monkeypatch.setattr(sc.ckd, "checked_arith", spy)
    res = _run(s, sql)
    ok, msg = sb.exact_equal(sb.exact_rows(res), conn.execute(oracle).fetchall())
    assert ok, f"{sql}: {msg}"
    if name in sb.MOD_CAST_UNCHECKED:
        assert "mod" not in calls, sql


def test_the_issue_s_rows(engines, monkeypatch):
    """The rows of the report, spelled out on both tiers."""
    ps, _conn = engines
    for small_rows in TIERS:
        monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
        s = ps[small_rows]
        got = s.sql("SELECT a % b, i % c FROM mc WHERE k < 2 ORDER BY k")
        assert got.format_rows() == [["0.0000000000", "60516.00"],
                                     ["0.0000000000", "-9000000.00"]]
        got = s.sql("SELECT CAST(f AS DECIMAL(12,2)), "
                    "CAST(r AS DECIMAL(12,2)) FROM mc WHERE k < 3 ORDER BY k")
        assert got.format_rows() == [["0.29", "2.68"], ["1.01", "0.29"],
                                     ["2.68", "1.01"]]


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_no_host_array_meets_a_tensor(engines, name, monkeypatch):
    """On the tensor tier the exact host path's results never meet a tensor
    in a numpy operation (on the card numpy cannot read a CUDA tensor):
    numpy is refused every tensor here, as on the card."""
    ps, _conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    monkeypatch.setattr(pgather, "FORCE_KERNELS", True)

    def refused(self, *a, **k):
        raise TypeError("a tensor read by numpy")

    monkeypatch.setattr(torch.Tensor, "__array__", refused)
    sql, oracle = STATEMENTS[name]
    s = ps[2]
    s.stage_cache.clear()  # the first run, with its run on the exact path
    for _run_ in range(2):
        if isinstance(oracle, sb.Raises):
            with pytest.raises(sc.EvalError, match=re.escape(oracle)):
                _run(s, sql)
        else:
            _run(s, sql)


# grouped aggregates of a checked %, float casts and a cast whose rows pass
# int64 (the exact path), streamed
STREAMED = {
    "sum_mod": ("SELECT s, sum(a % b), count(*) FROM mc GROUP BY s "
                "ORDER BY s",
                "SELECT s, dsum(dmod(a, b)), count(*) FROM mc GROUP BY s "
                "ORDER BY s"),
    "sum_bigint_mod_price": (
        "SELECT s, sum(i % c) FROM mc GROUP BY s ORDER BY s",
        "SELECT s, dsum(dmod(i, c)) FROM mc GROUP BY s ORDER BY s"),
    "sum_cast_double": (
        "SELECT s, sum(CAST(f AS DECIMAL(15,2))) FROM mc GROUP BY s "
        "ORDER BY s",
        "SELECT s, dsum(dcastf(f, 15, 2)) FROM mc GROUP BY s ORDER BY s"),
    "sum_cast_real": (
        "SELECT s, sum(CAST(r AS DECIMAL(15,3))) FROM mc GROUP BY s "
        "ORDER BY s",
        "SELECT s, dsum(dcastf(r, 6, 3)) FROM mc GROUP BY s ORDER BY s"),
    "sum_cast_past_int64": (
        "SELECT s, sum(CAST(h AS DECIMAL(19,0))) FROM mc GROUP BY s "
        "ORDER BY s",
        "SELECT s, dsum(dcastf(h, 15, 0)) FROM mc GROUP BY s ORDER BY s"),
}


@pytest.mark.parametrize("name", list(STREAMED))
def test_streamed_aggregate_is_exact(engines, name, monkeypatch):
    """The out-of-core aggregate (its chunk program) over a budget the table
    exceeds gives the oracle's rows: a checked % and a float cast inside
    the chunk program, and a cast whose rows pass int64 on the exact
    path."""
    from lingodb_tpu_torch.utils import settings

    ps, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    s = ps[2]
    sql, oracle = STREAMED[name]
    old = settings.DEVICE_BYTE_BUDGET.get()
    settings.DEVICE_BYTE_BUDGET.set("1000")
    try:
        s.executor.last_chunked = None
        res = s.sql(sql)
        assert s.executor.last_chunked is not None, "nothing streamed"
    finally:
        settings.DEVICE_BYTE_BUDGET.set(str(old))
    ok, msg = sb.exact_equal(sb.exact_rows(res), conn.execute(oracle).fetchall())
    assert ok, f"{sql}: {msg}"


# ------------------------------------------------------------ the operator
INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1
MOD_EDGES = [  # (x, y) pairs
    (INT64_MIN, -1), (INT64_MIN, 1), (INT64_MAX, -1), (INT64_MAX, 10**18),
    (-INT64_MAX, 10**18), (999999999999999999, 7), (123456789012, 15),
    (-987654321, 225), (9 * 10**18, 150), (-9 * 10**18, 12345678), (5, 0),
    (0, 0), (0, INT64_MIN), (INT64_MAX, INT64_MAX), (INT64_MIN, INT64_MIN),
    (INT64_MAX, 2), (-7, 2), (7, -2), (1, INT64_MAX)]
# (sx, sy, s): scales of the operands and of the result
MOD_SCALES = {"same": (0, 0, 0), "dividend_up_10": (0, 10, 10),
              "divisor_up_18": (18, 0, 18), "both_up": (2, 4, 6),
              "divisor_up_1": (0, 1, 1)}


@pytest.mark.parametrize("scales", list(MOD_SCALES))
def test_plain_mod_equals_python_decimal(scales):
    """checked_arith_plain's mod against Python's decimal: the truncated
    remainder of the operands at the result's scale, the dividend's sign, 0
    for a divisor of 0, every row's value and code (a remainder past int64
    marks its row) on random rows of several magnitudes and on the edges
    (INT64_MIN % -1, +-(2^63 - 1) rescaled by 10^18, a remainder at exactly
    2^63 - 1), NULL rows included, a column against a scalar too."""
    from decimal import Context, Decimal

    sx, sy, s = MOD_SCALES[scales]
    ctx = Context(prec=200)
    rng = np.random.default_rng(len(scales))
    cols = [rng.integers(-top, top, 300, dtype=np.int64)
            for top in (1 << 15, 1 << 40, 1 << 62, 1 << 63)]
    xs = np.concatenate(cols + [np.array([e[0] for e in MOD_EDGES], np.int64)])
    ys = np.concatenate([rng.permutation(xs[:-len(MOD_EDGES)]) >>
                         rng.integers(0, 60, len(xs) - len(MOD_EDGES)),
                         np.array([e[1] for e in MOD_EDGES], np.int64)])
    valid = rng.random(len(xs)) > 0.1

    def want(x, y, live):
        if y == 0:
            return 0, 0
        r = ctx.remainder(Decimal(x).scaleb(-sx), Decimal(y).scaleb(-sy))
        r = int(r.scaleb(s, context=ctx))
        if not INT64_MIN <= r <= INT64_MAX:
            return 0, 7 if live else 0
        return r, 0

    value, code = ck.checked_arith("mod", torch.from_numpy(xs),
                                   torch.from_numpy(ys),
                                   torch.from_numpy(valid), sx, sy, s,
                                   INT64_MIN, INT64_MAX, 7)
    expect = [want(x, y, v) for x, y, v in zip(xs.tolist(), ys.tolist(),
                                               valid.tolist())]
    assert value.tolist() == [v for v, _c in expect]
    assert code.tolist() == [c for _v, c in expect]
    for y in (15, -10**18, 0, INT64_MAX):
        value, code = ck.checked_arith("mod", xs, np.asarray(y), None, sx, sy,
                                       s, INT64_MIN, INT64_MAX, 7)
        expect = [want(x, y, True) for x in xs.tolist()]
        assert isinstance(value, np.ndarray)
        assert value.tolist() == [v for v, _c in expect]
        assert code.tolist() == [c for _v, c in expect]
    if s - sx and s - sy:  # both rescaled: a remainder past int64 marks
        big = (INT64_MAX, INT64_MAX - 1)
        _v, c = ck.checked_arith("mod", torch.tensor([big[0]]),
                                 torch.tensor([big[1]]), None, sx, sy, s,
                                 INT64_MIN, INT64_MAX, 7)
        assert c.tolist() == [want(*big, True)[1]]


CAST_F_EDGES = [0.285, 1.005, 2.675, 99.995, -0.125, 0.0, -0.0,
                0.004999999999999999, 0.005, 5e-324, 2.2250738585072014e-308,
                2.0**53 - 1, 2.0**53, 2.0**53 + 2, 9.2e18, -9.2e18, 9.3e18,
                9.223372036854775e18, 1e38, 1e300, 0.5, 1.5, 2.5, 12345.675,
                999999999999999.5, 1000000000000000.5, 1e-19, 4e-19,
                math.nan, math.inf, -math.inf]
# (float dtype, digits, scale, precision)
CAST_F_CASES = {"double_2": (torch.float64, 15, 2, 12),
                "double_0": (torch.float64, 15, 0, 19),
                "double_18": (torch.float64, 15, 18, 38),
                "double_4_2": (torch.float64, 15, 2, 4),
                "real_2": (torch.float32, 6, 2, 12),
                "real_6": (torch.float32, 6, 6, 18)}


@pytest.mark.parametrize("case", list(CAST_F_CASES))
def test_plain_cast_f_equals_python_decimal(case):
    """checked_arith_plain's cast_f against Python's decimal:
    Decimal('%.15g' % v) (a real's '%.6g' of its float32 value) quantized
    half away from zero; "numeric field overflow" (code_prec) past the
    precision and for NaN and the infinities; the exact path's mark past
    int64; on random prices, values of every magnitude, values just below a
    power of ten and the edges (0.285, 1.005, 2.675, 99.995, a subnormal,
    2^53 +- 1, 9.2 * 10^18 and past it)."""
    from decimal import ROUND_HALF_UP, Context, Decimal

    dtype, digits, s, prec = CAST_F_CASES[case]
    ctx = Context(prec=500, Emax=10**6, Emin=-10**6)
    rng = np.random.default_rng(len(case) + s)
    near_powers = [float(np.nextafter(10.0**k, 0)) for k in range(-20, 39)]
    xs = np.concatenate([
        np.round(rng.uniform(-1e5, 1e5, 500), 3),
        rng.standard_normal(500) * 10.0 ** rng.integers(-20, 25, 500),
        (rng.integers(-10**6, 10**6, 300) + 0.5) / 10.0 ** rng.integers(
            0, 8, 300),
        np.array(near_powers + CAST_F_EDGES)])
    with np.errstate(over="ignore"):
        x = torch.from_numpy(xs).to(dtype)
    valid = torch.from_numpy(rng.random(len(xs)) > 0.05)

    def want(v, live):
        if not math.isfinite(v):
            return 0, 9 if live else 0
        d = Decimal(f"%.{digits}g" % v).scaleb(s, context=ctx)
        r = int(d.quantize(Decimal(1), rounding=ROUND_HALF_UP, context=ctx))
        if abs(r) >= 10**prec:
            return 0, 9 if live else 0
        if not INT64_MIN <= r <= INT64_MAX:
            return 0, 7 if live else 0
        return r, 0

    value, code = ck.checked_arith("cast_f", x, None, valid, 0, 0, s,
                                   INT64_MIN, INT64_MAX, 7, prec, 9,
                                   torch.int64, digits)
    expect = [want(v, live) for v, live in zip(x.tolist(), valid.tolist())]
    assert value.tolist() == [v for v, _c in expect]
    assert code.tolist() == [c for _v, c in expect]
    # as a real is stored (float32), rounded the same through numpy
    value, code = ck.checked_arith("cast_f", x.numpy(), None, None, 0, 0, s,
                                   INT64_MIN, INT64_MAX, 7, prec, 9,
                                   torch.int64, digits)
    assert value.tolist() == [want(v, True)[0] for v in x.tolist()]


def test_the_two_forms_refuse_what_the_kernel_cannot_take():
    """A remainder never scales an operand down, cast_f takes a precision
    and 1..17 digits (the operators send the rest to the exact host path
    first)."""
    x = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        ck.checked_arith("mod", x, x, None, 4, 0, 2, INT64_MIN, INT64_MAX, 1)
    with pytest.raises(ValueError):
        ck.checked_arith("mod", x, x, None, 0, 0, 19, INT64_MIN, INT64_MAX, 1)
    f = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        ck.checked_arith("cast_f", f, None, None, 0, 0, 2, INT64_MIN,
                         INT64_MAX, 1, 0, 3, torch.int64, 15)
    with pytest.raises(ValueError):
        ck.checked_arith("cast_f", f, None, None, 0, 0, 2, INT64_MIN,
                         INT64_MAX, 1, 12, 3, torch.int64, 0)
    with pytest.raises(ValueError):
        ck.checked_arith("cast_f", f, f, None, 0, 0, 2, INT64_MIN,
                         INT64_MAX, 1, 12, 3, torch.int64, 15)


def test_bounds_prove_a_remainder_that_fits():
    """ops/bounds.py bounds a remainder by its divisor and its dividend:
    d % 0.07 over a DECIMAL(18,2) fits int64 (no check), i % 1.5 over a
    BIGINT does not (checked)."""
    from lingodb_tpu_torch.ops import bounds

    d18 = (-(10**18), 10**18)
    assert bounds.fits("mod", d18, (7, 7), 2, 2, 2, INT64_MIN, INT64_MAX)
    r, _m = bounds.arith_bound("mod", (-50, 100), (7, 7), 0, 0, 0)
    assert r == (-6, 6)
    r, _m = bounds.arith_bound("mod", (3, 5), (-100, 100), 0, 0, 0)
    assert r == (0, 5)
    big = (INT64_MIN, INT64_MAX)
    assert not bounds.fits("mod", big, (15, 15), 0, 1, 1, INT64_MIN,
                           INT64_MAX)
