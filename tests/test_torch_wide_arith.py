"""Arithmetic past int64, exact as PostgreSQL gives it, on both storage
tiers:

- C24: DECIMAL products (and their sums) whose values pass int64. The host
  tier computes them exactly; the tensor tier wrapped in int64 (the JAX
  package still does). The port's checked kernel (ops/checked.py) marks such
  rows and the statement runs again with the expression on the exact host
  path.
- C25: sum and avg of a BIGINT are PostgreSQL numerics (DECIMAL(38, 0) and
  the numeric quotient here); they wrapped in int64 on both tiers.
- C26: a cast to DECIMAL(p, s) past the precision raises "numeric field
  overflow"; it kept the value.

The statements live in lingodb_tpu_torch/tools/sqlite_battery.py
(WIDE_STATEMENTS) over wide(k, g, x, e, p, d, b, n, f, s) and wdim(g,
label).
The oracle is sqlite3 over the same rows with its decimals held as text and
computed exactly by Python's decimal module (exact_functions), or
PostgreSQL's words; the C24 statements (WIDE_JAX_EXACT) are also held
against the JAX package's host tier, exact there. On the tensor tier the
aggregates, chains and TopK epilogues run as the fused programs."""

import re
import sqlite3
from decimal import Decimal

import numpy as np
import pytest
import torch

import lingodb_tpu as ref_ldb
import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import checked as ck
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.ops import scalar as sc
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.sql.types import K
from lingodb_tpu_torch.tools import sqlite_battery as sb

TIERS = [dv.SMALL_ROWS, 2]
STATEMENTS = sb.WIDE_STATEMENTS


@pytest.fixture(scope="module")
def engines():
    conn = sqlite3.connect(":memory:")
    sb.exact_functions(conn)
    for st in sb.wide_setup(sqlite=True):
        conn.execute(st)
    old = pgather.FORCE_KERNELS, dv.SMALL_ROWS
    pgather.FORCE_KERNELS = True
    ps = {}
    for small_rows in TIERS:
        dv.SMALL_ROWS = small_rows  # read when a column is first uploaded
        ps[small_rows] = ldb.create_in_memory(device="cpu")
        for st in sb.wide_setup():
            ps[small_rows].sql_stmt(st)
    pgather.FORCE_KERNELS, dv.SMALL_ROWS = old
    rs = ref_ldb.create_in_memory()  # the JAX package's host tier
    for st in sb.wide_setup():
        rs.sql_stmt(st)
    yield ps, rs, conn
    conn.close()


ours, same = sb.exact_rows, sb.exact_equal


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_is_exact(engines, name, small_rows, monkeypatch):
    ps, rs, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    monkeypatch.setattr(pgather, "FORCE_KERNELS", True)
    sql, oracle = STATEMENTS[name]
    s = ps[small_rows]
    if isinstance(oracle, sb.Raises):
        with pytest.raises(sc.EvalError, match=f"^{re.escape(oracle)}$"):
            s.sql(sql)
        return
    res = s.sql(sql)
    ok, msg = same(ours(res), conn.execute(oracle).fetchall())
    assert ok, f"{sql}: {msg}"
    if name in sb.WIDE_JAX_EXACT:
        assert res.format_rows() == rs.sql(sql).format_rows(), sql
    if name in sb.WIDE_NO_RERUN:
        assert s.executor.last_exact_reruns == 0, sql
    if name == "sum_int_stays_bigint":
        assert res.types[0].kind == K.BIGINT
    if name == "sum_bigint":
        assert (res.types[0].kind, res.types[0].p, res.types[0].s) == (
            K.DECIMAL, 38, 0)


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_no_host_array_meets_a_tensor(engines, name, monkeypatch):
    """On the tensor tier the exact host path's results (object columns,
    their host validity, a comparison's flags) never meet a tensor in a
    numpy operation: on the card numpy cannot read a CUDA tensor and the
    statement would raise. Here numpy is refused every tensor, as on the
    card."""
    ps, _rs, _conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    monkeypatch.setattr(pgather, "FORCE_KERNELS", True)

    def refused(self, *a, **k):
        raise TypeError("a tensor read by numpy")

    monkeypatch.setattr(torch.Tensor, "__array__", refused)
    sql, oracle = STATEMENTS[name]
    s = ps[2]
    s.stage_cache.clear()  # the first run, with its run on the exact path
    for _run in range(2):
        if isinstance(oracle, sb.Raises):
            with pytest.raises(sc.EvalError, match=re.escape(oracle)):
                s.sql(sql)
        else:
            s.sql(sql)


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
def test_prices_cubed_and_bigint_sums_near_2_62(small_rows, monkeypatch):
    """e * e * e over DECIMAL(12,2) prices near 123456.78 and sum(b) over
    eight BIGINTs 2^62 + k: PostgreSQL's digits on both tiers."""
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    s = ldb.create_in_memory(device="cpu")
    s.sql_stmt("CREATE TABLE big(k INT, e DECIMAL(12,2), b BIGINT)")
    s.sql_stmt("INSERT INTO big VALUES " + ", ".join(
        f"({k}, {123456.78 + k:.2f}, {(1 << 62) + k})" for k in range(8)))
    got = s.sql("SELECT e * e * e FROM big ORDER BY k").format_rows()
    assert got[0] == ["1881675960266558.605752"]
    got = s.sql("SELECT sum(e * e * e), sum(b), avg(b) FROM big").format_rows()
    assert got[0][:2] == ["15054688026413449.791616", "36893488147419103260"]
    assert Decimal(got[0][2]) == Decimal("4611686018427387907.5")
    run = s.sql("SELECT k, sum(b) OVER (ORDER BY k) FROM big ORDER BY k")
    assert [int(r[1]) for r in run.format_rows()] == [
        sum((1 << 62) + j for j in range(k + 1)) for k in range(8)]
    with pytest.raises(sc.EvalError, match="^numeric field overflow$"):
        s.sql("SELECT CAST(12345.678 AS DECIMAL(5,2))")


def test_a_later_run_goes_exact_at_once(monkeypatch):
    """The statement that marked rows runs again exactly, once; the plan
    keeps the decision in the session's stage cache, so the next run of the
    same statement goes exact with no second run."""
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    s = ldb.create_in_memory(device="cpu")
    for st in sb.wide_setup(rows=40):
        s.sql_stmt(st)
    sql = "SELECT g, sum(e * e * e) FROM wide GROUP BY g ORDER BY g"
    first = s.sql(sql).format_rows()
    assert s.executor.last_exact_reruns == 1
    assert any(k[0] == "exact_arith" for k in s.stage_cache if
               isinstance(k, tuple))
    assert s.sql(sql).format_rows() == first
    assert s.executor.last_exact_reruns == 0


# ------------------------------------------------------------ the mesh
@pytest.fixture(scope="module")
def mesh_session():
    from lingodb_tpu_torch.parallel import mesh as msh
    from lingodb_tpu_torch.utils import settings

    old = dv.SMALL_ROWS, (dv._MESH, dv._MESH_INIT)
    dv.SMALL_ROWS = 2
    settings.set_setting("system.shuffle_min_rows", 2)
    s = ldb.create_in_memory(device="cpu")
    for st in sb.wide_setup():
        s.sql_stmt(st)
    yield s, msh.Mesh(["cpu"] * 8)
    dv.SMALL_ROWS = old[0]
    dv._MESH, dv._MESH_INIT = old[1]
    settings.SHUFFLE_MIN_ROWS.reset()


@pytest.mark.parametrize("sql,oracle,sharded", [
    ("SELECT k % 40 AS r, sum(b), count(b) FROM wide GROUP BY k % 40 "
     "ORDER BY r",
     "SELECT k % 40 AS r, dsum(b), count(b) FROM wide GROUP BY k % 40 "
     "ORDER BY r", True),
    ("SELECT k % 40 AS r, sum(DISTINCT b) FROM wide GROUP BY k % 40 "
     "ORDER BY r",
     "SELECT k % 40 AS r, dsum(DISTINCT b) FROM wide GROUP BY k % 40 "
     "ORDER BY r", False),
    ("SELECT k % 40 AS r, sum(e * e * e) FROM wide GROUP BY k % 40 "
     "ORDER BY r",
     "SELECT k % 40 AS r, dsum(dmul(dmul(e, e), e)) FROM wide "
     "GROUP BY k % 40 ORDER BY r", False)],
    ids=["sum_bigint", "sum_distinct_bigint", "sum_cube"])
def test_sharded_aggregate_is_exact(engines, mesh_session, sql, oracle,
                                    sharded, monkeypatch):
    """On a mesh of 8 positions the sharded aggregate's two rounds (a local
    pre-aggregation, an exchange of the partial groups, a second grouping)
    sum a BIGINT past int64 exactly, as its 32-bit limbs; a wide distinct
    sum, and a product the exact host path holds, take the local path."""
    from lingodb_tpu_torch.ops import groupby as gb
    from lingodb_tpu_torch.parallel import shuffle as sh

    s, mesh = mesh_session
    _ps, _rs, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    monkeypatch.setattr(dv, "_MESH", mesh)
    monkeypatch.setattr(dv, "_MESH_INIT", True)
    monkeypatch.setattr(gb, "DENSE_DOMAIN_LIMIT", 2)
    groupbys = sh.STATS["groupbys"]
    ok, msg = same(ours(s.sql(sql)), conn.execute(oracle).fetchall())
    assert ok, f"{sql}: {msg}"
    if sharded:
        assert sh.STATS["groupbys"] > groupbys, "the sharded aggregate did not run"


# ------------------------------------------------------------ streamed
STREAMED = {
    "sum_cube": ("SELECT s, sum(e * e * e), count(*) FROM wide GROUP BY s "
                 "ORDER BY s",
                 "SELECT s, dsum(dmul(dmul(e, e), e)), count(*) FROM wide "
                 "GROUP BY s ORDER BY s"),
    "sum_bigint": ("SELECT s, sum(b), count(b) FROM wide GROUP BY s "
                   "ORDER BY s",
                   "SELECT s, dsum(b), count(b) FROM wide GROUP BY s "
                   "ORDER BY s"),
    "variance_by_hand": (
        "SELECT s, sum((p - 38000.123456) * (p - 38000.123456)) FROM wide "
        "WHERE k > 3 GROUP BY s ORDER BY s",
        "SELECT s, dsum(dmul(dsub(p, '38000.123456'), dsub(p, "
        "'38000.123456'))) FROM wide WHERE k > 3 GROUP BY s ORDER BY s"),
}


@pytest.mark.parametrize("name", list(STREAMED))
def test_streamed_aggregate_is_exact(engines, name, monkeypatch):
    """The out-of-core aggregate (its chunk program) over a budget the table
    exceeds gives the exact sums too: a BIGINT's in its limb lanes, a
    product past int64 on the exact host path's lanes."""
    from lingodb_tpu_torch.utils import settings

    ps, _rs, conn = engines
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
    ok, msg = same(ours(res), conn.execute(oracle).fetchall())
    assert ok, f"{sql}: {msg}"


# ------------------------------------------------------------ the operator
INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1
EDGES = [0, 1, -1, 2, -2, INT64_MAX, INT64_MIN, INT64_MAX - 1, INT64_MIN + 1,
         3037000499, -3037000499, 3037000500, 10**18, -10**18,
         (1 << 31) - 1, -(1 << 31), 1 << 31, 4999999999999999999,
         9223372036854775, 922337203685477580, 5, -5, 49, 50, -50, 99]
# (op, sx, sy, s, lo, hi, prec, out_dtype): INT and BIGINT arithmetic, a
# decimal product that rounds, a sum that rescales, casts to an INT and to
# DECIMAL(p, s) (up and down)
CASES = {
    "int_add": ("add", 0, 0, 0, -(1 << 31), (1 << 31) - 1, 0, torch.int32),
    "bigint_mul": ("mul", 0, 0, 0, INT64_MIN, INT64_MAX, 0, torch.int64),
    "bigint_sub": ("sub", 0, 0, 0, INT64_MIN, INT64_MAX, 0, torch.int64),
    "decimal_mul_rounds": ("mul", 4, 6, 6, INT64_MIN, INT64_MAX, 0,
                           torch.int64),
    "decimal_add_rescales": ("add", 2, 6, 6, INT64_MIN, INT64_MAX, 0,
                             torch.int64),
    "decimal_sub_down": ("sub", 8, 2, 4, INT64_MIN, INT64_MAX, 0,
                         torch.int64),
    "cast_to_int": ("cast", 2, 0, 0, -(1 << 31), (1 << 31) - 1, 0,
                    torch.int32),
    "cast_up_precision": ("cast", 2, 0, 12, INT64_MIN, INT64_MAX, 20,
                          torch.int64),
    "cast_down_precision": ("cast", 6, 0, 2, INT64_MIN, INT64_MAX, 7,
                            torch.int64),
}


def _python(op, xs, ys, valid, sx, sy, s, lo, hi, prec):
    vals, codes = [], []
    for i, x in enumerate(xs):
        r = ck.exact_result(op, x, None if ys is None else ys[i], sx, sy, s)
        v, c = ck.classify(r, lo, hi, 7, prec, 9)
        vals.append(v)
        codes.append(c if valid is None or valid[i] else 0)
    return vals, codes


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_equals_python_ints(name):
    """checked_arith_plain against Python ints, value and code of every row,
    on random rows of several magnitudes and on the edges (INT64_MIN,
    +-(2^63 - 1), products at the bound, rescales that round across it),
    NULL rows included, a column against a column and against a scalar."""
    op, sx, sy, s, lo, hi, prec, dt = CASES[name]
    rng = np.random.default_rng(len(name))
    cols = []
    for top in (1 << 15, 1 << 31, 1 << 40, 1 << 62, 1 << 63):
        cols.append(rng.integers(-top, top, 400, dtype=np.int64, endpoint=False))
    xs = np.concatenate(cols + [np.array(EDGES, np.int64)])
    ys = np.concatenate([rng.permutation(xs[:-len(EDGES)]),
                         np.array(EDGES[::-1], np.int64)])
    valid = rng.random(len(xs)) > 0.1
    y_t = None if op == "cast" else torch.from_numpy(ys)
    value, code = ck.checked_arith(op, torch.from_numpy(xs), y_t,
                                   torch.from_numpy(valid), sx, sy, s, lo,
                                   hi, 7, prec, 9, dt)
    want_v, want_c = _python(op, xs.tolist(),
                             None if op == "cast" else ys.tolist(),
                             valid.tolist(), sx, sy, s, lo, hi, prec)
    assert value.dtype == dt and code.dtype == torch.int32
    assert value.tolist() == want_v
    assert code.tolist() == want_c
    if op != "cast":  # a scalar operand, broadcast over the rows
        for y in (EDGES[5], EDGES[6], 3037000500, -7):
            value, code = ck.checked_arith(
                op, torch.from_numpy(xs), torch.tensor(y), None, sx, sy, s,
                lo, hi, 7, prec, 9, dt)
            want_v, want_c = _python(op, xs.tolist(), [y] * len(xs), None,
                                     sx, sy, s, lo, hi, prec)
            assert value.tolist() == want_v and code.tolist() == want_c


def test_plain_version_takes_numpy_and_int32():
    """Host-tier operands (numpy, int32) give numpy results, the same."""
    x = np.array([1 << 30, -(1 << 30), 7], np.int32)
    y = np.array([4, 4, 7], np.int32)
    v, c = ck.checked_arith("mul", x, y, None, 0, 0, 0, -(1 << 31),
                            (1 << 31) - 1, sc.ERR_INT, 0, 0, torch.int32)
    assert isinstance(v, np.ndarray) and v.tolist() == [0, 0, 49]
    assert c.tolist() == [sc.ERR_INT, sc.ERR_INT, 0]


def test_kernel_route_refuses_what_it_cannot_hold():
    """Shifts past 18 digits and a product scaled up are refused (the
    operators send them to the exact host path first)."""
    x = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        ck.checked_arith("cast", x, None, None, 0, 0, 19, INT64_MIN,
                         INT64_MAX, 1)
    with pytest.raises(ValueError):
        ck.checked_arith("mul", x, x, None, 1, 1, 3, INT64_MIN, INT64_MAX, 1)


def test_bounds_prove_tpch_s_products():
    """ops/bounds.py over TPC-H q1 and q11: q1's charge is proved by the
    columns' bounds (|price| <= 1.05 * 10^7 unscaled, |1 - d| <= 100, |1 +
    t| <= 108), and q11's sum over partsupp joined to supplier and nation on
    their declared keys holds at most partsupp's rows, so its sum scaled by
    10^4 is proved too: no checked operator, no code."""
    from lingodb_tpu_torch.ops import bounds
    from lingodb_tpu_torch.plan import logical as L
    from lingodb_tpu_torch.tools import tpchgen

    s = ldb.create_in_memory(device="cpu")
    tpchgen.install(s, tpchgen.generate(0.01, 19920601))
    rows = {t: s.catalog.get_table(t).storage.num_rows
            for t in ("lineitem", "partsupp")}

    def plan_bounds(q):
        plan = s.prepare(open(f"queries/tpch/{q}.sql").read()).plan
        pb = bounds.PlanBounds(
            plan, s.column_bounds,
            lambda t: s.catalog.get_table(t).storage.num_rows, s.catalog)
        return plan, pb

    def nodes(n):
        yield n
        for c in n.children():
            yield from nodes(c)
        if isinstance(n, L.Tmp):
            yield from nodes(n.holder.plan)

    plan, pb = plan_bounds("1")
    price = s.column_bounds("lineitem", "l_extendedprice")
    assert price[1] <= 105 * 10**5
    from lingodb_tpu_torch.plan import exprs as E

    products = [x for n in nodes(plan) if isinstance(n, L.Map)
                for _info, e in n.computed for x in E.walk(e)
                if isinstance(x, E.Call) and x.op in ("add", "sub", "mul")]
    assert len(products) >= 3  # 1 - d, price * (1 - d), its * (1 + t)
    for x in products:
        b = pb.expr(x)
        assert b is not None and max(abs(b[0]), abs(b[1])) < 2**63, x
    plan, pb = plan_bounds("11")
    aggs = [n for n in nodes(plan) if isinstance(n, L.Aggregate)]
    assert aggs and all(pb.rows(a.children()[0]) <= rows["partsupp"]
                        for a in aggs)
    calls = []
    orig = ck.checked_arith

    def spy(*a, **k):
        calls.append(a[0])
        return orig(*a, **k)

    import lingodb_tpu_torch.ops.scalar as scalar_mod

    old = scalar_mod.ckd.checked_arith
    scalar_mod.ckd.checked_arith = spy
    try:
        for q in ("1", "11", "14"):
            s.sql(open(f"queries/tpch/{q}.sql").read())
    finally:
        scalar_mod.ckd.checked_arith = old
    assert not calls, calls
