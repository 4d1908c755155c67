"""User-defined functions in the port (runtime/udf.py, runtime/sandbox.py,
catalog.compile_function, the udf: branch of ops/scalar.py and the fused
programs' decline), held against the JAX package on the same inputs.

The tables are made from a seed with numpy and inserted by the same SQL
text into both engines; `format_rows()` must be equal string for string.
The port runs on device="cpu" with its tables on the tensor tier (64 rows
and more), so a UDF's arguments are tensors read back to the host and its
result goes back to the arguments' device, as on the card.
"""

import numpy as np
import pytest

import lingodb_tpu as ref_ldb
import lingodb_tpu.runtime.executor as ref_ex
from lingodb_tpu.runtime import device as ref_dv
from lingodb_tpu.runtime import sandbox as ref_sandbox
from lingodb_tpu.tools import tpchgen as ref_tpchgen
from lingodb_tpu.utils import settings as ref_settings

import lingodb_tpu_torch as ldb
import lingodb_tpu_torch.runtime.executor as ex
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.runtime import sandbox
from lingodb_tpu_torch.tools import carry, tpchgen
from lingodb_tpu_torch.utils import settings

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

SEED = 20261018
ROWS = 300
ENTRY_POINTS = ("_try_fused_agg", "_try_fused_topk", "_try_fused_chain")

# the same functions in both engines: a vectorisable Python body, one with
# a per-row fallback (str methods), DATE and string arguments, and a C body
FUNCTIONS = [
    "create function pscale(x bigint, y double) returns double as $$\n"
    "def pscale(x, y):\n    return x * 0.5 + y\n$$ language python",
    "create function pyear(d date) returns int as $$\n"
    "def pyear(d):\n    return d.year\n$$ language python",
    "create function pupper(s varchar) returns varchar as $$\n"
    "def pupper(s):\n    return s.upper() + '!'\n$$ language python",
    "create function cmix(x int, y double) returns double language c as "
    "$$ return x * 2.0 + y; $$",
]
QUERIES = {
    "project": "select i, pscale(v, w), pyear(dt), pupper(s), cmix(i, w) "
               "from t order by i",
    "where": "select i, v from t where pscale(v, w) > 40 and cmix(i, w) < 400 "
             "order by i",
    "aggregate": "select pyear(dt) as y, count(*), sum(cmix(i, w)), "
                 "max(pupper(s)) from t group by pyear(dt) order by y",
    "nulls": "select count(pscale(v, w)), count(*) from t where v is null",
}


def _table_sql() -> list:
    rng = np.random.default_rng(SEED)
    v = rng.integers(-50, 200, ROWS)
    w = rng.normal(0, 10, ROWS).round(3)
    days = rng.integers(0, 3000, ROWS)
    words = np.array(["alpha", "beta", "gamma", "delta"], object)
    s = words[rng.integers(0, 4, ROWS)]
    nulls = rng.random(ROWS) < 0.1
    rows = []
    for i in range(ROWS):
        vv = "null" if nulls[i] else str(int(v[i]))
        d = np.datetime64("1995-01-01") + np.timedelta64(int(days[i]), "D")
        rows.append(f"({i}, {vv}, {float(w[i])!r}, '{s[i]}', '{d}')")
    return ["create table t (i int not null, v bigint, w double not null, "
            "s varchar(10) not null, dt date not null)",
            "insert into t values " + ", ".join(rows)]


@pytest.fixture(scope="module")
def sessions():
    """(reference session, port session) over the same table and
    functions, the port's table on the tensor tier."""
    old_rows, old_force = dv.SMALL_ROWS, pgather.FORCE_KERNELS
    dv.SMALL_ROWS, pgather.FORCE_KERNELS = 64, True
    rs = ref_ldb.create_in_memory()
    ps = ldb.create_in_memory(device="cpu")
    for stmt in _table_sql() + FUNCTIONS:
        rs.sql_stmt(stmt)
        ps.sql_stmt(stmt)
    yield rs, ps
    dv.SMALL_ROWS, pgather.FORCE_KERNELS = old_rows, old_force
    for worker in (ref_sandbox._GLOBAL_WORKER, sandbox._GLOBAL_WORKER):
        if worker is not None:
            worker.close()


def _isolation(mode):
    """system.udf_isolation of both engines."""
    ref_settings.UDF_ISOLATION.set(mode)
    settings.UDF_ISOLATION.set(mode)


@pytest.mark.parametrize("isolation", ["none", "process"])
@pytest.mark.parametrize("q", list(QUERIES))
def test_udf_rows_equal_reference(sessions, q, isolation):
    """Python UDFs in process and in the isolated worker, and a C UDF, in
    projections, filters, grouping keys, aggregate arguments and over NULL
    arguments: the port's rows equal the reference's."""
    rs, ps = sessions
    _isolation(isolation)
    try:
        want = rs.sql(QUERIES[q]).format_rows()
        got = ps.sql(QUERIES[q]).format_rows()
    finally:
        _isolation("none")
    assert got == want
    assert got


@pytest.fixture()
def iso_session():
    s = ldb.create_in_memory(device="cpu")
    s.sql_stmt("create table t (i int not null)")
    s.sql_stmt("insert into t values (1),(2),(3),(4)")
    s.sql_stmt("set udf_isolation = 'process'")
    yield s
    s.sql_stmt("set udf_isolation = 'none'")
    if sandbox._GLOBAL_WORKER is not None:
        sandbox._GLOBAL_WORKER.close()


def _ints(s, sql):
    return [r[0] for r in s.sql(sql).to_pylist()]


@pytest.mark.parametrize("case", ["crash", "exception", "recovery"])
def test_isolated_udf_failures_are_contained(iso_session, case):
    """The cases of the JAX package's tests/test_udf_isolation.py: a UDF
    that kills its worker or raises surfaces as an error, the engine keeps
    serving, and the worker comes back for the next call."""
    s = iso_session
    s.sql_stmt("create function ok(x int) returns int as $$\n"
               "def ok(x):\n    return x + 7\n$$ language python")
    if case == "crash":
        s.sql_stmt("create function boom(x int) returns int as $$\n"
                   "def boom(x):\n    import os\n    os._exit(3)\n"
                   "$$ language python")
        with pytest.raises(Exception, match="worker"):
            s.sql("select boom(i) from t")
    elif case == "exception":
        s.sql_stmt("create function bad(x int) returns int as $$\n"
                   "def bad(x):\n    raise ValueError('nope')\n"
                   "$$ language python")
        with pytest.raises(Exception, match="nope"):
            s.sql("select bad(i) from t")
    else:
        s.sql_stmt("create function sq(x int) returns int as $$\n"
                   "def sq(x):\n    return x ** 2\n$$ language python")
        assert _ints(s, "select sq(i) from t order by i") == [1, 4, 9, 16]
    assert s.sql("select count(*) from t").format_rows() == [["4"]]
    assert _ints(s, "select ok(i) from t order by i") == [8, 9, 10, 11]


def test_isolated_worker_imports_neither_torch_nor_the_packages(iso_session):
    """The worker runs numpy only: the engine's modules (and torch with its
    CUDA state) stay out of the process that runs user code."""
    s = iso_session
    s.sql_stmt(
        "create function heavy(x int) returns int as $$\n"
        "def heavy(x):\n    import sys\n"
        "    roots = {m.split('.')[0] for m in sys.modules}\n"
        "    bad = roots & {'torch', 'lingodb_tpu', 'lingodb_tpu_torch', 'jax'}\n"
        "    return np.full(len(x), len(bad))\n$$ language python")
    assert _ints(s, "select heavy(i) from t") == [0, 0, 0, 0]


@pytest.mark.parametrize("fmt", ["catalog", "reference"])
def test_persisted_udfs_reopen(tmp_path, fmt):
    """C and Python UDFs persist with the database (the port's catalog.json,
    or the reference's db.lingodb through export_reference) and compile
    again when it is opened through connect_to_db; the reopened rows equal
    the JAX package's over the same directory."""
    src = str(tmp_path / "src")
    s = ldb.connect_to_db(src, device="cpu")
    s.sql_stmt("create table ints (i int not null)")
    s.sql_stmt("insert into ints values (1),(2),(3)")
    s.sql_stmt("create function add_one(x int) returns int language c as "
               "$$ return x+1; $$")
    s.sql_stmt("create function py_dbl(x int) returns int as $$\n"
               "def py_dbl(x):\n    return x * 2\n$$ language python")
    if fmt == "catalog":
        s.close()
        db = src
    else:
        db = str(tmp_path / "ref")
        s.export_reference(db)
    q = "select add_one(i), py_dbl(i) from ints order by i"
    got = ldb.connect_to_db(db, device="cpu").sql(q).format_rows()
    assert got == [["2", "2"], ["3", "4"], ["4", "6"]]
    assert got == ref_ldb.connect_to_db(db).sql(q).format_rows()


# ---- the fused programs' engaged set on UDF queries, against the reference
TPCH_SF = 0.005
ENGAGE_FUNCTIONS = [
    "create function fq(x decimal(15,2)) returns double as $$\n"
    "def fq(x):\n    return x * 1.5\n$$ language python",
    "create function fk(x bigint) returns bigint as $$\n"
    "def fk(x):\n    return x * 2 + 1\n$$ language python",
    "create function fc(x int) returns int language c as $$ return x % 7; $$",
]
ENGAGE_QUERIES = {
    # in the WHERE under the aggregate: the program would evaluate it
    "where": "select l_returnflag, count(*) from lineitem where fq(l_quantity)"
             " > 30 group by l_returnflag order by l_returnflag",
    # in an aggregate's argument (a Map step of the spine)
    "argument": "select l_returnflag, sum(fq(l_quantity)) from lineitem "
                "group by l_returnflag order by l_returnflag",
    # above the aggregate: outside the program
    "above": "select l_returnflag, fk(count(*)) from lineitem group by "
             "l_returnflag order by l_returnflag",
    # on a dimension's filter: its build side runs eagerly, before the
    # program
    "build side": "select count(*), sum(l_quantity) from lineitem, orders "
                  "where l_orderkey = o_orderkey and fc(o_custkey) = 3",
    # a C UDF on the probe side of a join's key
    "probe key": "select count(*) from lineitem, orders where "
                 "fc(l_orderkey) = o_orderkey",
    # between a TopK and the aggregate below it: the epilogue declines, the
    # aggregate runs fused on its own
    "topk dense": "select l_suppkey, fk(count(*)) as c from lineitem group "
                  "by l_suppkey order by c desc, l_suppkey limit 5",
    "topk general": "select l_extendedprice, fk(count(*)) as c from lineitem"
                    " group by l_extendedprice order by c desc, "
                    "l_extendedprice limit 5",
    # between a TopK and a fused chain below it
    "topk chain": "select l_orderkey, fk(o_custkey) as c from lineitem, "
                  "orders where l_orderkey = o_orderkey and l_quantity < 3 "
                  "order by c desc, l_orderkey limit 4",
}
FUSED = ("above", "build side", "topk dense", "topk general")


def _extract(ref_tables) -> dict:
    out = {}
    for name, st in ref_tables.items():
        cols = []
        for cname, col in zip(st.column_names, st.columns):
            cols.append((cname, str(col.type), np.asarray(col.data),
                         None if col.valid is None else np.asarray(col.valid),
                         None if col.dictionary is None
                         else np.asarray(col.dictionary, dtype=object)))
        out[name] = {"columns": cols, "sorted_cols": tuple(st.sorted_cols)}
    return out


@pytest.fixture(scope="module")
def tpch_pair():
    """The reference on one device (no mesh, where its fused programs
    engage) and the port over the same TPC-H bytes, both with tables of 64
    rows and more on the device tier."""
    ref_settings.PARALLELISM.set("OFF")
    old_mesh = ref_dv._MESH, ref_dv._MESH_INIT
    ref_dv._MESH, ref_dv._MESH_INIT = None, True
    old_ref_rows, old_rows = ref_dv.SMALL_ROWS, dv.SMALL_ROWS
    old_force = pgather.FORCE_KERNELS
    ref_dv.SMALL_ROWS = dv.SMALL_ROWS = 64
    pgather.FORCE_KERNELS = True
    rs = ref_ldb.create_in_memory()
    carried = carry.tables_from_numpy(
        _extract(ref_tpchgen.load_into(rs, sf=TPCH_SF)))
    ps = ldb.create_in_memory(device="cpu")
    tpchgen.install(ps, carried)
    for stmt in ENGAGE_FUNCTIONS:
        rs.sql_stmt(stmt)
        ps.sql_stmt(stmt)
    yield rs, ps
    ref_dv._MESH, ref_dv._MESH_INIT = old_mesh
    ref_dv.SMALL_ROWS, dv.SMALL_ROWS = old_ref_rows, old_rows
    pgather.FORCE_KERNELS = old_force
    ref_settings.PARALLELISM.set("")


def _spy(monkeypatch, module) -> dict:
    seen = {name: [] for name in ENTRY_POINTS}
    for name in ENTRY_POINTS:
        orig = getattr(module.Executor, name)

        def spy(ex_self, *a, _orig=orig, _seen=seen[name], **k):
            r = _orig(ex_self, *a, **k)
            _seen.append(r is not None)
            return r

        monkeypatch.setattr(module.Executor, name, spy)
    return seen


@pytest.mark.parametrize("q", list(ENGAGE_QUERIES))
def test_fused_engaged_set_on_udf_queries(tpch_pair, q, monkeypatch):
    """The port's fused programs engage on a UDF query exactly where the
    reference's do: a UDF the program would evaluate (a filter under the
    aggregate, an aggregate's argument, a join's probe key) declines it on
    the host before anything runs, a UDF above the aggregate or on an
    eagerly built dimension does not. Rows equal the reference's."""
    rs, ps = tpch_pair
    rs.stage_cache.clear()
    ps.stage_cache.clear()
    ref_seen = _spy(monkeypatch, ref_ex)
    want = rs.sql(ENGAGE_QUERIES[q]).format_rows()
    seen = _spy(monkeypatch, ex)
    programs = []
    run_program = ex.Executor._run_program

    def counted(ex_self, basekey, *a, **k):
        programs.append(basekey[0])
        return run_program(ex_self, basekey, *a, **k)

    monkeypatch.setattr(ex.Executor, "_run_program", counted)
    got = ps.sql(ENGAGE_QUERIES[q]).format_rows()
    assert got == want
    engaged = {k: any(v) for k, v in seen.items()}
    assert engaged == {k: any(v) for k, v in ref_seen.items()}, q
    assert engaged["_try_fused_agg"] == (q in FUSED), engaged
    if q not in FUSED:
        assert not programs  # declined before a program ran
