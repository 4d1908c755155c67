"""The port's eager slice as a whole, held against the JAX package.

The same generated TPC-H tables (carried across as plain numpy, so both
engines read the very same bytes) go through `lingodb_tpu` and through
`lingodb_tpu_torch` on device="cpu"; `format_rows()` must be equal string for
string. The port's dispatcher is forced onto its kernel route
(FORCE_KERNELS): on CPU tensors the wrappers then run the kernels' plain versions,
so routing, limb-splitting and the sentinel tail are exercised as on the card.
"""

import numpy as np
import pytest

import lingodb_tpu as ref_ldb
from lingodb_tpu.tools import tpchgen as ref_tpchgen

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.runtime import executor as ex
from lingodb_tpu_torch.tools import carry, tpchgen
from lingodb_tpu_torch.utils.settings import EXECUTION_MODE

# a numpy array meeting a tensor in an infix operation works on CPU tensors
# only through numpy's __array_wrap__ (and raises on CUDA tensors): the
# warning it gives is an error here, so tier mixing shows without a card
pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

SF = 0.005
TIERS = [dv.SMALL_ROWS, 2]
# tier -> (storage threshold, fused aggregate on): the eager tier declines
# the fused program, so that every query runs the eager operators on tensors
RUNS = {"two_tier": (TIERS[0], True), "all_tensor": (TIERS[1], True),
        "eager": (TIERS[1], False)}
SEED = 19920601
QUERIES = [str(i) for i in range(1, 23)]  # q6, q1, q14, q3, q4 are the slice


def _extract(ref_tables) -> dict:
    """lingodb_tpu TableStorage objects -> plain numpy (carry.py's input)."""
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
def pair():
    """(reference session, port sessions by tier) over the same carried
    tables. The port keeps tables under dv.SMALL_ROWS rows as numpy (host
    tier) and larger ones as tensors; one session runs at the real threshold
    and one with every table on the tensor tier, as at large scale factors."""
    rs = ref_ldb.create_in_memory()
    ref_tables = ref_tpchgen.load_into(rs, sf=SF, seed=SEED)
    carried = carry.tables_from_numpy(_extract(ref_tables))
    ps = {}
    for small_rows in TIERS:
        ps[small_rows] = ldb.create_in_memory(device="cpu")
        tpchgen.install(ps[small_rows], carried)
    old = pgather.FORCE_KERNELS
    pgather.FORCE_KERNELS = True
    # DEBUG mode verifies every operator's output, among it that no host
    # array sits in a table of tensors (such mixing fails only on a card)
    EXECUTION_MODE.set("DEBUG")
    yield rs, ps
    EXECUTION_MODE.set("DEFAULT")
    pgather.FORCE_KERNELS = old


_WANT: dict = {}  # reference rows per query, computed once


@pytest.mark.parametrize("tier", list(RUNS))
@pytest.mark.parametrize("q", QUERIES)
def test_tpch_query_equals_reference(pair, q, tier, monkeypatch):
    rs, ps = pair
    small_rows, fused = RUNS[tier]
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    if not fused:
        monkeypatch.setattr(ex.Executor, "_try_fused_agg",
                            lambda self, op, epi=None: None)
    sql = open(f"queries/tpch/{q}.sql").read()
    if q not in _WANT:
        _WANT[q] = rs.sql(sql).format_rows()
    want = _WANT[q]
    got = ps[small_rows].sql(sql).format_rows()
    assert got == want
    if q in ("6", "1", "14", "3", "4"):
        assert len(got) > 0


def test_kernel_route_was_taken(pair, monkeypatch):
    """The eager operators of q3 go through all three wrappers (compaction,
    sorted gather, and the small-table gather of a dimension LUT); the fused
    program's route to them is held in tests/test_torch_fused.py."""
    monkeypatch.setattr(ex.Executor, "_try_fused_agg",
                        lambda self, op, epi=None: None)
    _rs, sessions = pair
    ps = sessions[TIERS[0]]
    calls = {"compact": 0, "sorted": 0, "chunked": 0}
    orig = (pgather.compact_positions, pgather.gather_sorted_planes,
            pgather.gather_chunked_planes)

    def wrap(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    pgather.compact_positions = wrap("compact", orig[0])
    pgather.gather_sorted_planes = wrap("sorted", orig[1])
    pgather.gather_chunked_planes = wrap("chunked", orig[2])
    try:
        for q in ("3", "14"):
            ps.sql(open(f"queries/tpch/{q}.sql").read())
    finally:
        (pgather.compact_positions, pgather.gather_sorted_planes,
         pgather.gather_chunked_planes) = orig
    assert all(v > 0 for v in calls.values()), calls
    # CPU tensors never launch a CUDA kernel
    assert all(v == 0 for v in pgather.LAUNCHES.values())


def test_own_tpchgen_equals_reference():
    mine = tpchgen.generate(0.002, 7)
    theirs = ref_tpchgen.generate(0.002, 7)
    assert list(mine) == list(theirs)
    for name in mine:
        a, b = mine[name], theirs[name]
        assert a.column_names == b.column_names
        assert [str(t) for t in a.column_types] == [str(t) for t in b.column_types]
        assert tuple(a.sorted_cols) == tuple(b.sorted_cols)
        for ca, cb in zip(a.columns, b.columns):
            np.testing.assert_array_equal(ca.data, cb.data)
            assert (ca.valid is None) == (cb.valid is None)
            if ca.dictionary is not None:
                np.testing.assert_array_equal(ca.dictionary, cb.dictionary)


def _both(stmts, query):
    out = []
    for mod, kw in ((ref_ldb, {}), (ldb, {"device": "cpu"})):
        s = mod.create_in_memory(**kw)
        for st in stmts:
            s.sql_stmt(st)
        out.append(s.sql(query).format_rows())
    return out


def test_null_handling():
    want, got = _both(
        ["CREATE TABLE t(a INT, b VARCHAR(8))",
         "INSERT INTO t VALUES (3, 'c'), (NULL, 'n'), (1, NULL), (2, 'b')"],
        "SELECT a, b, a IS NULL, coalesce(a, -1) FROM t ORDER BY a NULLS FIRST")
    assert got == want
    assert got[0][0] == "NULL"


def test_decimal_exactness():
    want, got = _both(
        ["CREATE TABLE p(x DECIMAL(12,2), q INT)",
         "INSERT INTO p VALUES (9.99, 3), (0.01, 7), (-5.50, 2), (NULL, 1)"],
        "SELECT sum(x), avg(x), sum(x * q), min(x), max(x), count(x) FROM p")
    assert got == want
    assert got[0][0] == "4.50"


def test_empty_table_join():
    want, got = _both(
        ["CREATE TABLE a(k INT, v INT)", "CREATE TABLE b(k INT, w INT)",
         "INSERT INTO a VALUES (1, 10), (2, 20)"],
        "SELECT a.k, b.w FROM a LEFT JOIN b ON a.k = b.k ORDER BY a.k")
    assert got == want == [["1", "NULL"], ["2", "NULL"]]
    want, got = _both(
        ["CREATE TABLE a(k INT, v INT)", "CREATE TABLE b(k INT, w INT)",
         "INSERT INTO a VALUES (1, 10), (2, 20)"],
        "SELECT count(*) FROM a JOIN b ON a.k = b.k")
    assert got == want == [["0"]]


def test_unique_key_join_with_build_rows_out_of_key_order():
    """Sorted probe keys over a build side whose rows are
    stored in DESCENDING key order: every probe row must still get its own
    key's build row. (The reference's eager operator returns the first build
    row for every key here — ROADMAP.md, queue C — so the expectation is
    written out instead of taken from it.)"""
    import pyarrow as pa

    n = 70_000
    a = pa.table({"k": pa.array(np.sort(np.arange(n) % 10).astype(np.int32)),
                  "x": pa.array(np.arange(n, dtype=np.int32))})
    b = pa.table({"k": pa.array(np.arange(9, -1, -1).astype(np.int32)),
                  "v": pa.array((np.arange(9, -1, -1) * 100).astype(np.int32))})
    q = ("SELECT a.k, min(b.v), max(b.v), count(*) FROM a JOIN b ON a.k = b.k "
         "GROUP BY a.k ORDER BY a.k")
    s = ldb.create_in_memory(device="cpu")
    s.add_table("a", a)
    s.add_table("b", b)
    want = [[str(k), str(k * 100), str(k * 100), "7000"] for k in range(10)]
    assert s.sql(q).format_rows() == want
    left = ("SELECT count(*), sum(b.v) FROM a LEFT JOIN b ON a.k = b.k + 5")
    assert s.sql(left).format_rows() == [[str(n), str(7000 * sum(range(0, 500, 100)))]]


def test_no_gpu_raises_instead_of_falling_back():
    import torch

    if torch.cuda.is_available():
        assert ldb.create_in_memory().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ldb.create_in_memory()
    with pytest.raises(RuntimeError):
        ldb.Session(device="cuda")

