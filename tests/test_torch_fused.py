"""The port's fused programs (the fused aggregate, the fused chain and the
TopK epilogue both carry), held against its own eager operators and against
the JAX package's fused programs.

The generated TPC-H tables (sf 0.005) are carried across as plain numpy, so
both engines read the very same bytes. The port runs on device="cpu" with its
dispatcher forced onto the kernel route (the wrappers then run the kernels'
plain versions), in DEBUG mode, with tables of 64 rows and more on the tensor
tier, as tests/test_fused.py does for the reference (both engines: the
reference's fused chain and TopK engage at that size too). `format_rows()`
must be equal string for string.
"""

import numpy as np
import pytest
import torch

import lingodb_tpu as ref_ldb
import lingodb_tpu.runtime.executor as ref_ex
from lingodb_tpu.runtime import device as ref_dv
from lingodb_tpu.tools import tpchgen as ref_tpchgen
from lingodb_tpu.utils import settings as ref_settings

import lingodb_tpu_torch as ldb
import lingodb_tpu_torch.runtime.executor as ex
from lingodb_tpu_torch.ops import groupby as gb
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.runtime import fused as F
from lingodb_tpu_torch.tools import carry, tpchgen
from lingodb_tpu_torch.utils.settings import EXECUTION_MODE

# numpy meeting a tensor in an infix operation raises on CUDA tensors only;
# here its warning is an error, so tier mixing shows without a card
pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

SF = 0.005
SEED = 19920601
QUERIES = [str(i) for i in range(1, 23)]
AGAINST_REFERENCE = ["1", "3", "6", "14", "18"]
# the queries whose TopK or chain the reference fuses at this scale
TOPK_QUERIES = ["2", "3", "10", "18", "21"]
CHAIN_QUERIES = ["8", "9", "11", "16", "17", "20"]
ENTRY_POINTS = ("_try_fused_agg", "_try_fused_topk", "_try_fused_chain")


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


def _sql(q):
    return open(f"queries/tpch/{q}.sql").read()


@pytest.fixture(scope="module")
def env():
    """(reference session, carried tables). The reference runs on one
    device (no mesh), where its fused program engages."""
    ref_settings.PARALLELISM.set("OFF")
    old_mesh = ref_dv._MESH, ref_dv._MESH_INIT
    ref_dv._MESH, ref_dv._MESH_INIT = None, True
    old_ref_rows = ref_dv.SMALL_ROWS
    ref_dv.SMALL_ROWS = 64
    rs = ref_ldb.create_in_memory()
    carried = carry.tables_from_numpy(
        _extract(ref_tpchgen.load_into(rs, sf=SF, seed=SEED)))
    old_rows, old_force = dv.SMALL_ROWS, pgather.FORCE_KERNELS
    dv.SMALL_ROWS = 64
    pgather.FORCE_KERNELS = True
    EXECUTION_MODE.set("DEBUG")
    yield rs, carried
    EXECUTION_MODE.set("DEFAULT")
    dv.SMALL_ROWS, pgather.FORCE_KERNELS = old_rows, old_force
    ref_dv._MESH, ref_dv._MESH_INIT = old_mesh
    ref_dv.SMALL_ROWS = old_ref_rows
    ref_settings.PARALLELISM.set("")


def _session(carried):
    s = ldb.create_in_memory(device="cpu")
    tpchgen.install(s, carried)
    return s


@pytest.fixture(scope="module")
def port(env):
    return _session(env[1])


class _Spy:
    """Counts what each fused entry point returned (hits: the aggregate's,
    topk and chain: the fused TopK's and the fused chain's; a pair counts
    as a result), which tail each fused chain run took, and what the
    finishes raised."""

    def __init__(self, monkeypatch, module=ex):
        self.hits, self.raised, self.routes = [], [], []
        self.topk, self.chain, self.tails = [], [], []
        self.raised_by = {}  # "agg" / "chain" -> what its finishes raised
        for name, seen in zip(ENTRY_POINTS, (self.hits, self.topk, self.chain)):
            orig = getattr(module.Executor, name)

            def spy(ex_self, *a, _orig=orig, _seen=seen, **k):
                r = _orig(ex_self, *a, **k)
                _seen.append(r is not None)
                return r

            monkeypatch.setattr(module.Executor, name, spy)
        if module is not ex:
            return
        for name in ("_finish_fused_general", "_finish_fused_dense",
                     "_learn_calibration", "_finish_fused_epi",
                     "_finish_fused_chain"):
            self._wrap_raise(monkeypatch, name)
        orig_finish = ex.Executor._finish_fused_chain

        def finish(ex_self, op, res, meta, *a):
            self.tails.append(
                "calibrating" if meta["calibrating"] else "topk"
                if meta.get("epi") else "compacted" if meta["do_compact"]
                else "full width")
            return orig_finish(ex_self, op, res, meta, *a)

        monkeypatch.setattr(ex.Executor, "_finish_fused_chain", finish)
        orig_group = F.general_group

        def group(*a, presorted=False, **k):
            self.routes.append("presorted" if presorted else "sort")
            return orig_group(*a, presorted=presorted, **k)

        monkeypatch.setattr(F, "general_group", group)

    def _wrap_raise(self, monkeypatch, name):
        orig = getattr(ex.Executor, name)

        program = "chain" if name == "_finish_fused_chain" else "agg"

        def wrapped(ex_self, *a):
            try:
                return orig(ex_self, *a)
            except Exception as e:
                self.raised.append(type(e).__name__)
                self.raised_by.setdefault(program, []).append(type(e).__name__)
                raise

        monkeypatch.setattr(ex.Executor, name, wrapped)


def _eager(s, sql, monkeypatch):
    """The rows with all three fused entry points declined."""
    with monkeypatch.context() as m:
        for name in ENTRY_POINTS:
            m.setattr(ex.Executor, name, lambda self, op, epi=None: None)
        return s.sql(sql).format_rows()


@pytest.mark.parametrize("route", ["learned", "general"])
@pytest.mark.parametrize("q", QUERIES)
def test_fused_equals_eager(port, q, route, monkeypatch):
    """Every TPC-H query: the fused program engages (as the reference's
    does on all 22) and its rows equal the eager operators', on the first
    run (calibration) and the second (learned capacities and compaction).
    At this scale most groupings learn key bounds small enough for the
    sort-free dense path; route "general" withholds that path, so that the
    general grouping reduces every grouped aggregate."""
    want = _eager(port, _sql(q), monkeypatch)
    spy = _Spy(monkeypatch)
    if route == "general":
        monkeypatch.setattr(gb, "bounded_gid", lambda *a: (None,) * 5)
        port.stage_cache.clear()
    first = port.sql(_sql(q)).format_rows()
    second = port.sql(_sql(q)).format_rows()
    assert first == want
    assert second == want
    assert any(spy.hits), f"q{q}: the fused program did not engage"
    assert not spy.raised
    if q in ("3", "18"):
        # the single group key rides lineitem's clustered l_orderkey
        assert spy.routes and set(spy.routes) == {"presorted"}, spy.routes
    if q in ("7", "9", "13", "16"):
        assert "sort" in spy.routes, spy.routes
    if route == "general":
        port.stage_cache.clear()


@pytest.mark.parametrize("q", AGAINST_REFERENCE)
def test_fused_equals_reference(env, port, q, monkeypatch):
    rs, _carried = env
    ref_spy = _Spy(monkeypatch, module=ref_ex)
    want = rs.sql(_sql(q)).format_rows()
    spy = _Spy(monkeypatch)
    got = port.sql(_sql(q)).format_rows()
    assert got == want
    assert any(ref_spy.hits), f"q{q}: the reference's fused program declined"
    assert any(spy.hits), f"q{q}: the port's fused program declined"


def test_compact_overflow_rebuilds_once(env, monkeypatch):
    """A lead compaction sized from a selectivity estimate that is far too
    small: each fused program (q3: the chain of its build side and the
    aggregate; q14: the aggregate) raises CompactOverflow once and the
    rebuild, without lead compaction, gives the eager rows."""
    s = _session(env[1])
    monkeypatch.setattr(ex, "COMPACT_SLACK", 64)
    monkeypatch.setattr(ex, "COMPACT_QUANTUM", 64)
    from lingodb_tpu_torch.opt import cardinality

    want = {q: _eager(s, _sql(q), monkeypatch) for q in ("3", "14")}
    monkeypatch.setattr(cardinality, "scan_selectivity", lambda *a: 1e-9)
    for q in ("3", "14"):
        spy = _Spy(monkeypatch)
        assert s.sql(_sql(q)).format_rows() == want[q]
        assert spy.raised_by.get("agg") == ["CompactOverflow"], (q, spy.raised_by)
        assert spy.raised_by.get("chain", ["CompactOverflow"]) == [
            "CompactOverflow"], (q, spy.raised_by)
        assert all(spy.hits)


def test_lead_compaction_at_small_sizes(env, monkeypatch):
    """The lead compaction engages when its quantum is small, and the rows
    stay those of the eager operators. On the way the program reaches all
    three kernel wrappers (on CPU tensors they run their plain versions):
    compaction, the sorted gather of the compacted columns and of the
    boundary lanes, the small-table gather of dictionary LUTs."""
    s = _session(env[1])
    monkeypatch.setattr(ex, "COMPACT_SLACK", 64)
    monkeypatch.setattr(ex, "COMPACT_QUANTUM", 64)
    seen = []
    orig = F.compact
    monkeypatch.setattr(F, "compact",
                        lambda *a: seen.append(a[2]) or orig(*a))
    want = {q: _eager(s, _sql(q), monkeypatch) for q in ("3", "14", "5", "10")}
    calls = {"compact_positions": 0, "gather_sorted_planes": 0,
             "gather_chunked_planes": 0}
    for name in calls:
        orig_w = getattr(pgather, name)
        monkeypatch.setattr(pgather, name, lambda *a, _n=name, _o=orig_w, **k:
                            calls.__setitem__(_n, calls[_n] + 1) or _o(*a, **k))
    for q in ("3", "14", "5", "10"):
        assert s.sql(_sql(q)).format_rows() == want[q]
    assert seen
    assert all(calls.values()), calls


def test_capacity_overflow_after_append_rebuilds_once(monkeypatch):
    """A learned group capacity that the table outgrows: append_table adds
    new groups, and the old capacity is carried to the table's new version
    (as a store of capacities that outlives versions would). The run raises
    CapacityOverflow once and the rebuild gives the eager rows."""
    import pyarrow as pa

    monkeypatch.setattr(dv, "SMALL_ROWS", 64)
    monkeypatch.setattr(pgather, "FORCE_KERNELS", True)
    rng = np.random.default_rng(5)
    s = ldb.create_in_memory(device="cpu")
    s.sql_stmt("CREATE TABLE g(k DOUBLE, v INT)")

    def add(keys):
        s.append_table("g", pa.table({
            "k": pa.array(keys.astype(np.float64)),
            "v": pa.array(rng.integers(-50, 50, len(keys)).astype(np.int32))}))

    add(rng.integers(0, 50, 2000))
    q = "SELECT k, sum(v), count(*), min(v) FROM g GROUP BY k ORDER BY k"
    spy = _Spy(monkeypatch)
    assert s.sql(q).format_rows() == _eager(s, q, monkeypatch)
    learned = {k: v for k, v in s.stage_cache.items() if k[0] == "fused_kg"}
    assert list(learned.values()) == [256]  # 4 x 50 groups, as a power of two
    add(rng.integers(1000, 3000, 4000))  # ~1,900 new groups
    (_tag, (kind, plan, _versions)), kg = next(iter(learned.items()))
    version = s.catalog.get_table("g").storage.version
    s.stage_cache[("fused_kg", (kind, plan, (("g", version),)))] = kg
    spy.raised.clear()
    got = s.sql(q).format_rows()
    assert got == _eager(s, q, monkeypatch)
    assert spy.raised == ["CapacityOverflow"], spy.raised
    assert len(got) > 1000


@pytest.mark.parametrize("q", ["14", "18"])
def test_mid_compaction_overflow_rebuilds_once(env, q, monkeypatch):
    """A learned post-join survivor count far below the truth: the mid
    compaction (q14: after the part join; q18: the sorted-probe semi join
    that compacts as it goes) overflows once, and the rebuild gives the
    eager rows."""
    s = _session(env[1])
    want = _eager(s, _sql(q), monkeypatch)
    assert s.sql(_sql(q)).format_rows() == want  # learns the step counts
    caps = [k for k in s.stage_cache if k[0] == "fused_stepcaps"]
    assert caps
    for k in caps:
        s.stage_cache[k] = {si: 1 for si in s.stage_cache[k]}
    spy = _Spy(monkeypatch)
    assert s.sql(_sql(q)).format_rows() == want
    assert spy.raised == ["MidCompactOverflow"], spy.raised


def test_sorted_semi_compact_learns_true_survivors(env, monkeypatch):
    """The sorted-probe semi join that compacts as it goes reports the rows
    that survive it as its step count, not the rows of its key ranges: the
    filter before it drops most of those. The range total is kept for the
    capacity check only (the reference reports the larger of the two)."""
    s = _session(env[1])
    q = ("SELECT count(*) FROM lineitem WHERE l_quantity < 10 AND l_orderkey IN "
         "(SELECT l_orderkey FROM lineitem GROUP BY l_orderkey "
         "HAVING sum(l_quantity) > 250)")
    want = _eager(s, q, monkeypatch)
    seen, counts = [], []
    orig = F.sorted_semi_compact
    monkeypatch.setattr(F, "sorted_semi_compact",
                        lambda *a: (lambda r: seen.append(r) or r)(orig(*a)))
    orig_learn = ex.Executor._learn_stepcaps

    def learn(self, basekey, cache, meta):
        counts.append(dict(meta.get("last_stepcounts") or {}))
        return orig_learn(self, basekey, cache, meta)

    monkeypatch.setattr(ex.Executor, "_learn_stepcaps", learn)
    for _ in range(3):
        assert s.sql(q).format_rows() == want
    done = [r for r in seen if r is not None]
    assert done, "the sorted-probe semi compaction did not engage"
    survivors, total = int(done[-1][2]), int(done[-1][3])
    assert survivors == int(want[0][0]) < total
    assert counts[-1] == {0: survivors}


def test_fused_program_reads_nothing_to_the_host(port, monkeypatch):
    """Inside the fused programs (the aggregate with its TopK epilogue, the
    chain) no tensor is read back to the host (on the card each read is a
    sync that stalls the stream); the executor reads once, after each."""
    inside = [False]
    for name in ("item", "__bool__", "__int__", "__index__", "__float__",
                 "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def guard(self, *a, _orig=orig, _name=name, **k):
            if inside[0]:
                raise AssertionError(f"Tensor.{_name} inside the fused program")
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, guard)
    for name in ("_fused_program", "_fused_chain_program"):
        orig_prog = getattr(ex.Executor, name)

        def prog(self, *a, _orig=orig_prog, **k):
            inside[0] = True
            try:
                return _orig(self, *a, **k)
            finally:
                inside[0] = False

        monkeypatch.setattr(ex.Executor, name, prog)
    spy = _Spy(monkeypatch)
    for q in ("1", "3", "4", "6", "14", "18", "9", "13", "2", "10"):
        port.sql(_sql(q))
        port.sql(_sql(q))
    assert all(spy.hits[:2])
    assert any(spy.topk) and any(spy.chain)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n", [1, 16, 17, 1001])
def test_blocked_scan_equals_flat(op, n):
    """The blocked running maximum of the fused grouping, and the blocked
    prefix sum the kernel bench times against the flat one (rows of 4 here,
    so that the row totals recurse twice at n = 1001), equal the flat torch
    call."""
    from lingodb_tpu_torch.tools import kbench

    v = torch.from_numpy(np.random.default_rng(n).integers(-(1 << 40), 1 << 40, n))
    if op == "sum":
        got, want = kbench.blocked_cumsum(v, width=4), torch.cumsum(v, 0)
    else:
        got, want = F.cummax1d(v, width=4), torch.cummax(v, 0).values
    assert torch.equal(got, want)


def test_expression_that_needs_the_host_declines(port, monkeypatch):
    """An expression the port computes on the host (here a concatenation of
    two dictionary columns) makes the program decline for the plan, as the
    reference's trace fails on it; the eager operators give the rows."""
    q = ("SELECT l_returnflag, count(*) FROM lineitem "
         "WHERE l_shipmode || l_shipinstruct = 'AIRNONE' "
         "GROUP BY l_returnflag ORDER BY l_returnflag")
    want = _eager(port, q, monkeypatch)
    spy = _Spy(monkeypatch)
    assert port.sql(q).format_rows() == want
    assert spy.hits == [False]
    assert "eager" in port.stage_cache.values()


@pytest.mark.parametrize("q", TOPK_QUERIES + CHAIN_QUERIES)
def test_fused_topk_and_chain_equal_reference(env, port, q, monkeypatch):
    """The queries whose TopK or chain the reference fuses at this scale:
    the rows equal the reference's, and the port engages its fused TopK and
    its fused chain on exactly the queries where the reference engages
    its own (read from the reference's spy)."""
    rs, _carried = env
    # from a clean start: a chain that builds a dimension of a fused
    # aggregate runs only until the aggregate has cached its build sides
    rs.stage_cache.clear()
    port.stage_cache.clear()
    ref_spy = _Spy(monkeypatch, module=ref_ex)
    want = rs.sql(_sql(q)).format_rows()
    spy = _Spy(monkeypatch)
    got = port.sql(_sql(q)).format_rows()
    assert got == want
    assert any(ref_spy.topk) or any(ref_spy.chain), q
    assert (any(spy.topk), any(spy.chain)) == (any(ref_spy.topk),
                                               any(ref_spy.chain)), q
    assert not spy.raised


def _tie_table(name, sums, seed):
    """One group per entry of `sums` (a DOUBLE key spread over a wide
    range, so that the grouping is the general one), each of 3 rows whose
    v adds up to the entry, with a payload p that differs per row."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    g = len(sums)
    keys = rng.permutation(g).astype(np.float64) * 1e6 + 0.5
    v = np.repeat(np.asarray(sums, np.int64) // 3, 3)
    v[2::3] += np.asarray(sums, np.int64) % 3
    return name, pa.table({"k": pa.array(np.repeat(keys, 3)),
                           "v": pa.array(v.astype(np.int32)),
                           "p": pa.array(rng.integers(0, 10**6, 3 * g)
                                         .astype(np.int32))})


def _install(sessions, name, table):
    for s in sessions:
        if s.catalog.get_table(name) is None:
            s.sql_stmt(f"CREATE TABLE {name}(k DOUBLE, v INT, p INT)")
            s.append_table(name, table)


TIE_SQL = ("SELECT k, sum(v) AS s, max(p) AS mp FROM {t} GROUP BY k "
           "ORDER BY s DESC LIMIT 5")


def test_topk_ties_at_cutoff_decline_once(env, port, monkeypatch):
    """More rows tie on the primary sort key at the cutoff than the slack
    holds (200 groups of one sum; k = 5, kk = 64), with different payloads:
    the epilogue raises EpiOverflow once, the decline is recorded, the
    plain program and the eager epilogue give the reference's rows, and a
    second run does not try the epilogue again."""
    rs, _carried = env
    _install((rs, port), *_tie_table("ties_cut", [7] * 200, 1))
    sql = TIE_SQL.format(t="ties_cut")
    want = rs.sql(sql).format_rows()
    spy = _Spy(monkeypatch)
    assert port.sql(sql).format_rows() == want
    assert spy.raised == ["EpiOverflow"], spy.raised
    assert any(k[0] == "fused_epi_decline" for k in port.stage_cache)
    assert any(spy.topk)
    assert port.sql(sql).format_rows() == want
    assert spy.raised == ["EpiOverflow"], spy.raised
    assert port.sql(sql).format_rows() == _eager(port, sql, monkeypatch)


def test_topk_ties_within_slack_keep_reference_rows(env, port, monkeypatch):
    """Ties that cross the k-th row but fit within the slack (3 groups
    above 20 that tie at the cutoff, then 100 lower ones; k = 5, kk = 64):
    the epilogue is exact, and of the 20 tied groups the port keeps the two
    that the reference keeps (candidates ordered by priority, then by group
    slot, as the reference's top_k orders them)."""
    rs, _carried = env
    sums = [900] * 3 + [450] * 20 + list(range(1, 101))
    _install((rs, port), *_tie_table("ties_slack", sums, 2))
    sql = TIE_SQL.format(t="ties_slack")
    want = rs.sql(sql).format_rows()
    spy = _Spy(monkeypatch)
    for _ in range(2):
        assert port.sql(sql).format_rows() == want
    assert not spy.raised
    assert any(spy.topk)
    assert not any(k[0] == "fused_epi_decline" for k in port.stage_cache
                   if "ties_slack" in repr(k))


CHAIN_SQL = ("SELECT l_orderkey, l_linenumber, l_extendedprice, p_name "
             "FROM lineitem, part WHERE l_partkey = p_partkey AND p_size < 45")
# a filter on the spine that no join narrows further: a narrowing join
# compacts its survivors already (a learned post-join capacity), and the
# chain's tail then emits those lanes whole
COMPACTED_SQL = ("SELECT l_orderkey, l_linenumber, p_name FROM lineitem "
                 "LEFT JOIN part ON l_partkey = p_partkey WHERE l_quantity < 3")


@pytest.mark.parametrize("tail,sql", [
    ("compacted", COMPACTED_SQL),
    ("full width", CHAIN_SQL),
    ("topk", CHAIN_SQL
     + " ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber LIMIT 10"),
])
def test_fused_chain_tails(env, tail, sql, monkeypatch):
    """The chain's three tails, each forced by its selectivity (4 % of the
    spine survives: compacted into the learned capacity; 90 %: full-width
    lanes and one select_mask) or by a TopK on top (the candidates of the
    in-program TopK): calibration, then the tail, on the first run and the
    second, equal to the eager rows."""
    s = _session(env[1])
    want = _eager(s, sql, monkeypatch)
    spy = _Spy(monkeypatch)
    for _ in range(2):
        assert s.sql(sql).format_rows() == want
    assert spy.tails == ["calibrating", tail, tail], spy.tails
    assert not spy.raised


def test_fused_chain_output_capacity_rebuilds_once(env, monkeypatch):
    """A learned survivor count far below the truth: the compacted tail's
    capacity is outgrown, compact_positions still counts every survivor,
    and the chain raises CapacityOverflow once and rebuilds at the true
    count, giving the eager rows."""
    s = _session(env[1])
    sql = COMPACTED_SQL
    want = _eager(s, sql, monkeypatch)
    assert s.sql(sql).format_rows() == want  # learns the output capacity
    caps = [k for k in s.stage_cache if k[0] == "fused_outcap"]
    assert caps
    for k in caps:
        s.stage_cache[k] = 1
    spy = _Spy(monkeypatch)
    assert s.sql(sql).format_rows() == want
    assert spy.raised == ["CapacityOverflow"], spy.raised
    assert spy.tails == ["compacted", "compacted"], spy.tails
    assert s.sql(sql).format_rows() == want
    assert spy.raised == ["CapacityOverflow"], spy.raised
