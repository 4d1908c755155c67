"""The port's out-of-core chunked aggregate and its data generator, held
against the JAX package.

tools/tpchbig.py's lineitem subset at sf 0.1 (600,000 rows) must be bit-equal
to the JAX package's for the same seed. With system.device_byte_budget at
2,000,000 bytes, q1 (44 bytes a row) and q6 (28) stream in chunks of
m = 2^18 rows: 3 chunks, the last one padded (600,000 = 2 * 262,144 +
75,712). The rows must equal the JAX package's under the same budget (its
mesh turned off, so that it streams too) and the port's own at the default
budget, where the table is resident and the fused aggregate runs. The
streamed table is never uploaded whole, not by the query and not by
Session.prepare.

The chunk program is written for capture: it reads one staging slot's
fixed buffers and the valid count from a (1,) tensor, reads nothing to the
host, and runs through the session's graph store, captured once a slot
(on the CPU the store's stand-in) and replayed for every other chunk and
every later run.
"""

import sqlite3

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lingodb_tpu as ref_ldb
from lingodb_tpu.catalog.catalog import TableEntry as RefTableEntry
from lingodb_tpu.runtime import device as ref_dv
from lingodb_tpu.tools import tpchbig as ref_tpchbig
from lingodb_tpu.utils import settings as ref_settings

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import scalar as sc
from lingodb_tpu_torch.runtime import executor as ex
from lingodb_tpu_torch.runtime import exestore
from lingodb_tpu_torch.tools import sqlite_oracle as so
from lingodb_tpu_torch.tools import tpchbig, tpchgen
from lingodb_tpu_torch.utils import compilestats, settings

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

SF = 0.1
SEED = 19920601
BUDGET = 2_000_000


@pytest.fixture(scope="module")
def tables():
    return ref_tpchbig._gen_subset(SF, SEED), tpchbig.generate(SF, SEED)


@pytest.fixture(scope="module")
def sessions(tables):
    ref_t, port_t = tables
    # single-device reference: with its (test) mesh active the reference's
    # chunked path declines
    ref_settings.PARALLELISM.set("OFF")
    old_mesh = ref_dv._MESH, ref_dv._MESH_INIT
    ref_dv._MESH, ref_dv._MESH_INIT = None, True
    rs = ref_ldb.create_in_memory()
    rs.catalog.tables["lineitem"] = RefTableEntry(
        "lineitem", ref_t.column_names, ref_t.column_types, [], ref_t)
    ps = ldb.create_in_memory(device="cpu")
    tpchbig.install(ps, port_t)
    yield rs, ps
    ref_settings.PARALLELISM.set("")
    ref_dv._MESH, ref_dv._MESH_INIT = old_mesh


@pytest.fixture()
def budget():
    old = (settings.DEVICE_BYTE_BUDGET.get(),
           ref_settings.DEVICE_BYTE_BUDGET.get())
    settings.DEVICE_BYTE_BUDGET.set(str(BUDGET))
    ref_settings.DEVICE_BYTE_BUDGET.set(str(BUDGET))
    yield
    settings.DEVICE_BYTE_BUDGET.set(str(old[0]))
    ref_settings.DEVICE_BYTE_BUDGET.set(str(old[1]))


def test_tpchbig_equals_reference(tables):
    ref_t, port_t = tables
    assert port_t.column_names == ref_t.column_names
    assert port_t.num_rows == ref_t.num_rows == 600_000
    for name in ref_t.column_names:
        a, b = ref_t.column(name), port_t.column(name)
        assert np.asarray(a.data).dtype == b.data.dtype, name
        assert np.array_equal(np.asarray(a.data), b.data), name
        if a.dictionary is not None:
            assert list(a.dictionary) == list(b.dictionary), name


def test_tpchbig_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("LINGODB_TPCH_CACHE", str(tmp_path))
    first = tpchbig.generate_cached(0.01, SEED)
    again = tpchbig.generate_cached(0.01, SEED)  # from the .npy files
    assert isinstance(again.column("l_tax").data, np.memmap)
    for name in first.column_names:
        assert np.array_equal(first.column(name).data,
                              again.column(name).data), name


@pytest.mark.parametrize("q,width", [("6", 28), ("1", 44)])
def test_chunked_agg_streams_three_chunks(sessions, budget, q, width,
                                          monkeypatch):
    rs, ps = sessions
    sql = open(f"queries/tpch/{q}.sql").read()
    def no_upload(name):
        raise AssertionError(f"{name} uploaded whole")

    monkeypatch.setattr(ps, "device_table", no_upload)
    ps.executor.last_chunked = None
    got = ps.sql(sql).format_rows()
    plan = ps.executor.last_chunked
    assert plan is not None
    assert (plan["rows"], plan["width"], plan["chunk_rows"], plan["chunks"]) \
        == (600_000, width, 1 << 18, 3)
    assert got == rs.sql(sql).format_rows()
    assert len(got) == (1 if q == "6" else 4)


@pytest.mark.parametrize("q", ["6", "1"])
def test_chunked_agg_equals_resident_run(sessions, q):
    rs, ps = sessions
    sql = open(f"queries/tpch/{q}.sql").read()
    settings.DEVICE_BYTE_BUDGET.set(str(BUDGET))
    try:
        ps.executor.last_chunked = None
        chunked = ps.sql(sql).format_rows()
        assert ps.executor.last_chunked["chunks"] == 3
    finally:
        settings.DEVICE_BYTE_BUDGET.set(str(10 << 30))
    ps.executor.last_chunked = None
    spied = []
    orig = ex.Executor._finish_fused_dense

    def spy(self, op, res, meta):
        spied.append(meta["mode"])
        return orig(self, op, res, meta)

    ex.Executor._finish_fused_dense = spy
    try:
        resident = ps.sql(sql).format_rows()
    finally:
        ex.Executor._finish_fused_dense = orig
    assert ps.executor.last_chunked is None and spied == ["dense"]
    assert resident == chunked


def test_prepare_does_not_upload_a_streamed_table(sessions, budget):
    _rs, ps = sessions
    ps._device_cache.pop("lineitem", None)
    pq = ps.prepare(open("queries/tpch/6.sql").read())
    assert "lineitem" not in ps._device_cache
    assert ps.execute_prepared(pq).format_rows()
    assert "lineitem" not in ps._device_cache


def _forget_plans(ps):
    """Drop what the session learned and captured (its staging slots too),
    as Session._evict_device_memory does."""
    ps.stage_cache.clear()
    for store in ps.graph_stores():
        store.clear()


class _HostReads(TorchDispatchMode):
    """Records the operators that read a tensor to the host or size their
    output by the data: a capture on the card refuses each of them."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name.startswith(("_local_scalar_dense", "nonzero", "unique",
                            "masked_select")):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("q", ["6", "1"])
def test_chunk_program_is_written_for_capture(sessions, budget, q,
                                              monkeypatch):
    """Static outputs over the slot's own buffers, the valid count as a
    (1,) tensor, no host read inside; two captures (one a slot) and one
    replay in the first run of the plan, three replays in the next; rows
    equal the reference's chunked aggregate, the uncaptured stream and the
    resident run."""
    rs, ps = sessions
    sql = open(f"queries/tpch/{q}.sql").read()
    calls, reads = [], []
    orig = ex.Executor._chunk_program

    def spy(self, op, steps, scan, templates, m, domain, arrs, nvalid):
        with _HostReads(reads):
            out, meta = orig(self, op, steps, scan, templates, m, domain,
                             arrs, nvalid)
        calls.append((tuple(a.data_ptr() for a in arrs), nvalid))
        assert all(isinstance(v, torch.Tensor) and v.shape == (domain,)
                   for v in out.values())
        return out, meta

    monkeypatch.setattr(ex.Executor, "_chunk_program", spy)
    _forget_plans(ps)
    cs0 = compilestats.snapshot()
    first = ps.sql(sql).format_rows()
    d1, cs1 = compilestats.delta(cs0), compilestats.snapshot()
    again = ps.sql(sql).format_rows()
    d2 = compilestats.delta(cs1)
    assert (d1["captures"], d1["replays"]) == (2, 1)
    assert (d2["captures"], d2["replays"]) == (0, 3)
    assert reads == []
    assert all(isinstance(nv, torch.Tensor) and nv.shape == (1,)
               and nv.dtype == torch.int64 for _p, nv in calls)
    # two slots, each read at the same addresses in both runs
    assert len({p for p, _nv in calls}) == 2
    monkeypatch.setattr(exestore, "CAPTURE", False)
    uncaptured = ps.sql(sql).format_rows()
    assert first == again == uncaptured == rs.sql(sql).format_rows()
    settings.DEVICE_BYTE_BUDGET.set(str(10 << 30))
    ps.executor.last_chunked = None
    assert ps.sql(sql).format_rows() == first
    assert ps.executor.last_chunked is None


HOST_READ_SQL = [
    # a cast to a string: the LIKE reads the formatted values on the host
    "SELECT l_returnflag, count(*) FROM lineitem "
    "WHERE CAST(l_quantity AS VARCHAR) LIKE '1%' "
    "GROUP BY l_returnflag ORDER BY l_returnflag",
    # a string concatenation: computed on the host
    "SELECT l_returnflag, count(*) FROM lineitem "
    "WHERE l_returnflag || l_linestatus = 'NO' "
    "GROUP BY l_returnflag ORDER BY l_returnflag",
]


@pytest.mark.parametrize("sql", HOST_READ_SQL, ids=["cast", "concat"])
def test_chunk_program_that_reads_the_host_streams_uncaptured(
        sessions, budget, sql, monkeypatch):
    """A chunk program that reads the host (HostRead under capture) marks
    its plan and streams uncaptured, as it is called: the table is still
    never uploaded whole, the rows equal the reference's, and a later run
    goes straight to the uncaptured stream (no capture tried again)."""
    rs, ps = sessions
    _forget_plans(ps)

    def no_upload(name):
        raise AssertionError(f"{name} uploaded whole")

    monkeypatch.setattr(ps, "device_table", no_upload)
    # the reference's compiled chunk program cannot read the host: its
    # rows come from its resident run
    ref_settings.DEVICE_BYTE_BUDGET.set(str(10 << 30))
    try:
        want = rs.sql(sql).format_rows()
    finally:
        ref_settings.DEVICE_BYTE_BUDGET.set(str(BUDGET))
    for _run in range(2):
        ps.executor.last_chunked = None
        cs0 = compilestats.snapshot()
        assert ps.sql(sql).format_rows() == want
        d = compilestats.delta(cs0)
        assert ps.executor.last_chunked["chunks"] == 3
        assert any(k[0] == "chunked_eager" for k in ps.stage_cache
                   if isinstance(k, tuple))
        assert (d["captures"], d["replays"]) == (0, 0)
    _forget_plans(ps)


# INT arithmetic beyond INT's range (quantities of 22 and more), and the
# same where the restriction keeps it in range: PostgreSQL's error, or rows
OVERFLOW_SQL = ("SELECT l_returnflag, sum(CAST(l_quantity AS INT) * 100000000)"
                " FROM lineitem {}GROUP BY l_returnflag ORDER BY l_returnflag")


def test_streamed_aggregate_raises_where_the_resident_run_raises(
        sessions, budget, monkeypatch):
    """A data error in the chunk program rides its lanes as one more lane
    (no read inside it): the stream raises PostgreSQL's error at the first
    chunk whose live rows raise, as the resident run (the fused aggregate)
    raises it, and where the restriction drops those rows both give the
    same rows."""
    _rs, ps = sessions
    chunks = []
    orig = ex.Executor._chunk_program

    def spy(self, *a, **k):
        chunks.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(ex.Executor, "_chunk_program", spy)
    raising, kept = (OVERFLOW_SQL.format(""),
                     OVERFLOW_SQL.format("WHERE l_quantity < 22 "))
    _forget_plans(ps)
    with pytest.raises(sc.EvalError, match="^integer out of range$"):
        ps.sql(raising)
    assert len(chunks) == 1  # the first chunk raised
    streamed = ps.sql(kept).format_rows()
    assert ps.executor.last_chunked["chunks"] == 3
    settings.DEVICE_BYTE_BUDGET.set(str(10 << 30))
    ps.executor.last_chunked = None
    chunks.clear()
    with pytest.raises(sc.EvalError, match="^integer out of range$"):
        ps.sql(raising)
    assert ps.sql(kept).format_rows() == streamed
    assert ps.executor.last_chunked is None and not chunks
    _forget_plans(ps)


def _streams(ps):
    return [v for v in ps.stage_cache.values()
            if type(v).__name__ == "ChunkStream"]


def _chunk_graphs(ps):
    return {k[0] for store in ps.graph_stores() for k in store.entries
            if k[0][0] == "chunked_agg"}


def test_one_chunk_stream_a_session(sessions, budget):
    """The session keeps ONE chunk stream (two staging slots): a plan of
    the same layout reuses its slots and replays its own graphs beside the
    first plan's, a plan of another layout replaces it and the graphs
    captured over the old slots are dropped with it."""
    rs, ps = sessions
    q6 = open("queries/tpch/6.sql").read()
    q6b = q6.replace("0.06 - 0.01", "0.05 - 0.01")
    q1 = open("queries/tpch/1.sql").read()
    assert q6b != q6
    _forget_plans(ps)
    for sql in (q6, q6b, q6, q6b):
        assert ps.sql(sql).format_rows() == rs.sql(sql).format_rows()
    (stream,) = _streams(ps)
    assert len(_chunk_graphs(ps)) == 2 and len(stream.plans) == 2
    cs0 = compilestats.snapshot()
    assert ps.sql(q1).format_rows() == rs.sql(q1).format_rows()
    assert compilestats.delta(cs0)["captures"] == 2
    (stream2,) = _streams(ps)
    assert stream2 is not stream and len(_chunk_graphs(ps)) == 1
    cs0 = compilestats.snapshot()
    assert ps.sql(q1).format_rows() == rs.sql(q1).format_rows()
    assert (compilestats.delta(cs0)["captures"], len(_streams(ps))) == (0, 1)
    _forget_plans(ps)


# Aggregates over a wide decimal that only the host computes (a quotient
# past 18 digits: a host object column in the chunk program). The streamed
# rows must equal the port's resident rows as strings: the JAX package is
# no oracle here (its wide quotients wrap: sum(l_extendedprice / 7) gives
# -0.245761671309375607354 for 'A'), sqlite3 is, within a relative 1e-9.
C8_SF = 0.05  # 300,000 rows: two chunks of m = 2^18 at BUDGET
C8_SQL = {
    "sum": "SELECT l_returnflag, sum(l_extendedprice / 7) FROM lineitem "
           "GROUP BY l_returnflag ORDER BY l_returnflag",
    "avg": "SELECT l_returnflag, avg(l_extendedprice / 7) FROM lineitem "
           "GROUP BY l_returnflag ORDER BY l_returnflag",
    "global": "SELECT sum(l_extendedprice / 3) FROM lineitem "
              "WHERE l_quantity < 10",
    "minmax": "SELECT l_returnflag, min(l_extendedprice / 7), "
              "max(l_extendedprice / 7) FROM lineitem "
              "GROUP BY l_returnflag ORDER BY l_returnflag",
    "per_unit": "SELECT l_returnflag, sum(l_extendedprice * 1.0 / l_quantity) "
                "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag",
    # NULL operands: every 'A' and 'R' row has linestatus 'F', so their
    # groups hold no value (NULL results beside a present group)
    "null_operand": "SELECT l_returnflag, sum(CASE WHEN l_linestatus = 'O' "
                    "THEN l_extendedprice / 7 END), "
                    "min(l_extendedprice / NULLIF(l_quantity, 1)), "
                    "max(CASE WHEN l_linestatus = 'O' "
                    "THEN l_extendedprice / 7 END) FROM lineitem "
                    "GROUP BY l_returnflag ORDER BY l_returnflag",
    # the restriction empties the 'A' and 'R' groups
    "emptied_group": "SELECT l_returnflag, sum(l_extendedprice / 7), "
                     "min(l_extendedprice / 7), max(l_extendedprice / 3) "
                     "FROM lineitem WHERE l_shipdate > date '1995-06-17' "
                     "GROUP BY l_returnflag ORDER BY l_returnflag",
    "emptied_global": "SELECT sum(l_extendedprice / 3), "
                      "min(l_extendedprice / 3), count(*) FROM lineitem "
                      "WHERE l_quantity < 0",
}


@pytest.fixture(scope="module")
def c8():
    t = tpchbig.generate(C8_SF, SEED)
    ps = ldb.create_in_memory(device="cpu")
    tpchbig.install(ps, t)
    conn = sqlite3.connect(":memory:")
    tpchgen.to_sqlite(conn, {"lineitem": t})
    yield ps, conn
    conn.close()


@pytest.mark.parametrize("name", list(C8_SQL))
def test_streamed_aggregate_over_host_decimals_is_exact(c8, budget, name,
                                                        monkeypatch):
    """Sum, min and max (avg as sum and count) of a host object column
    stream in exact host lanes, combined exactly across chunks (never split
    into int64 limbs): the streamed rows equal the resident run's, the
    table is not uploaded whole, and the plan streams uncaptured."""
    ps, conn = c8
    sql = C8_SQL[name]
    settings.DEVICE_BYTE_BUDGET.set(str(10 << 30))
    resident = ps.sql(sql).format_rows()
    settings.DEVICE_BYTE_BUDGET.set(str(BUDGET))
    _forget_plans(ps)

    def no_upload(table):
        raise AssertionError(f"{table} uploaded whole")

    monkeypatch.setattr(ps, "device_table", no_upload)
    ps.executor.last_chunked = None
    cs0 = compilestats.snapshot()
    res = ps.sql(sql)
    d = compilestats.delta(cs0)
    assert res.format_rows() == resident
    assert ps.executor.last_chunked["chunks"] == 2
    assert any(k[0] == "chunked_eager" for k in ps.stage_cache
               if isinstance(k, tuple))
    assert (d["captures"], d["replays"]) == (0, 0)
    if name == "sum":
        # the 'A' total needs more than the 95 bits of an int64 limb pair
        assert int(resident[0][1].replace(".", "")) > 1 << 95
    ours, theirs = so.our_rows(res), so.run_sqlite(conn, sql)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, str) or x is None or y is None:
                assert x == y
            else:
                assert x == pytest.approx(y, rel=1e-9, abs=0), (x, y)
    _forget_plans(ps)
