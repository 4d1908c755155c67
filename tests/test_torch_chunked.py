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
"""

import numpy as np
import pytest

import lingodb_tpu as ref_ldb
from lingodb_tpu.catalog.catalog import TableEntry as RefTableEntry
from lingodb_tpu.runtime import device as ref_dv
from lingodb_tpu.tools import tpchbig as ref_tpchbig
from lingodb_tpu.utils import settings as ref_settings

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.runtime import executor as ex
from lingodb_tpu_torch.tools import tpchbig
from lingodb_tpu_torch.utils import settings

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
