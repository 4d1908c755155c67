"""The port's counterpart of tests/test_r5_regressions.py: the JAX
package's round-5 regressions, asserted on the port's sessions
(device="cpu") with the values the reference file asserts.

1. Device LIKE over a dictionary's byte planes, run twice: the second run
   of q13 and q9 equals the first.
2. float32 MIN/MAX in the fused general grouping (fused.general_group)
   orders mixed-sign values correctly.
3. Trailing-NUL strings mark the byte planes inexact: LIKE goes to the host.
4. The reference's cases about jax tracers (the planes cache under a
   trace) and pgather._OVF_SINK have no counterpart in the port, which has
   neither; their substance is held on the port's own internals: a LIKE
   mask made under a CUDA graph's capture is not cached (only tensors made
   outside a capture are kept), and the fused program's no-host-read
   guard (backend.no_host_reads) is restored after a failure inside it and
   nests.
5. Wide decimals (host object columns) decline the fused programs, and
   device.promote leaves them on the host.
6. The generator's lineitem (partkey, suppkey) pairs exist in partsupp,
   and q9 is not empty.
"""

import os

import numpy as np
import pytest

QDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "queries", "tpch")


@pytest.fixture(scope="module")
def tiny_tpch():
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.ops import bytestr
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.tools import tpchgen

    old_small, old_min = dv.SMALL_ROWS, bytestr.DEVICE_DICT_MIN
    dv.SMALL_ROWS = 64
    bytestr.DEVICE_DICT_MIN = 64
    s = ldb.create_in_memory(device="cpu")
    tpchgen.load_into(s, sf=0.005)
    yield s
    dv.SMALL_ROWS = old_small
    bytestr.DEVICE_DICT_MIN = old_min


@pytest.fixture(scope="module")
def reference_rows():
    """rows(q): the reference's rows of TPC-H query q on the same data
    (its own session over its generator at the same scale and seed): the
    reference file computes its expected rows at run time."""
    import lingodb_tpu as ref_ldb
    from lingodb_tpu.tools import tpchgen as ref_tpchgen

    r = ref_ldb.create_in_memory()
    ref_tpchgen.load_into(r, sf=0.005)
    memo = {}

    def rows(q):
        if q not in memo:
            sql = open(os.path.join(QDIR, f"{q}.sql")).read()
            memo[q] = r.sql(sql).format_rows()
        return memo[q]

    return rows


@pytest.mark.parametrize("q", [13, 9])
def test_device_like_inside_fused_trace_runs_twice(q, tiny_tpch,
                                                   reference_rows):
    """The second run of a LIKE query whose dictionary crossed
    DEVICE_DICT_MIN (the device LIKE, its planes cached) equals the
    first, and both equal the reference's rows."""
    s = tiny_tpch
    sql = open(os.path.join(QDIR, f"{q}.sql")).read()
    r1 = s.sql(sql).format_rows()
    r2 = s.sql(sql).format_rows()
    assert r1 == r2
    assert r1 == reference_rows(q)


def test_fused_general_group_float32_mixed_sign_minmax(session):
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.runtime import fused

    old = dv.SMALL_ROWS
    dv.SMALL_ROWS = 16
    try:
        s = session
        s.sql_stmt("CREATE TABLE fx (k BIGINT NOT NULL, v FLOAT)")
        rng = np.random.default_rng(7)
        keys = (rng.integers(0, 40, 400) * 1_000_000_007 + 13).tolist()
        vals = np.round(rng.normal(0.0, 5.0, 400), 3)  # mixed sign
        rows = ", ".join(f"({k}, {v})" for k, v in zip(keys, vals))
        s.sql_stmt(f"INSERT INTO fx VALUES {rows}")

        called = []
        orig = fused.general_group

        def spy(*a, **kw):
            called.append(True)
            return orig(*a, **kw)

        fused.general_group = spy
        try:
            got = s.sql("SELECT k, MIN(v), MAX(v) FROM fx GROUP BY k "
                        "ORDER BY k").to_pandas()
        finally:
            fused.general_group = orig

        import collections
        mn = collections.defaultdict(lambda: np.inf)
        mx = collections.defaultdict(lambda: -np.inf)
        for k, v in zip(keys, np.float32(vals)):
            mn[k] = min(mn[k], v)
            mx[k] = max(mx[k], v)
        want = sorted(mn)
        assert list(got.iloc[:, 0]) == want
        np.testing.assert_allclose(got.iloc[:, 1], [mn[k] for k in want],
                                   rtol=1e-6)
        np.testing.assert_allclose(got.iloc[:, 2], [mx[k] for k in want],
                                   rtol=1e-6)
        assert called, "fused general grouping did not engage"
    finally:
        dv.SMALL_ROWS = old


def test_planes_trailing_nul_marked_inexact():
    from lingodb_tpu_torch.ops import bytestr

    d = np.array(["a\x00", "ab", "a"], dtype=object)
    _b2d, _lens, _ascii, exact = bytestr._planes(d, "cpu")
    assert exact is False
    assert bytestr.device_like_mask(d, "a", device="cpu") is None  # host


def test_planes_cache_holds_concrete_arrays_under_capture(monkeypatch):
    """A LIKE mask made under a CUDA graph's capture (here: the capture
    predicate forced on) is not cached and caches no planes; the caches
    then hold only what is made outside one, reusable after."""
    import types

    from lingodb_tpu_torch.ops import backend as be
    from lingodb_tpu_torch.ops import bytestr

    d = np.array([f"w{i:05d}" for i in range(200)], dtype=object)
    # bytestr's view of the backend sees a capture in progress
    capturing = types.SimpleNamespace(**vars(be))
    capturing.capturing = lambda device: True
    monkeypatch.setattr(bytestr, "be", capturing)
    under = bytestr.device_like_mask(d, "w0000_", device="cpu")
    assert int(under.sum()) == 10
    assert not any(k[0] == id(d) for k in bytestr._MASK_CACHE)
    assert not any(k[0] == id(d) for k in bytestr._PLANE_CACHE)
    monkeypatch.setattr(bytestr, "be", be)
    mask = bytestr.device_like_mask(d, "w0000_", device="cpu")
    assert mask is not under and int(mask.sum()) == 10
    assert bytestr.device_like_mask(d, "w0000_", device="cpu") is mask
    b2d, lens, _a, _e = bytestr._planes(d, "cpu")
    assert int(lens[0]) == 6 and lens.device.type == "cpu"


def test_no_host_reads_restored_after_failure():
    """The fused program's guard against host reads: a failure inside it
    leaves it off, and an inner block's exit leaves an outer one on."""
    import torch

    from lingodb_tpu_torch.ops import backend as be

    x = torch.arange(4)
    with pytest.raises(RuntimeError, match="program failed"):
        with be.no_host_reads():
            with pytest.raises(be.HostRead):
                be.to_host(x)
            raise RuntimeError("program failed")
    assert list(be.to_host(x)) == [0, 1, 2, 3]
    with be.no_host_reads():
        with be.no_host_reads():
            pass
        with pytest.raises(be.HostRead):
            be.to_host(x)
    assert list(be.to_host(x)) == [0, 1, 2, 3]


def test_wide_decimal_build_payload_declines_fusion(tiny_tpch):
    """q17: a fused join prep whose build side carries a wide-decimal (host
    object array) payload declines, so the eager path (which handles object
    columns) runs. Differential vs sqlite3 pins the value."""
    import sqlite3

    from lingodb_tpu_torch.tools import sqlite_oracle as so
    from lingodb_tpu_torch.tools import tpchgen

    s = tiny_tpch
    sql = open(os.path.join(QDIR, "17.sql")).read()
    r1 = s.sql(sql)
    r2 = s.sql(sql)
    assert r1.format_rows() == r2.format_rows()
    con = sqlite3.connect(":memory:")
    tpchgen.to_sqlite(con, tpchgen.generate_cached(0.005, 19920601))
    exp = con.execute(sql).fetchall()
    ok, msg = so.rows_equal(so.our_rows(r1), exp, ordered=False)
    assert ok, msg


def test_wide_decimal_scalar_broadcast_declines_fusion(tiny_tpch, monkeypatch,
                                                     reference_rows):
    """q22: a 1-row (scalar-subquery) build side whose payload is a
    wide-decimal host object array (avg(c_acctbal)) declines the fused
    program. Oracles: the same engine with fusion disabled, and the
    reference's rows."""
    from lingodb_tpu_torch.runtime.executor import Executor

    s = tiny_tpch
    sql = open(os.path.join(QDIR, "22.sql")).read()
    fused1 = s.sql(sql).format_rows()
    fused2 = s.sql(sql).format_rows()
    assert fused1 == fused2
    monkeypatch.setattr(
        Executor, "_try_fused_agg",
        lambda self, op, epi=None: (None, False) if epi is not None else None)
    monkeypatch.setattr(Executor, "_try_fused_chain",
                        lambda self, op, epi=None: None)
    monkeypatch.setattr(Executor, "_try_fused_topk", lambda self, op: None)
    eager = s.sql(sql).format_rows()
    assert fused1 == eager
    assert fused1 == reference_rows(22)


def test_promote_keeps_wide_decimal_columns_on_host():
    """device.promote (a demoted 1-row scalar-subquery result back to the
    session's device) passes host object columns through untouched; the
    other columns move."""
    import numpy as np

    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.runtime.vtable import SCol, VTable
    from lingodb_tpu_torch.sql.types import Type, K

    import torch

    wide = Type(K.DECIMAL, p=22, s=6)
    obj = np.array([int(10**20)], dtype=object)
    narrow = np.array([7], dtype=np.int64)
    vt = VTable({1: SCol(wide, obj, None, None),
                 2: SCol(Type(K.BIGINT), narrow, None, None)}, 1)
    out = dv.promote(vt, "cpu")
    assert out.col(1).data is obj
    assert isinstance(out.col(2).data, torch.Tensor)


def test_lineitem_supplier_pairs_exist_in_partsupp():
    """Generator self-check (the q9-empty bug): every lineitem
    (l_partkey, l_suppkey) pair must exist in partsupp, as dbgen guarantees
    (TPC-H spec 4.2.3) — otherwise every partsupp x lineitem join (q9, q20)
    is vacuously empty and the sqlite differential cannot notice."""
    import numpy as np

    from lingodb_tpu_torch.tools import tpchgen

    t = tpchgen.generate_cached(0.01, 19920601)
    ps_p = np.asarray(t["partsupp"].columns[0].data)
    ps_s = np.asarray(t["partsupp"].columns[1].data)
    li_p = np.asarray(t["lineitem"].columns[1].data)
    li_s = np.asarray(t["lineitem"].columns[2].data)
    bridge = set(zip(ps_p.tolist(), ps_s.tolist()))
    pairs = set(zip(li_p.tolist(), li_s.tolist()))
    missing = pairs - bridge
    assert not missing, f"{len(missing)} lineitem pairs missing from partsupp"


def test_q9_nonempty():
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.tools import tpchgen

    s = ldb.create_in_memory(device="cpu")
    tpchgen.load_into(s, sf=0.01)
    r = s.sql(open(os.path.join(QDIR, "9.sql")).read())
    assert len(r.format_rows()) > 0


@pytest.fixture()
def session():
    import lingodb_tpu_torch as ldb

    return ldb.create_in_memory(device="cpu")
