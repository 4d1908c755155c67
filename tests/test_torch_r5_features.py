"""The port's counterpart of tests/test_r5_features.py: the fused TopK
epilogue (over an aggregate and over a chain), post-join mid-compaction,
learned dense key bounds, singleton-aggregate elimination and the
out-of-core chunked scan+aggregate, on the port's session (device="cpu")
against sqlite3, the oracle of the reference file. The reference reads its
learned key bounds from its stage cache's layout; here they are read where
the port keeps them (("fused_kbounds", basekey) in Session.stage_cache)
and the dense mode from the finish's meta."""

import os
import sqlite3

import numpy as np
import pytest

QDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "queries", "tpch")


@pytest.fixture(scope="module")
def sess():
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.runtime import device as dv
    from lingodb_tpu_torch.tools import tpchgen
    from lingodb_tpu_torch.utils import settings

    # single-device context: the fused chain/epilogue/bounded-dense paths
    # yield to the sharded mesh paths when a mesh is active
    settings.PARALLELISM.set("OFF")
    old_mesh, old_init = dv._MESH, dv._MESH_INIT
    dv._MESH, dv._MESH_INIT = None, True
    old = dv.SMALL_ROWS
    dv.SMALL_ROWS = 64
    s = ldb.create_in_memory(device="cpu")
    tables = tpchgen.load_into(s, sf=0.02)
    conn = sqlite3.connect(":memory:")
    tpchgen.to_sqlite(conn, tables)
    yield s, conn
    dv.SMALL_ROWS = old
    settings.PARALLELISM.set("")
    dv._MESH, dv._MESH_INIT = old_mesh, old_init


def _check(s, conn, q):
    from lingodb_tpu_torch.tools import sqlite_oracle as so

    sql = open(os.path.join(QDIR, f"{q}.sql")).read()
    theirs = so.run_sqlite(conn, sql)
    for run in (1, 2, 3):  # cold, possibly-rebuilt, steady state
        ok, msg = so.rows_equal(so.our_rows(s.sql(sql)), theirs,
                                ordered=True)
        assert ok, f"Q{q} run{run}: {msg}"


def test_fused_topk_over_aggregate_engages(sess):
    import lingodb_tpu_torch.runtime.executor as ex

    s, conn = sess
    hits = []
    orig = ex.Executor._try_fused_topk

    def spy(self, op):
        r = orig(self, op)
        hits.append(r is not None)
        return r

    ex.Executor._try_fused_topk = spy
    try:
        _check(s, conn, 3)
        _check(s, conn, 18)
    finally:
        ex.Executor._try_fused_topk = orig
    assert any(hits), "fused TopK epilogue did not engage"


def test_fused_chain_engages_and_matches(sess):
    import lingodb_tpu_torch.runtime.executor as ex

    s, conn = sess
    hits = []
    orig = ex.Executor._try_fused_chain

    def spy(self, op, epi=None):
        r = orig(self, op, epi=epi)
        if r is not None:
            hits.append(True)
        return r

    ex.Executor._try_fused_chain = spy
    try:
        for q in (2, 5, 7, 9):
            _check(s, conn, q)
    finally:
        ex.Executor._try_fused_chain = orig
    assert hits, "fused chain did not engage on q2/q5/q7/q9"


def test_mid_compaction_learns_and_matches(sess):
    s, conn = sess
    _check(s, conn, 18)
    caps = [v for k, v in s.stage_cache.items()
            if isinstance(k, tuple) and k[0] == "fused_stepcaps"]
    assert caps, "no step survivor counts learned"


def test_learned_key_bounds_dense_mode(sess, monkeypatch):
    import lingodb_tpu_torch.runtime.executor as ex

    s, conn = sess
    metas = []
    orig = ex.Executor._finish_fused_dense

    def spy(self, op, res, meta):
        metas.append(meta)
        return orig(self, op, res, meta)

    monkeypatch.setattr(ex.Executor, "_finish_fused_dense", spy)
    _check(s, conn, 7)
    learned = [v for k, v in s.stage_cache.items()
               if isinstance(k, tuple) and k[0] == "fused_kbounds"]
    assert [None, None, (1995, 1996)] in learned, learned
    bounded = [m for m in metas if m.get("mode") == "dense"
               and any(o is not None for o in (m.get("key_offsets") or []))]
    assert bounded, "bounded dense grouping did not engage on q7"


def test_singleton_agg_eliminated():
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.opt.optimizer import optimize
    from lingodb_tpu_torch.plan import logical as L
    from lingodb_tpu_torch.sql.binder import Binder
    from lingodb_tpu_torch.sql.parser import parse_sql

    s = ldb.create_in_memory(device="cpu")
    s.sql_stmt("CREATE TABLE t (k INT PRIMARY KEY, v DECIMAL(10,2))")
    s.sql_stmt("INSERT INTO t VALUES (1, 2.50), (2, 3.25), (3, NULL)")
    plan = optimize(Binder(s.catalog).bind_query(parse_sql(
        "SELECT k, SUM(v), MIN(v) FROM t GROUP BY k")[-1]), s.catalog)
    aggs = [n for n in L.walk_plan(plan) if isinstance(n, L.Aggregate)]
    assert not aggs, "singleton aggregate (group by primary key) survived"
    r = s.sql("SELECT k, SUM(v) AS sv, MIN(v) FROM t GROUP BY k ORDER BY k")
    assert r.format_rows() == [["1", "2.50", "2.50"], ["2", "3.25", "3.25"],
                               ["3", "NULL", "NULL"]]


def test_chunked_agg_multi_chunk_exact(sess):
    from lingodb_tpu_torch.utils import settings
    from lingodb_tpu_torch.tools import sqlite_oracle as so

    s, conn = sess
    old = settings.DEVICE_BYTE_BUDGET.get()
    # streams: lineitem's scanned bytes exceed the budget (at sf 0.02 in
    # one chunk of 2^18 rows, the smallest chunk, with a padded tail)
    settings.DEVICE_BYTE_BUDGET.set("2000000")
    try:
        for q in (6, 1):
            sql = open(os.path.join(QDIR, f"{q}.sql")).read()
            s.executor.last_chunked = None
            ok, msg = so.rows_equal(so.our_rows(s.sql(sql)),
                                    so.run_sqlite(conn, sql), ordered=True)
            assert ok, f"chunked Q{q}: {msg}"
            assert s.executor.last_chunked is not None
    finally:
        settings.DEVICE_BYTE_BUDGET.set(str(old))


@pytest.fixture()
def session():
    import lingodb_tpu_torch as ldb

    return ldb.create_in_memory(device="cpu")
