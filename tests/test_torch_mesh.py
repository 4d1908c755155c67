"""The port's sharded operators on the 22 TPC-H queries, and the mesh it
builds (lingodb_tpu_torch/runtime/device.get_mesh).

The setup of the JAX package's tests/test_mesh.py: sf 0.002, SMALL_ROWS
64, on a mesh of 8 positions (here 8 x "cpu"). With the production
system.shuffle_min_rows (65,536) no sharded entry point engages at this
scale (lineitem has about 12,000 rows), so it is set to 32, and the rows
of every query are held against sqlite3 and the port's one-card session.
The JAX package's meshed run of the 22 takes about 40 s on this machine's
CPU, so the comparison with it is left to tests/test_torch_shuffle.py.
"""

import os
import sqlite3

import pytest
import torch

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.parallel import mesh as msh
from lingodb_tpu_torch.parallel import shuffle as sh
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_oracle as so
from lingodb_tpu_torch.tools import tpchgen
from lingodb_tpu_torch.utils import settings

QDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "queries", "tpch")
SF, SEED = 0.002, 19920601


@pytest.fixture(scope="module")
def sessions():
    """(meshed session, one-card session, sqlite3 connection, mesh, the
    STATS moved by each query)."""
    old_small, old_mesh = dv.SMALL_ROWS, (dv._MESH, dv._MESH_INIT)
    dv.SMALL_ROWS = 64
    settings.set_setting("system.shuffle_min_rows", 32)
    tables = tpchgen.generate(SF, SEED)
    meshed = ldb.create_in_memory(device="cpu")
    one = ldb.create_in_memory(device="cpu")
    tpchgen.install(meshed, tables)
    tpchgen.install(one, tables)
    conn = sqlite3.connect(":memory:")
    tpchgen.to_sqlite(conn, tables)
    yield meshed, one, conn, msh.Mesh(["cpu"] * 8), {}
    dv.SMALL_ROWS = old_small
    dv._MESH, dv._MESH_INIT = old_mesh
    settings.SHUFFLE_MIN_ROWS.reset()


def _run(q, sessions):
    """(meshed result, one-card result) of query q; the STATS it moved are
    kept in the fixture's dict."""
    meshed, one, _conn, mesh, moved = sessions
    sql = open(os.path.join(QDIR, f"{q}.sql")).read()
    dv._MESH, dv._MESH_INIT = None, True
    want = one.sql(sql)
    before = dict(sh.STATS)
    dv._MESH = mesh
    try:
        got = meshed.sql(sql)
    finally:
        dv._MESH = None
    moved[q] = {k: sh.STATS[k] - before[k] for k in sh.STATS}
    return sql, got, want


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_mesh_query_matches_oracle_and_one_card(q, sessions):
    sql, got, want = _run(q, sessions)
    assert got.format_rows() == want.format_rows(), f"Q{q}: mesh != one card"
    ok, msg = so.rows_equal(so.our_rows(got), so.run_sqlite(sessions[2], sql),
                            ordered=True)
    assert ok, f"Q{q}: {msg}"


def test_mesh_queries_engage_every_strategy(sessions):
    """Over the 22 queries the sharded join, both groupings and the sample
    sort each ran (the counters of the queries run above; a query not run
    yet runs here)."""
    moved = sessions[4]
    for q in range(1, 23):
        if q not in moved:
            _run(q, sessions)
    total = {k: sum(m[k] for m in moved.values()) for k in sh.STATS}
    assert total["joins"] >= 10 and total["groupbys"] >= 10, total
    assert total["sorts"] >= 1 and total["exchanges"] >= 30, total


def test_get_mesh_none_without_two_cards(monkeypatch):
    """No mesh on the CPU, on one card, or with system.parallelism OFF;
    over two cards a host-major mesh of both (no tensor is made)."""
    from lingodb_tpu_torch.parallel import multihost as mh

    monkeypatch.setattr(dv, "_MESH", None)
    monkeypatch.setattr(dv, "_MESH_INIT", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dv.get_mesh() is None
    assert dv._MESH_INIT and dv.get_mesh() is None  # decided once

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mh, "initialize", lambda **k: False)
    for count, want in ((1, None), (2, ["cuda:0", "cuda:1"]),
                        (4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        dv._MESH, dv._MESH_INIT = None, False
        m = dv.get_mesh()
        assert (m is None) if want is None else \
            ([str(d) for d in m.devices] == want and m.axis_names == ("dp",)
             and not m.spans_processes())
    dv._MESH, dv._MESH_INIT = None, False
    settings.PARALLELISM.set("OFF")
    try:
        assert dv.get_mesh() is None
    finally:
        settings.PARALLELISM.reset()


def test_shard_column_pads_to_the_axis():
    import numpy as np

    mesh = msh.Mesh(["cpu"] * 8)
    a = np.arange(13, dtype=np.int64)
    s, rows = dv.shard_column(a, mesh)
    assert rows == 13 and s.local_len == 2
    got = np.concatenate([t.numpy() for t in s.shards])
    assert np.array_equal(got, np.concatenate([a, np.zeros(3, np.int64)]))
