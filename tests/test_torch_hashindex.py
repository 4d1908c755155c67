"""The port's counterpart of tests/test_hashindex.py (persisted hash-index
payloads): the same cases on the port's sessions (device="cpu") with the
port's hashindex.STATS, each held against the JAX package on the same
statements, and a database persisted with an index by either package
opened in the other. What the reference file says of its subject:

Persistent hash-index payloads: CREATE INDEX writes `<index>.idx`, and a
reopened database LOADS the payload instead of rebuilding it (reference:
src/runtime/LingoDBHashIndex.cpp — file-backed index, flushed on append,
loaded on open)."""

import os

import numpy as np
import pytest

import lingodb_tpu as ref_ldb
import lingodb_tpu_torch as ldb
from lingodb_tpu.storage import hashindex as ref_hx
from lingodb_tpu_torch.storage import hashindex as hx

JOIN_SQL = ("select l.okey, sum(l.qty) s from lines l, orders o "
            "where l.okey = o.okey group by l.okey order by l.okey")


def _reset_stats():
    for k in hx.STATS:
        hx.STATS[k] = 0


def _orders_db(s):
    """Two tables and an index on the build side's key, as the reference
    file makes them."""
    s.sql_stmt("create table orders(okey bigint, cust int)")
    rows = ",".join(f"({i * 3 + 7},{i % 50})" for i in range(2000))
    s.sql_stmt(f"insert into orders values {rows}")
    s.sql_stmt("create table lines(okey bigint, qty int)")
    lrows = ",".join(f"({(i * 7) % 6000},{i % 9})" for i in range(4000))
    s.sql_stmt(f"insert into lines values {lrows}")
    s.sql_stmt("create index orders_pk on orders(okey)")


def _open(pkg, d):
    return (ldb.connect_to_db(d, device="cpu") if pkg is ldb
            else pkg.connect_to_db(d))


def test_index_payload_persists_and_reloads(tmp_path):
    db = str(tmp_path / "db")
    s = ldb.connect_to_db(db, device="cpu")
    _reset_stats()
    _orders_db(s)
    assert hx.STATS["builds"] == 1 and hx.STATS["saves"] == 1
    assert os.path.exists(os.path.join(db, "orders_pk.idx"))
    expected = s.sql(JOIN_SQL).format_rows()
    s.close()

    # reopen: the payload must LOAD, not rebuild
    s2 = ldb.connect_to_db(db, device="cpu")
    _reset_stats()
    got = s2.sql(JOIN_SQL).format_rows()
    assert got == expected and len(got) > 100
    assert hx.STATS["loads"] >= 1, "persisted payload was not consumed"
    assert hx.STATS["builds"] == 0, "index was rebuilt despite .idx file"
    s2.close()
    # the JAX package's rows for the same statements
    rs = ref_ldb.create_in_memory()
    _orders_db(rs)
    assert got == rs.sql(JOIN_SQL).format_rows()


def _payloads(tmp_path, sql, index):
    """Persist `sql` with each package; the loaded payloads of `index`."""
    out = {}
    for name, pkg, mod in (("port", ldb, hx), ("ref", ref_ldb, ref_hx)):
        db = str(tmp_path / name)
        s = _open(pkg, db)
        for q in sql:
            s.sql_stmt(q)
        s.close()  # save() must rewrite the payload at the new row count
        out[name] = mod.load(os.path.join(db, f"{index}.idx"))
    return out


def _same_payload(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], (np.ndarray, list)):
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        else:
            assert a[k] == b[k], k


def test_index_payload_refreshes_on_append(tmp_path):
    got = _payloads(tmp_path, [
        "create table t(k int, v int)",
        "insert into t values (1,10),(2,20),(3,30)",
        "create index t_k on t(k)",
        "insert into t values (4,40)"],  # payload now stale
        "t_k")
    p = got["port"]
    assert p is not None and p["rows"] == 4
    assert p["kind"] == "dense"
    lut = np.asarray(p["lut"])
    assert lut[4 - p["kmin"]] == 3  # key 4 -> row 3
    _same_payload(p, got["ref"])


def test_sorted_payload_for_duplicate_keys(tmp_path):
    got = _payloads(tmp_path, [
        "create table d(k int, v int)",
        "insert into d values (5,1),(5,2),(9,3)",
        "create index d_k on d(k)"], "d_k")
    p = got["port"]
    assert p is not None and p["kind"] == "sorted"
    assert list(p["keys"]) == [5, 5, 9]
    _same_payload(p, got["ref"])


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_indexed_database_opens_in_the_other_package(tmp_path, src, dst):
    """A database persisted with `create index` by one package opens in the
    other with its index and the same join rows; the port loads the
    persisted payload rather than building it."""
    pkgs = {"ref": ref_ldb, "port": ldb}
    db = str(tmp_path / "db")
    s = _open(pkgs[src], db)
    _orders_db(s)
    want = s.sql(JOIN_SQL).format_rows()
    s.close()
    _reset_stats()
    other = _open(pkgs[dst], db)
    assert other.catalog.get_table("orders").index_on(["okey"]) == "orders_pk"
    got = other.sql(JOIN_SQL).format_rows()
    assert got == want and len(got) > 100
    if dst == "port":
        assert hx.STATS["builds"] == 0 and hx.STATS["loads"] >= 1
    other.close()
