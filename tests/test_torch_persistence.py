"""The port's counterpart of tests/test_persistence.py (catalog and Arrow IPC
persistence): the same cases on the port's sessions (device="cpu"),
asserting the values the reference file asserts. What the reference file
says of its subject:

Catalog + Arrow IPC persistence round trip
(reference: LingoDBTable.cpp:27-54 load/store, Catalog persist-on-shutdown).
"""

import pytest

import os


@pytest.fixture()
def session():
    import lingodb_tpu_torch as ldb

    return ldb.create_in_memory(device="cpu")


def test_save_load_roundtrip(tmp_path):
    import lingodb_tpu_torch as ldb

    db = str(tmp_path / "db")
    os.makedirs(db)
    s = ldb.connect_to_db(db, device="cpu")
    s.sql("create table t (a int not null, b varchar(10), c decimal(8,2), d date)")
    s.sql(
        "insert into t values (1,'x',1.25,'2020-01-02'),"
        "(2,null,null,null),(3,'yy',99.99,'1999-12-31')"
    )
    s.close()  # persists catalog + arrow files

    s2 = ldb.connect_to_db(db, device="cpu")
    r = s2.sql("select a, b, c, d from t order by a")
    rows = r.format_rows()
    assert rows == [
        ["1", "x", "1.25", "2020-01-02"],
        ["2", "NULL", "NULL", "NULL"],
        ["3", "yy", "99.99", "1999-12-31"],
    ]


def test_to_arrow(session):
    session.sql("create table t (a int not null, b varchar(5))")
    session.sql("insert into t values (1,'p'),(2,null)")
    tbl = session.sql("select * from t order by a").to_arrow()
    assert tbl.num_rows == 2
    assert tbl.column("a").to_pylist() == [1, 2]
    assert tbl.column("b").to_pylist() == ["p", None]


def test_hash_index_roundtrip(tmp_path):
    """CREATE INDEX persists in the catalog and joins through it stay correct
    (reference: IndexCatalogEntry / LingoDBHashIndex, index-nested-loop joins
    map to cached direct lookup tables on the device)."""
    import lingodb_tpu_torch as ldb

    db = str(tmp_path / "db")
    os.makedirs(db)
    s = ldb.connect_to_db(db, device="cpu")
    s.sql("create table dim (id int, name varchar(5))")
    s.sql("insert into dim values (1,'a'),(50000,'b'),(3,'c')")
    s.sql("create index dim_pk on dim(id)")
    s.sql("create table f (k int, v int)")
    s.sql("insert into f values (1,10),(50000,20),(3,30),(7,40)")
    s.close()

    s2 = ldb.connect_to_db(db, device="cpu")
    assert s2.catalog.get_table("dim").index_on(["id"]) == "dim_pk"
    r = s2.sql("select d.name, sum(f.v) from f, dim d where f.k=d.id "
               "group by d.name order by d.name")
    assert r.format_rows() == [["a", "10"], ["b", "20"], ["c", "30"]]

