"""Grouped string keys with NULLs under string functions, set operations,
ROLLUP and CUBE, held against sqlite3 on both storage tiers.

The fused dense aggregate numbers a nullable key's NULL as the slot past
its dictionary's end. Its finish gives that row the code 0 (its validity
False), and the host path of `backend.lut_take` clamps codes into the
table, as `pgather.take_fast` does on a tensor. The JAX package raises
IndexError on these statements on the tensor tier, so sqlite3 is the
oracle: each runs through the port (device="cpu", the dispatcher on its
kernel route) and through sqlite3 over the same rows of t(id, v, d, s, b)
(40 rows made from a seed, NULLs in d, s and b) and u(k, e, s, w)
(lingodb_tpu_torch/tools/sqlite_battery.py). ROLLUP and CUBE are held
against their UNION ALL expansion. The last four statements (a grouped key
joined, intersected, and a correlated subquery on two keys) are ones the
port answered rightly before: they stay held against sqlite3 here."""

import sqlite3

import numpy as np
import pytest
import torch

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import backend as be
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.tools import sqlite_battery as sb
from lingodb_tpu_torch.tools import sqlite_oracle as so

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

TIERS = [dv.SMALL_ROWS, 2]
SETUP = sb.null_key_setup()
STATEMENTS = sb.NULL_KEY_STATEMENTS


@pytest.fixture(scope="module")
def engines():
    conn = sqlite3.connect(":memory:")
    old = pgather.FORCE_KERNELS, dv.SMALL_ROWS
    pgather.FORCE_KERNELS = True
    ps = {}
    for small_rows in TIERS:
        dv.SMALL_ROWS = small_rows  # read when a column is first uploaded
        ps[small_rows] = ldb.create_in_memory(device="cpu")
    for st in SETUP:
        conn.execute(st)
        for s in ps.values():
            s.sql_stmt(st)
    yield ps, conn
    conn.close()
    pgather.FORCE_KERNELS, dv.SMALL_ROWS = old


@pytest.mark.parametrize("small_rows", TIERS, ids=["host_tier", "tensor_tier"])
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_grouped_null_string_keys_equal_sqlite(engines, name, small_rows,
                                               monkeypatch):
    ps, conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", small_rows)
    sql, sqlite_sql = STATEMENTS[name]
    ours = so.our_rows(ps[small_rows].sql(sql))
    ok, msg = so.rows_equal(ours, so.run_sqlite(conn, sqlite_sql or sql),
                            ordered=False)
    assert ok, f"{sql}: {msg}"
    if name != "join_grouped_key":  # an inner join drops the NULL key
        assert any(v is None for r in ours for v in r), "no NULL in the result"


@pytest.mark.parametrize("keys", ["d", "d, s", "b, d"])
def test_grouped_null_key_keeps_a_code_inside_its_dictionary(engines, keys,
                                                            monkeypatch):
    ps, _conn = engines
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    res = ps[2].sql(f"SELECT {keys}, count(*) FROM t GROUP BY {keys}")
    for codes, valid, dictionary in zip(res.columns, res.valids,
                                        res.dictionaries):
        if dictionary is not None:
            assert valid is not None and not valid.all()
            assert 0 <= codes.min() and codes.max() < len(dictionary)


def test_host_lut_take_clamps_as_the_tensor_path_does():
    lut = np.array([10, 20, 30], np.int32)
    codes = np.array([-1, 0, 2, 3, 7], np.int32)
    tensor = pgather.take_fast(torch.from_numpy(lut), torch.from_numpy(codes))
    assert be.lut_take(lut, codes).tolist() == tensor.tolist() == [
        10, 10, 30, 30, 30]
    names = np.array(["a", "b"], dtype=object)
    assert be.lut_take(names, np.array([2, 1, 5])).tolist() == ["b", "b", "b"]
