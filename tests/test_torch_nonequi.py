"""The port's chunked non-equi join held against the JAX package.

The inputs of tests/test_nonequi.py: a(x, av) with 9,000 rows and b(y, bv)
with 8,000, 72M candidate pairs, more than the 2^26 pair buffer, so the left
side streams in chunks of 2^26 // 8,000 = 8,388 rows: 2 chunks, of 8,388
and 612 rows. The five join kinds (inner, semi, anti, left, full) run
through `lingodb_tpu` and `lingodb_tpu_torch` (device="cpu") on the same
rows; a full join's matched right rows are carried across the chunk edge.
Each reference answer is computed once for the module.
"""

import numpy as np
import pytest

import lingodb_tpu as ref_ldb

import lingodb_tpu_torch as ldb

pytestmark = pytest.mark.filterwarnings("error:__array_wrap__")

QUERIES = {
    "inner": "select count(*), sum(a.av + b.bv) from a, b"
             " where a.x < b.y and b.y - a.x < 3",
    "semi": "select count(*) from a where exists"
            " (select 1 from b where b.y > a.x + 990)",
    "anti": "select count(*) from a where not exists"
            " (select 1 from b where b.y > a.x + 990)",
    # tests/test_nonequi.py's left join has an equi term (b.y = a.x + 1)
    # that the binder extracts; this one has none, so it takes the chunks
    "left": "select a.x, count(b.bv), sum(b.y) from a left join b"
            " on b.y > a.x + 995 and b.bv < 2"
            " group by a.x order by a.x",
    "full": "select count(*), count(a.x), count(b.y) from a full outer join b"
            " on b.y - a.x = 500 and a.av > 45 and b.bv > 45",
}
_WANT: dict = {}


@pytest.fixture(scope="module")
def sessions():
    import pyarrow as pa

    rng = np.random.default_rng(3)
    na, nb = 9000, 8000  # 72M pairs > 2^26
    ax = rng.integers(0, 1000, na).astype("int64")
    av = rng.integers(0, 50, na).astype("int64")
    by = rng.integers(0, 1000, nb).astype("int64")
    bv = rng.integers(0, 50, nb).astype("int64")
    a = pa.table({"x": pa.array(ax), "av": pa.array(av)})
    b = pa.table({"y": pa.array(by), "bv": pa.array(bv)})
    rs = ref_ldb.create_in_memory()
    ps = ldb.create_in_memory(device="cpu")
    for s in (rs, ps):
        s.add_table("a", a)
        s.add_table("b", b)
    return rs, ps


@pytest.mark.parametrize("kind", list(QUERIES))
def test_chunked_nonequi_join_equals_reference(sessions, kind):
    rs, ps = sessions
    q = QUERIES[kind]
    if kind not in _WANT:
        _WANT[kind] = rs.sql(q).format_rows()
    ps.executor.last_nonequi_chunks = None
    assert ps.sql(q).format_rows() == _WANT[kind]
    assert ps.executor.last_nonequi_chunks == 2
