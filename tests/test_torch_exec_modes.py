"""The port's counterpart of tests/test_exec_modes.py (execution modes DEBUG
and PERF and the hardware counters): the same cases on the port's sessions
(device="cpu"), asserting the values the reference file asserts. What the
reference file says of its subject:

Execution modes + hardware counters.

DEBUG mode = the reference's verification backend (CPULLVMDebugBackend,
LLVMBackends.cpp:939-1010): every operator's output is invariant-checked.
PERF mode = per-operator profile (the perf-record wrapping analogue).
utils/perf.py = PerfEvent (include/lingodb/utility/PerfEvent.h) via
perf_event_open, software-counter fallback on PMU-less VMs.
"""

import pytest


DDL = "create table t (g int, v int, s varchar(8))"
ROWS = ("insert into t values (1,10,'a'),(1,20,'b'),(2,30,'a'),"
        "(2,null,'c'),(3,5,null)")


@pytest.fixture()
def dbg_session():
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.utils.settings import EXECUTION_MODE

    s = ldb.create_in_memory(device="cpu")
    s.sql_stmt(DDL)
    s.sql_stmt(ROWS)
    yield s, EXECUTION_MODE
    EXECUTION_MODE.set("DEFAULT")


QUERIES = [
    "select g, sum(v), count(*) from t group by g order by g",
    "select a.g, b.v from t a join t b on a.g = b.g where b.v > 10 order by a.g, b.v",
    "select g, v, rank() over (partition by g order by v) from t order by g, v",
    "select s, count(*) from t group by s order by s nulls first",
    "with recursive r(n) as (select 1 union all select n+1 from r where n<4)"
    " select sum(n) from r",
]


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's rows of QUERIES on the same table (its DEFAULT
    mode): the reference file computes its expected rows at run time."""
    import lingodb_tpu as ref_ldb

    r = ref_ldb.create_in_memory()
    r.sql_stmt(DDL)
    r.sql_stmt(ROWS)
    return [r.sql(q).format_rows() for q in QUERIES]


def test_debug_mode_queries_pass(dbg_session, reference_rows):
    s, mode = dbg_session
    mode.set("DEBUG")
    debug = [s.sql(q).format_rows() for q in QUERIES]
    mode.set("DEFAULT")
    plain = [s.sql(q).format_rows() for q in QUERIES]
    assert debug == reference_rows
    assert plain == reference_rows


def test_debug_mode_catches_bad_output(dbg_session):
    """Force a broken operator result and check DEBUG flags it."""
    import numpy as np

    from lingodb_tpu_torch.runtime.executor import ExecError
    from lingodb_tpu_torch.runtime.vtable import VTable

    s, mode = dbg_session
    mode.set("DEBUG")
    ex = s.executor
    orig = ex._run_scan

    def broken(op):
        vt = orig(op)
        if vt.num_rows:
            first = next(iter(vt.cols))
            bad = dict(vt.cols)
            bad[first] = bad[first].take(np.zeros(1, np.int64))
            return VTable(bad, vt.num_rows)  # column length != num_rows
        return vt

    ex._run_scan = broken
    try:
        with pytest.raises(ExecError, match="DEBUG"):
            s.sql("select v, s from t order by v")
    finally:
        ex._run_scan = orig


def test_perf_mode_profile(dbg_session):
    s, mode = dbg_session
    mode.set("PERF")
    s.sql("select g, sum(v) from t group by g order by g")
    prof = s.executor.last_op_profile
    # name, self_ms, rows, incl_ms, bytes, sol_ratio
    assert prof and all(len(rec) == 6 for rec in prof)
    names = [rec[0] for rec in prof]
    assert any("Aggregate" in n or "Scan" in n for n in names)
    assert all(rec[4] >= 0 for rec in prof)  # bytes accounted per operator
    assert any(rec[4] > 0 for rec in prof)


def test_perf_event_counters():
    import numpy as np

    from lingodb_tpu_torch.utils.perf import PerfEvent

    with PerfEvent() as pe:
        for _ in range(5):
            np.arange(500_000).sum()
    if not pe.supported:
        pytest.skip("perf_event_open unavailable in this kernel/container")
    assert any(v > 0 for v in pe.counters.values())

