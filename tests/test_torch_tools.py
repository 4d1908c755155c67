"""The tools that drive the port (tools/cli.py, tester/runner.py,
tools/sqlite_oracle.py, tools/artifact.py, utils/perf.py) and its data
generators (tools/tpcdsgen.py, jobgen.py, suitegen.py), held against the JAX
package's on the same inputs, and the port's TPC-H rows against sqlite3.

Everything runs on the CPU: the tools are given `--device cpu`, the caller's
explicit ask for the host (without it and without a card they raise).
"""

import contextlib
import io
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

import lingodb_tpu as ref_ldb
from lingodb_tpu.tester import runner as ref_runner
from lingodb_tpu.tools import cli as ref_cli
from lingodb_tpu.tools import jobgen as ref_jobgen
from lingodb_tpu.tools import sqlite_oracle as ref_so
from lingodb_tpu.tools import suitegen as ref_suitegen
from lingodb_tpu.tools import tpcdsgen as ref_tpcdsgen

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.tester import runner
from lingodb_tpu_torch.tools import artifact, cli, jobgen, suitegen, tpcdsgen
from lingodb_tpu_torch.tools import sqlite_oracle as so
from lingodb_tpu_torch.tools import tpchgen
from lingodb_tpu_torch.utils.perf import PerfEvent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = [str(i) for i in range(1, 23)]
TEST_FILE = os.path.join(REPO, "tests", "data", "torch_basic.test")
DB_SF = 0.01  # lineitem 60k rows: the tensor tier, where the fused programs run


def _q(q: str) -> str:
    return os.path.join(REPO, "queries", "tpch", f"{q}.sql")


def _run(tool_main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool_main(argv)
    assert rc == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A persisted TPC-H database written by the port (the JAX package reads
    the same directory format)."""
    path = str(tmp_path_factory.mktemp("cli") / "tpch")
    s = ldb.connect_to_db(path, device="cpu")
    tpchgen.load_into(s, sf=DB_SF)
    s.close()
    return path


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("tool", ["sql-to-plan", "sql-to-json"])
def test_plan_text_equals_reference(db, tool, q):
    """The optimized plan as text and as JSON, printed by the port's CLI and
    by the JAX package's over the same database: equal."""
    got = _run(cli.main, [tool, _q(q), db, "--device", "cpu"])
    assert got == _run(ref_cli.TOOLS[tool], [_q(q), db])
    assert got.strip()


@pytest.mark.parametrize("q", ["1", "3", "6"])
def test_run_sql_prints_the_session_rows(db, q):
    got = _run(cli.main, ["run-sql", _q(q), db, "--device", "cpu"])
    s = ldb.connect_to_db(db, device="cpu")
    assert got == s.sql(open(_q(q)).read()).pretty(max_rows=10_000) + "\n"


def test_cli_needs_a_card_or_the_explicit_host(db):
    """Without --device the tools open a session on the card, and raise
    where there is none: they never fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run-sql", _q("6"), db])
    assert cli.main(["no-such-tool"]) == 2


def test_profile_prints_the_operator_profile(db, tmp_path):
    """The per-pass plans, the operator profile of PERF mode and the host
    counters' section (a notice where perf_event_open is refused)."""
    from lingodb_tpu_torch.utils import settings

    settings.SNAPSHOT_DIR.set(str(tmp_path))
    try:
        out = _run(cli.main, ["profile", _q("6"), db, "--device", "cpu"])
    finally:
        settings.EXECUTION_MODE.set("DEFAULT")
        settings.SNAPSHOT_PASSES.set(False)
        settings.SNAPSHOT_DIR.set(".")
    assert "== operator profile (self time) ==" in out
    assert "== after " in out and "TOTAL" in out
    assert "== host counters" in out


def test_profile_prints_sol_unknown_without_a_bandwidth(db, tmp_path):
    """With system.hbm_gbps unset (its default) each operator's line reads
    `sol=unknown`, with no multiplier sign; with it set, `sol=<n>x`."""
    from lingodb_tpu_torch.utils import settings

    def op_lines(out):
        head = out.index("== operator profile (self time) ==")
        return [ln for ln in out[head:].splitlines()[1:]
                if "rows=" in ln and "TOTAL" not in ln]

    settings.SNAPSHOT_DIR.set(str(tmp_path))
    try:
        out = _run(cli.main, ["profile", _q("6"), db, "--device", "cpu"])
        lines = op_lines(out)
        assert lines and all(ln.endswith("sol=unknown") for ln in lines), lines
        settings.HBM_GBPS.set(3350)
        out = _run(cli.main, ["profile", _q("6"), db, "--device", "cpu"])
        lines = op_lines(out)
        assert lines and all(ln.endswith("x") and "sol=unknown" not in ln
                             for ln in lines), lines
    finally:
        settings.HBM_GBPS.reset()
        settings.EXECUTION_MODE.set("DEFAULT")
        settings.SNAPSHOT_PASSES.set(False)
        settings.SNAPSHOT_DIR.set(".")


def test_artifact_runs_cold_without_parse_optimizer_or_calibration(db, tmp_path):
    """sql-to-artifact packages q3's plan with the capacities its fused
    programs learned; run-artifact in a fresh process gives the same rows
    with no parse, no optimizer and no calibration run (compilestats)."""
    art = str(tmp_path / "q3.lqa")
    s = ldb.connect_to_db(db, device="cpu")
    m = artifact.build_artifact(s, open(_q("3")).read(), art)
    assert m["capacities"] and m["platform"] == "cpu" and not m["kernels"]
    want = s.run_plan(m["plan"]).pretty(max_rows=10_000)
    cold = subprocess.run(
        [sys.executable, "-m", "lingodb_tpu_torch.tools.cli", "run-artifact",
         art, db, "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert cold.returncode == 0, cold.stderr[-3000:]
    assert cold.stdout == want + "\n"
    assert "parses=0 optimizations=0 calibrations=0" in cold.stderr, \
        cold.stderr[-2000:]


def test_artifact_rejects_stale_catalog(tmp_path):
    db = str(tmp_path / "db2")
    s = ldb.connect_to_db(db, device="cpu")
    s.sql_stmt("create table t(a int)")
    s.sql_stmt("insert into t values (1),(2),(3)")
    art = str(tmp_path / "t.lqa")
    artifact.build_artifact(s, "select sum(a) from t", art)
    s.sql_stmt("insert into t values (4)")  # bumps the table's version
    with pytest.raises(ValueError, match="different table versions"):
        artifact.run_artifact(s, art)
    assert artifact.run_artifact(s, art, strict=False).format_rows() == [["10"]]


@pytest.mark.parametrize("q", QUERIES)
def test_adapt_for_sqlite_equals_reference(q):
    sql = open(_q(q)).read()
    assert so.adapt_for_sqlite(sql) == ref_so.adapt_for_sqlite(sql)


@pytest.fixture(scope="module")
def tpch_sqlite():
    """The port's session and sqlite3 over the same TPC-H tables at the JAX
    package's oracle scale (tests/test_tpch.py)."""
    s = ldb.create_in_memory(device="cpu")
    tables = tpchgen.load_into(s, sf=0.005)
    conn = sqlite3.connect(":memory:")
    tpchgen.to_sqlite(conn, tables)
    return s, conn


# q19 and q21 take sqlite3 seconds at this scale; the card's smoke run
# holds all 22 against it
@pytest.mark.parametrize("q", [q for q in QUERIES if q not in ("19", "21")])
def test_tpch_rows_pass_the_sqlite_oracle(tpch_sqlite, q):
    s, conn = tpch_sqlite
    sql = open(_q(q)).read()
    ok, msg = so.rows_equal(so.our_rows(s.sql(sql)), so.run_sqlite(conn, sql),
                            ordered=True)
    assert ok, f"q{q}: {msg}"


@pytest.mark.parametrize("variant", ["as written", "one wrong expectation"])
def test_runner_stats_equal_reference(tmp_path, variant):
    """runner.run_file over an in-repo .test file (statements, typed
    queries under each sort mode, NULLs, a UDF, an expected error, a hashed
    record): the same TestStats as the JAX package's runner, also on a copy
    with one wrong expectation."""
    path = TEST_FILE
    if variant != "as written":
        text = open(TEST_FILE).read()
        assert "\n12.50\n" in text
        path = str(tmp_path / "wrong.test")
        with open(path, "w") as f:
            f.write(text.replace("\n12.50\n", "\n12.75\n"))
    got = runner.run_file(ldb.create_in_memory(device="cpu"), path,
                          stop_on_error=False)
    want = ref_runner.run_file(ref_ldb.create_in_memory(), path,
                               stop_on_error=False)
    assert (got.statements, got.queries, len(got.failures)) == (
        want.statements, want.queries, len(want.failures))
    assert [f[0] for f in got.failures] == [f[0] for f in want.failures]
    assert len(got.failures) == (0 if variant == "as written" else 1)
    assert got.queries >= 10


def test_perf_event_counts_or_stays_off():
    """PerfEvent counts where the kernel allows perf_event_open, and is a
    no-op (no counters, nothing left open) where it does not."""
    with PerfEvent() as pe:
        for _ in range(5):
            np.arange(500_000).sum()
    assert not pe.fds
    if pe.supported:
        assert any(v > 0 for v in pe.counters.values())
    else:
        assert pe.counters == {}


def _tables_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        assert g.column_names == w.column_names, name
        assert [str(t) for t in g.column_types] == [str(t) for t in
                                                    w.column_types], name
        assert g.num_rows == w.num_rows, name
        for cname, gc, wc in zip(w.column_names, g.columns, w.columns):
            where = f"{name}.{cname}"
            gd, wd = np.asarray(gc.data), np.asarray(wc.data)
            assert gd.dtype == wd.dtype and np.array_equal(gd, wd), where
            assert (gc.valid is None) == (wc.valid is None), where
            if wc.valid is not None:
                assert np.array_equal(gc.valid, wc.valid), where
            assert (gc.dictionary is None) == (wc.dictionary is None), where
            if wc.dictionary is not None:
                assert list(gc.dictionary) == list(wc.dictionary), where


SUITE_SCHEMA = """
create table dim (d_key int primary key, d_name varchar(20), d_price decimal(8,2));
create table fact (f_id int, f_d_key int, f_amount double, f_day date,
                   f_note varchar(30));
"""
SUITE_QUERIES = [
    "select d_name, sum(f_amount) from fact, dim where f_d_key = d_key "
    "and d_name like '%blue%' and f_amount > 12.5 group by d_name;",
    "select count(*) from fact where f_note in ('urgent', 'late') and "
    "f_day between date '1997-01-01' and date '1997-12-31';",
]


@pytest.mark.parametrize("gen", ["tpcdsgen", "jobgen", "suitegen"])
def test_generators_bit_equal_reference(gen, tmp_path):
    """Each generator's tables equal the JAX generator's for the same scale
    and seed, column by column: data, validity and dictionaries."""
    if gen == "tpcdsgen":
        _tables_equal(tpcdsgen.generate(0.002, 7), ref_tpcdsgen.generate(0.002, 7))
        return
    if gen == "jobgen":
        _tables_equal(jobgen.generate(0.01, 11), ref_jobgen.generate(0.01, 11))
        return
    suite = tmp_path / "suite"
    suite.mkdir()
    (suite / "schema.sql").write_text(SUITE_SCHEMA)
    for i, q in enumerate(SUITE_QUERIES):
        (suite / f"q{i}.sql").write_text(q)
    ps = ldb.create_in_memory(device="cpu")
    rs = ref_ldb.create_in_memory()
    got = suitegen.load_suite(ps, str(suite), str(suite / "schema.sql"),
                              rows=500, dim_rows=40, seed=5)
    want = ref_suitegen.load_suite(rs, str(suite), str(suite / "schema.sql"),
                                   rows=500, dim_rows=40, seed=5)
    assert got == want
    _tables_equal({n: ps.catalog.get_table(n).storage for n in want},
                  {n: rs.catalog.get_table(n).storage for n in want})
