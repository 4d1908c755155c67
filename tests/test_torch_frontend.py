"""The port's JAX-free front half (lexer, parser, binder, optimizer, plan
serialization) against lingodb_tpu's: the optimized plan JSON of every TPC-H
query must be equal on the same schema and data. Plus: the port runs with
`jax` and `lingodb_tpu` made unimportable."""

import glob
import os
import subprocess
import sys
import textwrap

import pytest

import lingodb_tpu as ref_ldb
from lingodb_tpu.tools import tpchgen as ref_tpchgen

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.tools import tpchgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERY_FILES = sorted(glob.glob(os.path.join(ROOT, "queries", "tpch", "*.sql")),
                     key=lambda p: int(os.path.basename(p).split(".")[0]))


@pytest.fixture(scope="module")
def pair():
    rs = ref_ldb.create_in_memory()
    ref_tpchgen.load_into(rs, sf=0.005, seed=19920601)
    ps = ldb.create_in_memory(device="cpu")
    tpchgen.install(ps, tpchgen.generate(0.005, 19920601))
    return rs, ps


def test_all_22_queries_are_present():
    assert len(QUERY_FILES) == 22


@pytest.mark.parametrize("path", QUERY_FILES,
                         ids=[os.path.basename(p) for p in QUERY_FILES])
def test_plan_json_equals_reference(pair, path):
    rs, ps = pair
    sql = open(path).read()
    assert ps.plan_json(sql) == rs.plan_json(sql)


def test_runs_with_jax_and_reference_blocked():
    """A fresh interpreter in which importing jax or lingodb_tpu fails must
    still import the port, load data and answer a query."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "lingodb_tpu"):
            sys.modules[name] = None   # any import of it raises ImportError
        import lingodb_tpu_torch as ldb
        from lingodb_tpu_torch.tools import tpchgen
        s = ldb.create_in_memory(device="cpu")
        tpchgen.install(s, tpchgen.generate(0.002, 1))
        rows = s.sql(open("queries/tpch/6.sql").read()).format_rows()
        assert len(rows) == 1 and len(rows[0]) == 1, rows
        rows = s.sql(open("queries/tpch/3.sql").read()).format_rows()
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m.split(".")[0] == "lingodb_tpu"]
        assert all(sys.modules[m] is None for m in bad), bad
        print("PORT_OK", len(rows))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PORT_OK" in out.stdout


def test_no_jax_import_in_the_port_sources():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|lingodb_tpu)\b", re.M)
    files = glob.glob(os.path.join(ROOT, "lingodb_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 30
    for f in files:
        assert not pat.search(open(f).read()), f
