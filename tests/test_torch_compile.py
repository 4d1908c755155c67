"""The port's compile-cache layer against the JAX package: the fused
programs' store (runtime/exestore.py), the learned capacities kept across
sessions (utils/capstore.py), the counters (utils/compilestats.py) and
execution mode PERF.

Both engines read the same generated TPC-H tables (sf 0.01, seed 19920601)
on one device with tables of 64 rows and more on the tensor tier, as
tests/test_torch_fused.py sets them. The port runs on device="cpu", where
the store runs its bookkeeping around a stand-in capture (the program is
called, not captured) and the kernel wrappers run their plain versions.
`format_rows()` must equal the reference's string for string.
"""

import os
import re

import pytest
import torch

import lingodb_tpu as ref_ldb
from lingodb_tpu.runtime import device as ref_dv
from lingodb_tpu.tools import tpchgen as ref_tpchgen
from lingodb_tpu.utils import settings as ref_settings

import lingodb_tpu_torch as ldb
from lingodb_tpu_torch.ops import pgather
from lingodb_tpu_torch.ops import scalar as sc
import lingodb_tpu_torch.runtime.executor as ex
from lingodb_tpu_torch.runtime import device as dv
from lingodb_tpu_torch.runtime import fused as F
from lingodb_tpu_torch.runtime import exestore
from lingodb_tpu_torch.tools import carry, sql_battery, tpchgen
from lingodb_tpu_torch.utils import capstore, compilestats
from lingodb_tpu_torch.utils.settings import CAPSTORE_DIR, EXECUTION_MODE

SF = 0.01
SEED = 19920601
QUERIES = ["1", "3", "6", "10", "18"]


def _sql(q):
    return open(os.path.join("queries", "tpch", f"{q}.sql")).read()


def _extract(ref_tables) -> dict:
    import numpy as np

    out = {}
    for name, st in ref_tables.items():
        cols = []
        for cname, col in zip(st.column_names, st.columns):
            cols.append((cname, str(col.type), np.asarray(col.data),
                         None if col.valid is None else np.asarray(col.valid),
                         None if col.dictionary is None
                         else np.asarray(col.dictionary, dtype=object)))
        out[name] = {"columns": cols, "sorted_cols": tuple(st.sorted_cols)}
    return out


@pytest.fixture(scope="module")
def env():
    """(reference session, carried tables, the reference's rows by query)."""
    ref_settings.PARALLELISM.set("OFF")
    old_mesh = ref_dv._MESH, ref_dv._MESH_INIT
    ref_dv._MESH, ref_dv._MESH_INIT = None, True
    old_ref_rows = ref_dv.SMALL_ROWS
    ref_dv.SMALL_ROWS = 64
    rs = ref_ldb.create_in_memory()
    carried = carry.tables_from_numpy(
        _extract(ref_tpchgen.load_into(rs, sf=SF, seed=SEED)))
    want = {q: rs.sql(_sql(q)).format_rows() for q in QUERIES}
    old_rows, old_force = dv.SMALL_ROWS, pgather.FORCE_KERNELS
    dv.SMALL_ROWS = 64
    pgather.FORCE_KERNELS = True
    yield rs, carried, want
    dv.SMALL_ROWS, pgather.FORCE_KERNELS = old_rows, old_force
    ref_dv._MESH, ref_dv._MESH_INIT = old_mesh
    ref_dv.SMALL_ROWS = old_ref_rows
    ref_settings.PARALLELISM.set("")


def _session(carried):
    s = ldb.create_in_memory(device="cpu")
    tpchgen.install(s, carried)
    return s


@pytest.fixture
def store_dir(tmp_path):
    """system.capstore_dir set to a fresh directory, the in-memory copy of
    the store forgotten before and after."""
    capstore.reset()
    CAPSTORE_DIR.set(str(tmp_path))
    yield tmp_path
    CAPSTORE_DIR.reset()
    capstore.reset()


@pytest.mark.parametrize("q", QUERIES)
def test_second_run_builds_nothing(env, q, monkeypatch):
    """A repeated query calibrates, builds and captures nothing: its fused
    programs replay. Every run's rows equal the reference's. The host
    decides which runs calibrate: no capture holds a calibrating program,
    and every capture of the first run is kept."""
    _rs, carried, want = env
    s = _session(carried)
    put = exestore.GraphStore._put
    calibrating = []

    def spy(store, key, program, inputs):
        e = put(store, key, program, inputs)
        calibrating.append(bool(e.meta.get("calibrating")))
        return e

    monkeypatch.setattr(exestore.GraphStore, "_put", spy)
    deltas = []
    for _ in range(3):
        before = compilestats.snapshot()
        assert s.sql(_sql(q)).format_rows() == want[q]
        deltas.append(compilestats.delta(before))
    assert deltas[0]["captures"] >= 1 and s.exestore.entries
    assert not any(calibrating)
    assert deltas[0]["captures"] == len(s.exestore.entries)
    for d in deltas[1:]:
        assert (d["calibrations"], d["builds"], d["captures"]) == (0, 0, 0), d
        assert d["replays"] >= 1, d


@pytest.mark.parametrize("q", ["11", "16", "21"])
def test_prepared_path_runs_what_sql_runs(env, q):
    """C5 (q11, q16 and q21 through prepare + execute_prepared read 5-30x
    their Session.sql wall on the card, once a run): once a query's
    programs are captured, execute_prepared replays exactly what
    Session.sql replays and captures, calibrates, builds, uploads and
    evicts nothing, and the store keeps the same entries; rows equal."""
    _rs, carried, _want = env
    s = _session(carried)
    for _ in range(3):
        rows = s.sql(_sql(q)).format_rows()
    entries = set(s.exestore.entries)
    before = compilestats.snapshot()
    assert s.sql(_sql(q)).format_rows() == rows
    by_sql = compilestats.delta(before)
    prepared = s.prepare(_sql(q))
    before = compilestats.snapshot()
    assert s.execute_prepared(prepared).format_rows() == rows
    by_prepared = compilestats.delta(before)
    kept = ("captures", "calibrations", "builds", "uploads", "evictions",
            "replays")
    assert {k: by_prepared[k] for k in kept} == {k: by_sql[k] for k in kept}
    assert by_sql["replays"] >= 1 and not any(
        by_sql[k] for k in kept if k != "replays"), by_sql
    assert set(s.exestore.entries) == entries


@pytest.mark.parametrize("q", ["3", "18"])
def test_capstore_carries_capacities_across_sessions(env, store_dir, q):
    """With system.capstore_dir set, a fresh session (a new stage cache, the
    store's in-memory copy forgotten) finds the capacities the first
    session learned: it makes no calibration run."""
    _rs, carried, want = env
    before = compilestats.snapshot()
    assert _session(carried).sql(_sql(q)).format_rows() == want[q]
    assert compilestats.delta(before)["calibrations"] >= 1
    assert (store_dir / "capacities.json").exists()
    capstore.reset()
    fresh = _session(carried)
    before = compilestats.snapshot()
    assert fresh.sql(_sql(q)).format_rows() == want[q]
    d = compilestats.delta(before)
    assert d["calibrations"] == 0 and d["captures"] >= 1, d


def test_corrupt_capstore_reads_as_a_miss(env, store_dir):
    """A store file that does not parse is an empty store: the session
    calibrates, returns the reference's rows and writes the file anew."""
    _rs, carried, want = env
    (store_dir / "capacities.json").write_text("{not json")
    assert capstore.get("anything") is None
    before = compilestats.snapshot()
    assert _session(carried).sql(_sql("3")).format_rows() == want["3"]
    assert compilestats.delta(before)["calibrations"] >= 1
    import json

    stored = json.loads((store_dir / "capacities.json").read_text())
    assert any(k.startswith("kbounds::") for k in stored)


def test_capstore_merges_with_the_file(store_dir):
    """A write keeps the keys another session wrote since the file was
    read; without a directory nothing is stored."""
    capstore.put("a", 1)
    import json

    path = store_dir / "capacities.json"
    other = json.loads(path.read_text())
    other["b"] = {"0": 7}
    path.write_text(json.dumps(other))
    capstore.put("c", [1, None])
    assert json.loads(path.read_text()) == {"a": 1, "b": {"0": 7},
                                            "c": [1, None]}
    CAPSTORE_DIR.set("")
    capstore.put("d", 1)
    assert capstore.get("a") is None
    assert "d" not in json.loads(path.read_text())


class _FakeGraphs:
    """A stand-in capture and replay that record what the store did."""

    def __init__(self):
        self.captured, self.replayed = [], []

    def capture(self, store, program, inputs):
        static = [t.clone() for t in inputs]
        res, meta = program(static)
        self.captured.append(meta.get("tag"))
        return exestore.Entry(program, static, res, meta,
                              launches={"gather_sorted": 3})

    def replay(self, entry):
        self.replayed.append(entry.meta.get("tag"))


def test_graph_store_bookkeeping(monkeypatch):
    """The store captures a key once and replays it after (its inputs
    copied into the static ones first), adds the launches its capture
    counted to pgather.LAUNCHES at every replay, drops a plan's other
    table versions when it puts a key, drops a basekey on a rebuild and
    everything on clear; a meta that holds a tensor is refused."""
    fake = _FakeGraphs()
    store = exestore.GraphStore("cpu", capture=fake.capture,
                                replay=fake.replay)
    bk1 = ("fused_agg", "plan", (("t", 1),))
    bk2 = ("fused_agg", "plan", (("t", 2),))

    def prog(tag, **meta):
        return lambda static: ({"x": static[0] if static else None},
                               dict(meta, tag=tag))

    x = torch.arange(4)
    monkeypatch.setattr(pgather, "LAUNCHES", dict.fromkeys(pgather.LAUNCHES, 0))
    out, meta = store.run(bk1, None, ("kg", 8), prog("a"), [x])
    assert meta["from_graph"]
    assert fake.captured == ["a"] and fake.replayed == ["a"]
    assert out["x"] is store.entries[(bk1, None, ("kg", 8))].inputs[0]
    store.run(bk1, None, ("kg", 8), prog("never"), [x + 1])
    assert fake.captured == ["a"] and fake.replayed == ["a", "a"]
    assert out["x"].tolist() == [1, 2, 3, 4]  # the static input was refilled
    assert pgather.LAUNCHES["gather_sorted"] == 2 * 3  # two replays
    store.run(bk1, ("epi", "k"), ("kg", 8), prog("b"), [x])
    store.run(bk1, None, ("kg", 16), prog("c"), [x])
    assert fake.captured == ["a", "b", "c"] and len(store.entries) == 3
    store.run(bk2, None, ("kg", 8), prog("d"), [x])  # a new table version
    assert [k[0] for k in store.entries] == [bk2]
    bk3 = bk1[:2] + ((("t", 3),),)
    store.run(bk3, None, (), prog("e"), [])
    store.run(("fused_chain", "other", (("t", 1),)), None, (), prog("f"), [])
    assert [k[0][2] for k in store.entries] == [(("t", 3),), (("t", 1),)]
    store.drop(bk3)  # a rebuild
    assert [k[0][1] for k in store.entries] == ["other"]
    store.clear()
    assert not store.entries and store.pool is None
    with pytest.raises(RuntimeError, match="meta holds a tensor"):
        store.run(bk1, None, (), lambda s: ({}, {"t": torch.zeros(1)}), [])


def test_keys_follow_capacities_versions_and_pointers(env, monkeypatch):
    """A session's key for one fused program changes with a learned
    capacity, with the table version and with the input pointers; a
    rebuild after an outgrown capacity drops the key it replaces;
    _evict_device_memory empties the store, and the next run captures
    again with the reference's rows."""
    _rs, carried, want = env
    s = _session(carried)
    q = _sql("3")

    def agg_keys():
        return {k for k in s.exestore.entries if k[0][0] == "fused_agg"}

    assert s.sql(q).format_rows() == want["3"]
    keys = agg_keys()
    (basekey,) = {k[0] for k in keys}
    # another learned capacity: a key of its own (material: (..., kg, ...))
    kg = s.stage_cache[("fused_kg", basekey)]
    s.stage_cache[("fused_kg", basekey)] = 4
    assert s.sql(q).format_rows() == want["3"]
    assert sorted(k[2][4] for k in agg_keys()) == [4, kg]
    # an outgrown capacity: the rebuild drops every key of the plan before
    # the program runs again at the new capacity
    orig = ex.Executor._finish_fused_dense  # q3 groups by learned bounds
    raised = []

    def outgrown(self, op, res, meta):
        if not raised:
            raised.append(meta)
            raise F.CapacityOverflow(300)
        return orig(self, op, res, meta)

    monkeypatch.setattr(ex.Executor, "_finish_fused_dense", outgrown)
    assert s.sql(q).format_rows() == want["3"]
    assert raised and [k[2][4] for k in agg_keys()] == [1024]
    # input pointers: the tables uploaded again -> new keys
    before = agg_keys()
    for _v, t in s._device_cache.values():
        t.evict()
    assert s.sql(q).format_rows() == want["3"]
    assert agg_keys() - before
    # eviction empties the store; the next run captures again
    s._evict_device_memory()
    assert not s.exestore.entries
    c0 = compilestats.snapshot()
    assert s.sql(q).format_rows() == want["3"]
    assert compilestats.delta(c0)["captures"] >= 1
    # a table version change: the plan's entries at the old version go
    old = {k[0] for k in s.exestore.entries}
    s.catalog.get_table("orders").storage.version += 1
    assert s.sql(q).format_rows() == want["3"]
    assert s.exestore.entries
    assert not {k[0] for k in s.exestore.entries} & old


def _profile_pairs(prof):
    return [(name, rows) for name, _ms, rows, *_ in prof]


@pytest.mark.parametrize("q", ["6", "3"])
def test_perf_mode_profile_equals_reference(env, q, capfd):
    """PERF mode's per-operator profile names the reference's operators
    with the reference's row counts; every record has six fields and the
    fused aggregate's bytes cover the base-table bytes it scanned; the
    statement's line counts captures, replays, builds and calibrations,
    and without system.hbm_gbps no speed of light is claimed."""
    from lingodb_tpu.utils.settings import EXECUTION_MODE as REF_MODE

    rs, carried, want = env
    s = _session(carried)
    s.sql(_sql(q))
    REF_MODE.set("PERF")
    EXECUTION_MODE.set("PERF")
    try:
        rs.sql(_sql(q))
        ref_prof = rs.executor.last_op_profile
        capfd.readouterr()
        assert s.sql(_sql(q)).format_rows() == want[q]
        prof = s.executor.last_op_profile
    finally:
        REF_MODE.set("DEFAULT")
        EXECUTION_MODE.set("DEFAULT")
    err = capfd.readouterr().err
    assert _profile_pairs(prof) == _profile_pairs(ref_prof)
    assert all(len(r) == 6 for r in prof)
    assert all(r[5] == "unknown" for r in prof)
    assert "# perf captures=0 " in err and "replays=" in err
    assert "calibrations=0" in err
    if q == "6":
        rows = s.catalog.get_table("lineitem").storage.num_rows
        agg = [r for r in prof if r[0] == "Aggregate"]
        assert agg and agg[0][4] >= rows * 4 * 4
    from lingodb_tpu_torch.utils.settings import HBM_GBPS

    HBM_GBPS.set(3350.0)
    EXECUTION_MODE.set("PERF")
    try:
        s.sql(_sql(q))
    finally:
        EXECUTION_MODE.set("DEFAULT")
        HBM_GBPS.reset()
    assert all(isinstance(r[5], float) for r in s.executor.last_op_profile
               if r[4])


# the modules whose plain versions stand in for a kernel on the CPU (on the
# card the wrapper launches the kernel, which reads nothing to the host)
_PLAIN_VERSIONS = ("pgather.py", "checked.py")


def _guard_host_reads(monkeypatch):
    """Guards on every way a fused program could copy from the host or read
    to it (see test_fused_programs_copy_nothing_from_the_host), on while
    Executor._fused_program or _fused_chain_program runs. Returns the list
    the guards append each offending call's site to, and the list of the
    programs that ran."""
    import traceback

    import numpy as np

    from lingodb_tpu_torch.ops import backend as be

    state = {"inside": False, "upload": False}
    bad, ran = [], []

    def guard(name, orig, check=lambda a, k: True):
        def call(*a, **k):
            if state["inside"] and not state["upload"] and check(a, k):
                where = traceback.extract_stack()[-2]
                # pgather's and checked's plain versions stand in for the
                # kernels here
                if not where.filename.endswith(_PLAIN_VERSIONS):
                    bad.append(f"{name} at "
                               f"{os.path.basename(where.filename)}:"
                               f"{where.lineno}")
            return orig(*a, **k)
        return call

    for name in ("tensor", "as_tensor", "from_numpy", "nonzero", "unique",
                 "masked_select", "repeat_interleave"):
        monkeypatch.setattr(torch, name, guard(f"torch.{name}",
                                               getattr(torch, name)))
    for name in ("item", "__bool__", "__int__", "__index__", "__float__",
                 "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, guard(
            f"Tensor.{name}", getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.Tensor, "__setitem__", guard(
        "Tensor.__setitem__ from a host value", torch.Tensor.__setitem__,
        lambda a, k: not isinstance(a[2], torch.Tensor)))

    def host_index(a, k):
        # a 0-dim tensor index is read to the host as an integer; a boolean
        # mask index waits for its count
        idx = a[1] if isinstance(a[1], tuple) else (a[1],)
        return any(isinstance(i, (list, np.ndarray)) or (
            isinstance(i, torch.Tensor)
            and (i.ndim == 0 or i.dtype == torch.bool)) for i in idx)

    monkeypatch.setattr(torch.Tensor, "__getitem__", guard(
        "Tensor.__getitem__ at host or 0-dim indices",
        torch.Tensor.__getitem__, host_index))
    orig_up = be.to_device

    def to_device(*a, **k):
        state["upload"] = True
        try:
            return orig_up(*a, **k)
        finally:
            state["upload"] = False

    monkeypatch.setattr(be, "to_device", to_device)
    from torch.utils._python_dispatch import TorchDispatchMode

    # reads to the host made inside PyTorch itself (an operator that takes
    # a 0-dim tensor where it wants a number, or sizes its output by the
    # data), seen at the dispatcher
    waits = ("_local_scalar_dense", "nonzero", "unique", "masked_select")

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if any(name.startswith(w) for w in waits):
                where = [f for f in traceback.extract_stack()
                         if "lingodb_tpu_torch" in f.filename][-1]
                if not where.filename.endswith(_PLAIN_VERSIONS):
                    bad.append(f"aten.{name} at "
                               f"{os.path.basename(where.filename)}:"
                               f"{where.lineno}")
            return func(*args, **(kwargs or {}))

    for name in ("_fused_program", "_fused_chain_program"):
        orig_prog = getattr(ex.Executor, name)

        def prog(self, *a, _orig=orig_prog, _name=name, **k):
            ran.append(_name)
            state["inside"] = True
            try:
                with Reads():
                    return _orig(self, *a, **k)
            finally:
                state["inside"] = False

        monkeypatch.setattr(ex.Executor, name, prog)
    return bad, ran


def _spy_error_codes(monkeypatch) -> list:
    """Whether each fused program that ran built a data-error code (its
    scalar "err"): one flag a run."""
    built = []
    orig = ex._with_err_out

    def spy(out, errs):
        built.append(errs.code is not None)
        return orig(out, errs)

    monkeypatch.setattr(ex, "_with_err_out", spy)
    return built


def test_fused_programs_copy_nothing_from_the_host(env, monkeypatch):
    """Inside the fused programs no tensor is made from host data except
    through backend.to_device (which a CUDA graph's capture serves from a
    copy it keeps), nothing is read to the host and nothing waits for a
    size the card computes: no torch.tensor / as_tensor / from_numpy, no
    element set from a host scalar, no index from a host list or array, a
    0-dim tensor or a boolean mask, no nonzero / unique / masked_select /
    repeat_interleave, no item / int / bool / tolist / cpu / numpy. On the
    card each is a host-to-device copy or a read to the host, which a
    capture refuses (tests/test_torch_fused.py holds the reads on ten
    queries; this, every guard on all 22)."""
    _rs, carried, _want = env
    bad, _ran = _guard_host_reads(monkeypatch)
    built = _spy_error_codes(monkeypatch)
    s = _session(carried)
    for q in [str(i) for i in range(1, 23)]:
        s.sql(_sql(q))
    # their expressions cannot fail: no program builds a data-error code
    assert built and not any(built)
    # the SQL battery with every table on the tensor tier
    monkeypatch.setattr(dv, "SMALL_ROWS", 2)
    b = ldb.create_in_memory(device="cpu")
    for stmt in sql_battery.SETUP:
        b.sql_stmt(stmt)
    for q in sql_battery.QUERIES:
        b.sql(q)
    assert not bad, sorted(set(bad))


# every function of ops/scalar.py::eval_call that takes a constant argument
# (and CASE and CAST), as an expression over a decimal {n}, a double {x}, a
# string {s} and a date {d}, with the kind of value it gives
CONST_ARG_EXPRS = {
    "round_decimal": ("round({n}, 1)", "num"),
    "round_double": ("round({x}, 2)", "num"),
    "round_negative_digits": ("round({n}, -1)", "num"),
    "compare": ("{n} > 1.5", "bool"),
    "and_or": ("({n} > 1.5 AND {x} < 2) OR {n} IS NULL", "bool"),
    "arithmetic": ("{n} * 2 + 1", "num"),
    "divide_mod": ("{n} / 3 + {n} % 7", "num"),
    "coalesce": ("coalesce({n}, 0)", "num"),
    "nullif": ("nullif({n}, 0)", "num"),
    "in_list": ("{n} IN (1.00, 2.50)", "bool"),
    "like": ("{s} LIKE 'a%'", "bool"),
    "ilike": ("{s} ILIKE '%A%'", "bool"),
    "date_add": ("{d} + INTERVAL '1' MONTH", "date"),
    "date_sub": ("{d} - INTERVAL '3' DAY", "date"),
    "datediff": ("datediff('day', {d}, DATE '2021-01-01')", "num"),
    "date_trunc": ("date_trunc('month', {d})", "date"),
    "extract": ("extract(month FROM {d})", "num"),
    "regexp_replace": ("regexp_replace({s}, 'a+', 'b')", "str"),
    "substring": ("substring({s}, 2, 3)", "str"),
    "concat": ("{s} || '_x'", "str"),
    "concat_function": ("concat({s}, '-')", "str"),
    "replace": ("replace({s}, 'a', 'b')", "str"),
    "starts_with": ("starts_with({s}, 'a')", "bool"),
    "ends_with": ("ends_with({s}, 'e')", "bool"),
    "pow": ("pow({x}, 2)", "num"),
    "case": ("CASE WHEN {n} > 0 THEN 1 ELSE 2 END", "num"),
    "cast": ("CAST({n} AS INT)", "num"),
    "cast_double": ("CAST({x} AS INT)", "num"),
}
# those that can fail, by the programs that build their code (the chain's
# select list is an eager Map): a double beyond INT's range; the others
# build no data-error code (m, a DECIMAL(10,2), fits INT even rounded, and
# so does the TopK epilogue's sum(m), a DECIMAL(20,2), by the bounds of m's
# values over w's rows, ops/bounds.py)
CONST_ARG_CAN_FAIL = {"cast_double": {"aggregate", "topk_epilogue"}}
_AS_NUMBER = {"num": "{}", "bool": "CASE WHEN {} THEN 1 ELSE 0 END",
              "str": "length({})", "date": "extract(day FROM {})"}
# (the program, the operands, the statement): the fused aggregate, the
# fused chain (a join to a dimension) and the TopK epilogue of the general
# mode's aggregate, evaluated over the aggregates' lanes (ordered by the
# group key: ties at the cutoff would decline the epilogue for the plan)
CONST_ARG_CONTEXTS = {
    "aggregate": ("_fused_program",
                  dict(n="m", x="x", s="s", d="dt"),
                  "SELECT g, sum({num}) FROM w WHERE id > 10 GROUP BY g"),
    "chain": ("_fused_chain_program",
              dict(n="w.m", x="w.x", s="w.s", d="w.dt"),
              "SELECT w.id, {expr} FROM w JOIN u ON w.g = u.g "
              "WHERE w.id > 10"),
    "topk_epilogue": ("_fused_program",
                      dict(n="sum(m)", x="sum(x)", s="min(s)", d="max(dt)"),
                      "SELECT x, {expr} AS r FROM w GROUP BY x "
                      "ORDER BY x LIMIT 3"),
}


@pytest.fixture(scope="module")
def const_arg_session():
    """A session over tools/sqlite_battery.py's table w at 5,000 rows (NULLs
    in every column but the keys) and a seven-row dimension u, all on the
    tensor tier."""
    old = dv.SMALL_ROWS
    dv.SMALL_ROWS = 64  # read when a column is first uploaded
    s = ldb.create_in_memory(device="cpu")
    for st in _const_arg_setup():
        s.sql_stmt(st)
    yield s
    dv.SMALL_ROWS = old


def _const_arg_setup() -> list:
    from lingodb_tpu_torch.tools import sqlite_battery as sb

    return sb.semantics_setup(5000) + [
        "CREATE TABLE u(g INT, label VARCHAR(8))",
        "INSERT INTO u VALUES " + ", ".join(f"({i}, 'l{i}')" for i in range(7))]


@pytest.mark.parametrize("fn", list(CONST_ARG_EXPRS))
def test_constant_arguments_copy_nothing_from_the_host(const_arg_session, fn,
                                                       monkeypatch):
    """A function's constant argument (round's digits, a LIKE pattern, a
    substring's start, an interval ...) is read from the plan on the host,
    never from its evaluated copy beside the columns: inside the fused
    aggregate, the fused chain and the TopK epilogue, the guards of
    test_fused_programs_copy_nothing_from_the_host see no copy from the host
    and no read to it. On the card such a read is a sync on every run, and
    a CUDA graph's capture refuses it (round's digits were one)."""
    monkeypatch.setattr(dv, "SMALL_ROWS", 64)
    expr, kind = CONST_ARG_EXPRS[fn]
    epilogues = []
    apply_epi = F.apply_topk_epi

    def spy(*a, **k):
        epilogues.append(1)
        return apply_epi(*a, **k)

    monkeypatch.setattr(F, "apply_topk_epi", spy)
    bad, ran = _guard_host_reads(monkeypatch)
    built = _spy_error_codes(monkeypatch)
    for ctx, (program, operands, template) in CONST_ARG_CONTEXTS.items():
        e = expr.format(**operands)
        sql = template.format(expr=e, num=_AS_NUMBER[kind].format(e))
        ran.clear()
        epilogues.clear()
        built.clear()
        const_arg_session.sql(sql)
        assert program in ran, f"{ctx}: no fused program ran: {sql}"
        if ctx == "topk_epilogue":
            assert epilogues, f"no TopK epilogue ran in the program: {sql}"
        assert not bad, (ctx, sql, sorted(set(bad)))
        # (the chain's select list is a Map over the chain, which the eager
        # operator evaluates after it)
        assert any(built) == (ctx in CONST_ARG_CAN_FAIL.get(fn, ())), (
            ctx, sql, built)


# a data error of each kind inside each fused program: INT arithmetic
# beyond the range (C21) and a cast of strings to INT (C22), over an INT
# operand {v} and a string {s}; the aggregate groups by a string, whose
# dictionary gives the program its groups without a calibration run, and
# the chain has it in a restriction of its scan
DATA_ERROR_EXPRS = {
    "int_overflow": ("{v} * 100000000", "integer out of range"),
    "string_cast": ("CAST({s} AS INT)",
                    'invalid input syntax for type integer: "'),
}
DATA_ERROR_CONTEXTS = {
    "aggregate": ("_fused_program", dict(v="v", s="s"),
                  "SELECT s, sum({expr}) FROM w WHERE id > 10 GROUP BY s"),
    "chain": ("_fused_chain_program", dict(v="w.v", s="w.s"),
              "SELECT w.id, u.label FROM w JOIN u ON w.g = u.g "
              "WHERE w.id > 10 AND {expr} > 0"),
    "topk_epilogue": ("_fused_program", dict(v="max(v)", s="min(s)"),
                      "SELECT x, {expr} AS r FROM w GROUP BY x "
                      "ORDER BY x LIMIT 3"),
}


@pytest.mark.parametrize("ctx", list(DATA_ERROR_CONTEXTS))
@pytest.mark.parametrize("fn", list(DATA_ERROR_EXPRS))
def test_data_errors_raise_from_the_packed_fetch(const_arg_session, fn, ctx,
                                                 monkeypatch):
    """A data error inside the fused aggregate, the fused chain and the
    TopK epilogue is no read to the host: the program keeps its code as one
    more scalar, and the finish raises PostgreSQL's message after the one
    packed fetch, on the first run and on the next (a replay where the
    program was captured), with none of the guards' reads and no HostRead
    (which would decline the program to the eager operators)."""
    monkeypatch.setattr(dv, "SMALL_ROWS", 64)
    program, operands, template = DATA_ERROR_CONTEXTS[ctx]
    expr, words = DATA_ERROR_EXPRS[fn]
    sql = template.format(expr=expr.format(**operands))
    epilogues = []
    apply_epi = F.apply_topk_epi

    def spy(*a, **k):
        epilogues.append(1)
        return apply_epi(*a, **k)

    monkeypatch.setattr(F, "apply_topk_epi", spy)
    bad, ran = _guard_host_reads(monkeypatch)
    built = _spy_error_codes(monkeypatch)
    for _run in range(2):
        ran.clear()
        epilogues.clear()
        with pytest.raises(sc.EvalError, match=re.escape(words)) as got:
            const_arg_session.sql(sql)
        assert program in ran, f"{ctx}: no fused program ran: {sql}"
        if ctx == "topk_epilogue":
            assert epilogues, f"no TopK epilogue ran in the program: {sql}"
        raised_in = got.traceback[-2].name
        assert raised_in in ex.FETCH_FINISHES, (sql, raised_in)
        assert not bad, (ctx, sql, sorted(set(bad)))
    assert any(built)


# a DECIMAL product past int64 on some live rows (m, a DECIMAL(10,2) up to
# 500.00: its fifth power passes int64 at scale 10) inside each fused
# program: the checked kernel marks the rows, the program returns the mark
# as its scalar "err", and the statement runs again on the exact host path
WIDE_CONTEXTS = {
    "aggregate": ("_fused_program",
                  "SELECT g, sum(m * m * m * m * m) FROM w WHERE id > 10 "
                  "GROUP BY g ORDER BY g"),
    "chain": ("_fused_chain_program",
              "SELECT w.id, u.label FROM w JOIN u ON w.g = u.g "
              "WHERE w.id > 10 AND w.m * w.m * w.m * w.m * w.m > 0"),
    "topk_epilogue": ("_fused_program",
                      "SELECT x, sum(m) * sum(m) * sum(m) * sum(m) * sum(m) "
                      "AS r FROM w GROUP BY x ORDER BY x LIMIT 3"),
}


@pytest.mark.parametrize("ctx", list(WIDE_CONTEXTS))
def test_wide_marks_run_the_statement_again_exactly(const_arg_session, ctx,
                                                     monkeypatch):
    """Inside the fused aggregate, the fused chain and the TopK epilogue a
    row past int64 is no read to the host: the program builds its mark as
    one more scalar, a finish reads it after the packed fetch and the
    statement runs once more with the expression on the exact host path,
    where the program declines on the host. A later run goes exact at once
    (the plan's choice is in the stage cache): no program builds a mark
    and no second run. Both runs give the host tier's exact rows."""
    monkeypatch.setattr(dv, "SMALL_ROWS", 64)
    program, sql = WIDE_CONTEXTS[ctx]
    epilogues = []
    apply_epi = F.apply_topk_epi

    def spy(*a, **k):
        epilogues.append(1)
        return apply_epi(*a, **k)

    monkeypatch.setattr(F, "apply_topk_epi", spy)
    marked_in = []
    raise_one = sc.raise_data_error

    def raising(code, sources=None):
        try:
            raise_one(code, sources)
        except sc.NeedsExact:
            import sys

            marked_in.append(sys._getframe(1).f_code.co_name)
            raise

    monkeypatch.setattr(sc, "raise_data_error", raising)
    bad, ran = _guard_host_reads(monkeypatch)
    built = _spy_error_codes(monkeypatch)
    s = const_arg_session
    first = s.sql(sql).format_rows()
    assert program in ran, f"{ctx}: no fused program ran: {sql}"
    if ctx == "topk_epilogue":
        assert epilogues, f"no TopK epilogue ran in the program: {sql}"
    assert any(built) and marked_in and all(
        m in ex.FETCH_FINISHES for m in marked_in), (sql, marked_in)
    assert s.executor.last_exact_reruns == 1, sql
    assert not bad, (ctx, sql, sorted(set(bad)))
    ran.clear()
    epilogues.clear()
    built.clear()
    marked_in.clear()
    assert s.sql(sql).format_rows() == first
    assert s.executor.last_exact_reruns == 0 and not marked_in, sql
    assert not any(built), sql
    assert not bad, (ctx, sql, sorted(set(bad)))
    if ctx == "topk_epilogue":
        assert not epilogues, "the epilogue ran over the exact path's plan"
    # the host tier computes the same statement exactly from the start
    monkeypatch.setattr(dv, "SMALL_ROWS", 1 << 30)
    host = ldb.create_in_memory(device="cpu")
    for st in _const_arg_setup():
        host.sql_stmt(st)
    assert host.sql(sql).format_rows() == first


# a checked % (m, a DECIMAL(10,2) up to 500.00, rescaled to scale 17 passes
# int64; its remainder fits) and a cast of a double to DECIMAL (15 digits,
# then the scale) inside each fused program: the checked kernel's codes are
# the program's scalar "err", read with the packed fetch
CHECKED_EXPRS = {"mod": ("{n} % 0.00000000000000007",) * 2,
                 "cast_f": ("CAST({x} AS DECIMAL(12,2))",
                            "CAST({x} AS DECIMAL(18,2))")}
CHECKED_CONTEXTS = {
    "aggregate": ("_fused_program", dict(n="m", x="x"),
                  "SELECT g, sum({expr}) FROM w WHERE id > 10 GROUP BY g "
                  "ORDER BY g"),
    "chain": ("_fused_chain_program", dict(n="w.m", x="w.x"),
              "SELECT w.id, u.label FROM w JOIN u ON w.g = u.g "
              "WHERE w.id > 10 AND {expr} > 0 ORDER BY w.id"),
    "topk_epilogue": ("_fused_program", dict(n="sum(m)", x="sum(x)"),
                      "SELECT x, {expr} AS r FROM w GROUP BY x "
                      "ORDER BY x LIMIT 3"),
}


@pytest.fixture(scope="module")
def host_const_arg_session():
    """const_arg_session's tables on the host tier."""
    old = dv.SMALL_ROWS
    dv.SMALL_ROWS = 1 << 30
    s = ldb.create_in_memory(device="cpu")
    for st in _const_arg_setup():
        s.sql_stmt(st)
    yield s
    dv.SMALL_ROWS = old


@pytest.mark.parametrize("ctx", list(CHECKED_CONTEXTS))
@pytest.mark.parametrize("form", list(CHECKED_EXPRS))
def test_checked_mod_and_float_cast_read_nothing(const_arg_session,
                                                 host_const_arg_session,
                                                 form, ctx, monkeypatch):
    """A checked % and a cast from a double to DECIMAL inside the fused
    aggregate, the fused chain and the TopK epilogue read nothing to the
    host and copy nothing from it (the guards of
    test_fused_programs_copy_nothing_from_the_host): the program builds their
    code as its scalar "err", no row needs the exact path, and the rows
    equal the host tier's."""
    monkeypatch.setattr(dv, "SMALL_ROWS", 64)
    program, operands, template = CHECKED_CONTEXTS[ctx]
    expr = CHECKED_EXPRS[form][ctx == "topk_epilogue"].format(**operands)
    sql = template.format(expr=expr)
    epilogues = []
    apply_epi = F.apply_topk_epi

    def spy(*a, **k):
        epilogues.append(1)
        return apply_epi(*a, **k)

    monkeypatch.setattr(F, "apply_topk_epi", spy)
    bad, ran = _guard_host_reads(monkeypatch)
    built = _spy_error_codes(monkeypatch)
    got = const_arg_session.sql(sql).format_rows()
    assert program in ran, f"{ctx}: no fused program ran: {sql}"
    if ctx == "topk_epilogue":
        assert epilogues, f"no TopK epilogue ran in the program: {sql}"
    assert any(built), sql
    assert const_arg_session.executor.last_exact_reruns == 0, sql
    assert not bad, (ctx, sql, sorted(set(bad)))
    monkeypatch.setattr(dv, "SMALL_ROWS", 1 << 30)
    assert host_const_arg_session.sql(sql).format_rows() == got
