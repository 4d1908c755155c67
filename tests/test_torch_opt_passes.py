"""The port's counterpart of tests/test_opt_passes.py (per-pass plan-diff
golden tests and snapshots): the same cases on the port's sessions
(device="cpu"), asserting the values the reference file asserts. What the
reference file says of its subject:

Per-pass plan-diff golden tests + snapshot instrumentation.

The mlir-db-opt analogue: each optimizer pass runs in isolation (via the
system.opt pass restriction) against a fixed schema and its output plan is
checked structurally and against golden pretty-printed text (reference:
tools/mlir-db-opt pass-level golden tests, per-pass snapshots
src/execution/Instrumentation.cpp:29-80).
"""

import pytest


@pytest.fixture()
def session():
    import lingodb_tpu_torch as ldb

    return ldb.create_in_memory(device="cpu")


def _bind(session, q):
    from lingodb_tpu_torch.sql.binder import Binder
    from lingodb_tpu_torch.sql.parser import parse_sql

    return Binder(session.catalog).bind_query(parse_sql(q)[-1])


def _run_passes(session, q, passes):
    """Optimize with only the given passes enabled."""
    from lingodb_tpu_torch.opt.optimizer import optimize
    from lingodb_tpu_torch.utils import settings

    settings.OPT_PASSES.set(",".join(passes))
    try:
        return optimize(_bind(session, q), session.catalog)
    finally:
        settings.OPT_PASSES.reset()


def _setup(session):
    session.sql_stmt("create table t(a int primary key, b int, c int, d int)")
    session.sql_stmt("insert into t values (1,2,3,4),(2,3,4,5),(3,3,4,5)")
    session.sql_stmt("create table u(x int, y int)")
    session.sql_stmt("insert into u values (1,10),(2,20),(3,30),(1,11)")
    session.sql_stmt("create table v(p int, q int)")
    session.sql_stmt("insert into v values (1,100),(2,200)")


# ------------------------------------------------------------------ pushdown
def test_pushdown_moves_predicate_into_join_side(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(session, "select t.a from t, u where t.a = u.x and u.y > 10",
                       ["pushdown"])
    join = next(n for n in L.walk_plan(plan) if isinstance(n, L.Join))
    # u.y > 10 must sit BELOW the join (as Select over u's scan), the join
    # keeps only the equi predicate
    assert "gt" not in repr(join.predicate)
    below = [n for n in L.walk_plan(join) if isinstance(n, L.Select)]
    assert any("gt" in repr(s.predicate) for s in below)


# ----------------------------------------------------- fold-scan-restrictions
def test_fold_scan_restrictions_golden(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(session, "select a from t where b > 1",
                       ["pushdown", "fold-scan-restrictions"])
    scan = next(n for n in L.walk_plan(plan) if isinstance(n, L.Scan))
    assert scan.restrictions, "predicate should fold into the scan"
    assert not any(isinstance(n, L.Select) for n in L.walk_plan(plan))


# ------------------------------------------------------- reduce-group-by-keys
def test_reduce_group_by_keys_uses_pk_fd(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(session, "select a, b, c, sum(d) from t group by a, b, c",
                       ["reduce-group-by-keys"])
    agg = next(n for n in L.walk_plan(plan) if isinstance(n, L.Aggregate))
    assert len(agg.group_by) == 1, agg.pretty()
    fns = sorted(a.fn for a in agg.aggs)
    assert fns == ["any_value", "any_value", "sum"]
    # results must be unchanged
    rows = session.sql(
        "select a, b, c, sum(d) as s from t group by a, b, c order by a"
    ).to_pylist()
    assert rows == [[1, 2, 3, 4], [2, 3, 4, 5], [3, 3, 4, 5]]


def test_reduce_group_by_keys_no_pk_no_change(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(session, "select x, y, count(*) from u group by x, y",
                       ["reduce-group-by-keys"])
    agg = next(n for n in L.walk_plan(plan) if isinstance(n, L.Aggregate))
    assert len(agg.group_by) == 2


def test_reduce_group_by_keys_via_selection_equality(session):
    """b = c makes {a, b, c} reducible to {a, b} even without b's FD."""
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(
        session,
        "select x, y, count(*) from u where x = y group by x, y",
        ["pushdown", "reduce-group-by-keys"])
    agg = next(n for n in L.walk_plan(plan) if isinstance(n, L.Aggregate))
    assert len(agg.group_by) == 1, agg.pretty()


# ---------------------------------------------- expand-transitive-equalities
def test_expand_transitive_adds_bridging_edge(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    q = "select t.a, u.x, v.p from t, u, v where t.a = u.x and u.x = v.p"
    plan = _run_passes(session, q,
                       ["pushdown", "expand-transitive-equalities", "pushdown"])
    # the implied t.a = v.p edge lets SOME join pair t and v directly; count
    # distinct eq conjuncts across the join tree: 3 (a=x, x=p, a=p)
    eqs = set()
    from lingodb_tpu_torch.plan import exprs as E

    for n in L.walk_plan(plan):
        pred = getattr(n, "predicate", None)
        if pred is not None:
            for c in E.conjuncts(pred):
                if getattr(c, "op", None) == "eq":
                    eqs.add(repr(c))
    assert len(eqs) == 3, eqs
    rows = session.sql(q + " order by t.a, u.x").to_pylist()
    assert rows == [[1, 1, 1], [1, 1, 1], [2, 2, 2]]


# -------------------------------------------------------------- column-folding
def test_column_folding_prunes_scan(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(session, "select a from t where b > 1",
                       ["pushdown", "column-folding"])
    scan = next(n for n in L.walk_plan(plan) if isinstance(n, L.Scan))
    assert [c.name for c in scan.cols] == ["a", "b"]


def test_column_folding_prunes_join_payload(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(session, "select u.y from t, u where t.a = u.x",
                       ["pushdown", "column-folding"])
    scans = {n.table: [c.name for c in n.cols] for n in L.walk_plan(plan)
             if isinstance(n, L.Scan)}
    assert scans["t"] == ["a"]
    assert sorted(scans["u"]) == ["x", "y"]


def test_column_folding_drops_unused_aggregate(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    q = ("select a2 from (select a as a2, sum(b) as sb, sum(c) as sc "
         "from t group by a) z")
    plan = _run_passes(session, q, ["column-folding"])
    agg = next(n for n in L.walk_plan(plan) if isinstance(n, L.Aggregate))
    assert agg.aggs == []
    assert session.sql(q + " order by a2").to_pylist() == [[1], [2], [3]]


def test_column_folding_full_pipeline_results_unchanged(session):
    _setup(session)
    q = ("select t.a, u.y from t join u on t.a = u.x where t.b >= 2 "
         "order by t.a, u.y")
    assert session.sql(q).to_pylist() == [[1, 10], [1, 11], [2, 20], [3, 30]]


# ------------------------------------------------------------- instrumentation
def test_pass_snapshots(session, tmp_path):
    from lingodb_tpu_torch.opt import optimizer
    from lingodb_tpu_torch.utils import settings

    _setup(session)
    settings.SNAPSHOT_PASSES.set(True)
    settings.SNAPSHOT_DIR.set(str(tmp_path))
    try:
        session.sql("select a from t where b > 1")
    finally:
        settings.SNAPSHOT_PASSES.reset()
        settings.SNAPSHOT_DIR.reset()
    names = [n for n, _ in optimizer.last_pass_snapshots]
    assert names[0] == "input"
    for expected in ("pushdown", "join-order", "column-folding"):
        assert expected in names
    files = sorted(p.name for p in tmp_path.iterdir())
    assert any(f.startswith("snapshot-0-input") for f in files)
    assert len(files) == len(names)
    # snapshots show the plan evolving: input retains the Select, the final
    # one has folded it into the scan
    texts = dict(optimizer.last_pass_snapshots)
    assert "Select" in texts["input"]
    assert "Select" not in texts["column-folding"]


# ------------------------------------------------------------ infer-not-null
def test_infer_not_null_adds_conjunct_for_strict_cmp(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    # u.x is nullable (no PK / NOT NULL): x > 1 is null-rejecting, so the
    # pass adds `x IS NOT NULL` (reference: InferNotNullConditions.cpp)
    plan = _run_passes(session, "select y from u where x > 1",
                       ["infer-not-null"])
    sel = next(n for n in L.walk_plan(plan) if isinstance(n, L.Select))
    assert "isnotnull" in repr(sel.predicate)
    # idempotent: IS NOT NULL already present -> no duplicate
    plan2 = _run_passes(
        session, "select y from u where x > 1 and x is not null",
        ["infer-not-null"])
    sel2 = next(n for n in L.walk_plan(plan2) if isinstance(n, L.Select))
    assert repr(sel2.predicate).count("isnotnull") == 1


def test_infer_not_null_skips_or_branches_and_non_null_cols(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    # inside an OR nothing may be inferred; t.a is PK (not nullable)
    plan = _run_passes(session, "select b from t where a = 1 or b = 2",
                       ["infer-not-null"])
    sel = next(n for n in L.walk_plan(plan) if isinstance(n, L.Select))
    assert "isnotnull" not in repr(sel.predicate)


def test_infer_not_null_results_unchanged(session):
    _setup(session)
    session.sql_stmt("insert into u values (null, 99)")
    rows = session.sql("select y from u where x > 1 order by y").format_rows()
    assert rows == [["20"], ["30"]]


# ----------------------------------------------------- eliminate-trivial-join
def test_eliminate_trivial_left_join_on_unique_key(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    # t.a is the primary key: LEFT JOIN t never duplicates u rows, and no
    # t column is consumed above -> the join disappears
    plan = _run_passes(
        session, "select u.y from u left join t on u.x = t.a",
        ["eliminate-trivial-join"])
    assert not any(isinstance(n, L.Join) for n in L.walk_plan(plan)), plan.pretty()
    rows = session.sql(
        "select u.y from u left join t on u.x = t.a order by y").format_rows()
    assert [r[0] for r in rows] == ["10", "11", "20", "30"]


def test_trivial_join_kept_when_right_key_not_unique(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    # u.x is NOT unique (two rows with x=1): dropping would change row count
    plan = _run_passes(
        session, "select t.b from t left join u on t.a = u.x",
        ["eliminate-trivial-join"])
    assert any(isinstance(n, L.Join) for n in L.walk_plan(plan))


def test_trivial_join_kept_when_right_cols_used(session):
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(
        session, "select u.y, t.b from u left join t on u.x = t.a",
        ["eliminate-trivial-join"])
    assert any(isinstance(n, L.Join) for n in L.walk_plan(plan))


# ------------------------------------------- combine-predicates equivalence
def test_selection_on_inner_join_merges_into_join_predicate(session):
    """The reference's CombinePredicates pass (CombinePredicates.cpp:41-50)
    inlines a Selection sitting on an inner join into the join's predicate
    block. Our pushdown produces the same shape: cross-side conjuncts stay as
    (become) the join predicate, so no Select survives above the join."""
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _run_passes(
        session,
        "select s.a from (select * from t, u) s where s.a = s.x and s.b + s.y > 0",
        ["pushdown"])
    join = next(n for n in L.walk_plan(plan) if isinstance(n, L.Join))
    r = repr(join.predicate)
    assert "eq" in r and ("gt" in r or "lt" in r), r  # both conjuncts merged
    assert join.kind == "inner"
    # nothing above the join filters: the Select was fully absorbed
    for n in L.walk_plan(plan):
        if isinstance(n, L.Select):
            for c in L.walk_plan(n.child):
                assert not isinstance(c, L.Join)


# ------------------------------------------ simplify-aggregations equivalence
def test_duplicate_aggregates_computed_once(session):
    """SimplifyAggregations dedups identical AggrFuncOps and lowers avg into
    sum/count (SimplifyAggregations.cpp:99-196). Our binder does both at bind
    time: sum(b) named twice + avg(b) produce exactly one sum and one count."""
    from lingodb_tpu_torch.plan import logical as L

    _setup(session)
    plan = _bind(session,
                 "select sum(b), sum(b) + 1, avg(b), count(b) from t")
    aggs = [a for n in L.walk_plan(plan) if isinstance(n, L.Aggregate)
            for a in n.aggs]
    fns = sorted(a.fn for a in aggs)
    assert fns == ["count", "sum"], fns


def test_avg_decomposed_matches_oracle(session):
    _setup(session)
    rows = session.sql(
        "select cast(avg(b) as double), stddev_samp(b), var_samp(b) from t"
    ).to_pylist()
    a, sd, var = rows[0]
    assert abs(float(a) - 8 / 3) < 1e-9
    import math
    assert abs(float(var) - 1 / 3) < 1e-9
    assert abs(float(sd) - math.sqrt(1 / 3)) < 1e-9

