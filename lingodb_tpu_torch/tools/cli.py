"""Command-line tools.

Equivalents of the reference's tool binaries (src/tools/):
  sql             interactive REPL (reference: src/tools/sql.cpp:100-168)
  run-sql         batch runner: run-sql file.sql db-dir (run-sql.cpp:15-42)
  sql-to-plan     dump the optimized logical plan for a query, the analogue
                  of sql-to-mlir's canonical relalg dump (sql-to-mlir.cpp)
  sql-to-json     the optimized plan as JSON; run-plan executes it
  sqlite-tester   sqllogictest conformance runner (sqlite-tester.cpp)
  profile         per-pass plans, per-operator times and host counters
  sql-to-artifact, run-artifact
                  a query packaged with its plan and learned capacities
                  (tools/artifact.py), run in a cold process

Invoke as `python -m lingodb_tpu_torch.tools.cli <tool> ... [--device D]`.
The session runs on the CUDA card, and a tool raises where there is none;
`--device cpu` (anywhere among the arguments) is the caller's explicit ask
for the host.
"""

from __future__ import annotations

import sys
import time

# the --device argument of this invocation (main() takes it off argv)
_DEVICE: str | None = None


def _open_session(db_dir: str | None):
    import lingodb_tpu_torch as ldb

    if db_dir and db_dir != ":memory:":
        return ldb.connect_to_db(db_dir, device=_DEVICE)
    return ldb.create_in_memory(device=_DEVICE)


def repl(argv: list[str]) -> int:
    """Interactive shell; reports per-phase timings like the reference's
    `sql` tool when `SET sql.report_times = true`."""
    db_dir = argv[0] if argv else None
    session = _open_session(db_dir)
    print("lingodb_tpu_torch SQL shell — end with ; ('exit' to quit)")
    buf = ""
    while True:
        try:
            line = input("sql> " if not buf else "...> ")
        except EOFError:
            break
        if line.strip().lower() in ("exit", "quit", "\\q"):
            break
        buf += ("\n" if buf else "") + line
        if not buf.rstrip().endswith(";"):
            continue
        q, buf = buf, ""
        t0 = time.time()
        try:
            result = session.sql(q)
        except Exception as e:  # parse/bind/execution errors -> message, keep going
            print(f"error: {e}")
            continue
        if result is not None:
            print(result.pretty())
            print(f"({result.num_rows} rows, {1e3 * (time.time() - t0):.1f} ms)")
    return 0


def run_sql(argv: list[str]) -> int:
    if not argv:
        print("usage: run-sql <file.sql> [db-dir]", file=sys.stderr)
        return 2
    sql = open(argv[0]).read()
    session = _open_session(argv[1] if len(argv) > 1 else None)
    result = session.sql(sql)
    if result is not None:
        print(result.pretty(max_rows=10_000))
    return 0


def sql_to_plan(argv: list[str]) -> int:
    if not argv:
        print("usage: sql-to-plan <file.sql|query> [db-dir]", file=sys.stderr)
        return 2
    import os

    q = open(argv[0]).read() if os.path.exists(argv[0]) else argv[0]
    session = _open_session(argv[1] if len(argv) > 1 else None)
    result = session.sql("EXPLAIN " + q)
    for row in result.format_rows():
        print(row[0])
    return 0


def sqlite_tester(argv: list[str]) -> int:
    if not argv:
        print("usage: sqlite-tester <file.test> [db-dir]", file=sys.stderr)
        return 2
    from ..tester.runner import run_file

    session = _open_session(argv[1] if len(argv) > 1 else None)
    t0 = time.time()
    stats = run_file(session, argv[0], stop_on_error=False)
    print(f"t: {time.time() - t0:.1f} statements: {stats.statements} "
          f"queries: {stats.queries} failures: {len(stats.failures)}")
    for f in stats.failures[:20]:
        print("FAIL:", f)
    return 0 if stats.ok else 1


def sql_to_json(argv: list[str]) -> int:
    if not argv:
        print("usage: sql-to-json <file.sql|query> [db-dir]", file=sys.stderr)
        return 2
    import os

    q = open(argv[0]).read() if os.path.exists(argv[0]) else argv[0]
    session = _open_session(argv[1] if len(argv) > 1 else None)
    print(session.plan_json(q))
    return 0


def run_plan(argv: list[str]) -> int:
    if not argv:
        print("usage: run-plan <plan.json> [db-dir]", file=sys.stderr)
        return 2
    session = _open_session(argv[1] if len(argv) > 1 else None)
    result = session.run_plan(open(argv[0]).read())
    if result is not None:
        print(result.pretty(max_rows=10_000))
    return 0


def sql_to_artifact(argv: list[str]) -> int:
    """Package one query with its optimized plan and learned capacities
    (reference: tools/standalone-query/ builds a query into an
    executable)."""
    if len(argv) < 2:
        print("usage: sql-to-artifact <file.sql|query> <out.lqa> [db-dir]",
              file=sys.stderr)
        return 2
    import os

    from .artifact import build_artifact

    q = open(argv[0]).read() if os.path.exists(argv[0]) else argv[0]
    session = _open_session(argv[2] if len(argv) > 2 else None)
    m = build_artifact(session, q, argv[1])
    print(f"wrote {argv[1]}: {len(m['capacities'])} capacities, "
          f"{len(m['kernels'])} kernels, platform={m['platform']}")
    return 0


def run_artifact_cmd(argv: list[str]) -> int:
    if not argv:
        print("usage: run-artifact <artifact.lqa> [db-dir]", file=sys.stderr)
        return 2
    from ..utils import compilestats
    from .artifact import run_artifact

    session = _open_session(argv[1] if len(argv) > 1 else None)
    cs0 = compilestats.snapshot()
    t0 = time.time()
    result = run_artifact(session, argv[0])
    dt = time.time() - t0
    cs = compilestats.delta(cs0)
    if result is not None:
        print(result.pretty(max_rows=10_000))
    print(f"# cold run {dt * 1e3:.1f}ms parses={cs['parses']} "
          f"optimizations={cs['optimizations']} "
          f"calibrations={cs['calibrations']} captures={cs['captures']}",
          file=sys.stderr)
    return 0


def profile(argv: list[str]) -> int:
    """Per-pass plan snapshots + per-operator and per-phase timings + host HW
    counters for one query (the reference's ct / pass-profiler / PerfEvent
    tooling surface, tools/ct + Instrumentation.cpp + PerfEvent.h)."""
    if not argv:
        print("usage: profile <file.sql|query> [db-dir]", file=sys.stderr)
        return 2
    import os

    from ..opt import optimizer
    from ..utils.perf import PerfEvent
    from ..utils.settings import EXECUTION_MODE, SNAPSHOT_PASSES

    q = open(argv[0]).read() if os.path.exists(argv[0]) else argv[0]
    session = _open_session(argv[1] if len(argv) > 1 else None)
    EXECUTION_MODE.set("PERF")
    SNAPSHOT_PASSES.set(True)
    with PerfEvent() as pe:
        result = session.sql(q)
    for name, text in optimizer.last_pass_snapshots or []:
        print(f"== after {name} ==\n{text}")
    prof = session.executor.last_op_profile or []
    total = sum(rec[1] for rec in prof)
    print("== operator profile (self time) ==")
    for name, ms, rows, incl, nbytes, sol in prof:
        print(f"  {name:<14} {ms:9.3f}ms (incl {incl:9.3f})  rows={rows}"
              f"  bytes={nbytes / 1e6:.1f}MB  sol={_sol_text(sol)}")
    print(f"  {'TOTAL':<14} {total:9.3f}ms")
    if pe.supported:
        print("== host counters ==")
        for k, v in pe.counters.items():
            print(f"  {k}: {v}")
    else:
        print("== host counters: perf_event_open refused here ==")
    if result is not None:
        print(result.pretty(max_rows=20))
    return 0


def _sol_text(sol) -> str:
    """An operator's speed of light as a multiple ("12.5x"), or "unknown"
    where PERF mode had no bandwidth to read it against (system.hbm_gbps
    unset)."""
    return sol if isinstance(sol, str) else f"{sol}x"


TOOLS = {
    "sql": repl,
    "run-sql": run_sql,
    "sql-to-plan": sql_to_plan,
    "sql-to-json": sql_to_json,
    "run-plan": run_plan,
    "sqlite-tester": sqlite_tester,
    "profile": profile,
    "sql-to-artifact": sql_to_artifact,
    "run-artifact": run_artifact_cmd,
}


def main(argv: list[str] | None = None) -> int:
    global _DEVICE
    argv = list(sys.argv[1:] if argv is None else argv)
    _DEVICE = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device needs a value (cpu, cuda, cuda:N)", file=sys.stderr)
            return 2
        _DEVICE = argv[i + 1]
        del argv[i:i + 2]
    if not argv or argv[0] not in TOOLS:
        print(f"usage: python -m lingodb_tpu_torch.tools.cli "
              f"<{'|'.join(TOOLS)}> ... [--device cpu]", file=sys.stderr)
        return 2
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
