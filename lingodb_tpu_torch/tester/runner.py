"""sqllogictest runner.

Equivalent of the reference's sqlite-tester
(reference: src/tools/sqlite-tester.cpp — parses `statement ok` / `query
<types> <sort>` blocks, normalizes values (null->NULL, true->t, doubles
truncated to 3 digits), supports literal expected rows with fuzzy decimal
comparison and `N values hashing to <md5>` expectations). The reference's
test files under test/sqlite* run unmodified against this runner.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field

from ..runtime.result import ResultTable, format_value, truncate_double_digits
from ..sql.types import K


@dataclass
class TestStats:
    statements: int = 0
    queries: int = 0
    failures: list = field(default_factory=list)

    @property
    def ok(self):
        return not self.failures


def _filter_lines(lines):
    out = []
    for s in lines:
        i = s.find("#")
        if i != -1 and i <= 1:
            s = s[:i]
        out.append(s.rstrip(" "))
    return out


def run_file(session, path: str, stop_on_error=True, verbose=False) -> TestStats:
    with open(path) as f:
        lines = _filter_lines(f.read().splitlines())
    stats = TestStats()
    i = 0
    first_query = True
    while i < len(lines):
        parts = lines[i].split()
        if not parts:
            i += 1
            continue
        if parts[0] == "statement":
            i = _run_statement(session, lines, i, parts, stats, stop_on_error)
        elif parts[0] == "query":
            # reference skips the first query block (it's a header in their files)
            if first_query:
                first_query = False
                i += 1
                continue
            i = _run_query(session, lines, i, parts, stats, stop_on_error, verbose)
        elif parts[0] == "hash-threshold":
            i += 2
        else:
            i += 1
    return stats


def _run_statement(session, lines, i, parts, stats, stop_on_error):
    i += 1
    stmt_lines = []
    dollar = False
    while i < len(lines):
        if lines[i] == "" and not dollar:
            i += 1
            break
        if "$$" in lines[i]:
            dollar = not dollar
        stmt_lines.append(lines[i])
        i += 1
    stmt = "\n".join(stmt_lines)
    expect_error = len(parts) > 1 and parts[1] != "ok"
    stats.statements += 1
    try:
        session.sql(stmt)
        if expect_error:
            stats.failures.append((stmt, "expected error but succeeded"))
            if stop_on_error:
                raise AssertionError(f"expected error but succeeded: {stmt}")
    except Exception as e:  # noqa: BLE001
        if not expect_error:
            stats.failures.append((stmt, f"unexpected error: {e}"))
            if stop_on_error:
                raise
    return i


def _run_query(session, lines, i, parts, stats, stop_on_error, verbose):
    description = lines[i]
    i += 1
    qlines = []
    while i < len(lines):
        if lines[i] == "----":
            i += 1
            break
        qlines.append(lines[i])
        i += 1
    query = "\n".join(qlines)
    expected = []
    while i < len(lines):
        if lines[i] == "":
            i += 1
            break
        expected.append(lines[i])
        i += 1

    sort_mode = "nosort"
    tsv = len(parts) > 1 and parts[1] == "tsv"
    for p in parts[2:]:
        if p in ("nosort", "valuesort", "rowsort"):
            sort_mode = p

    stats.queries += 1
    try:
        res = session.sql(query)
    except Exception as e:  # noqa: BLE001
        stats.failures.append((description or query, f"query error: {e}"))
        if stop_on_error:
            raise
        return i

    values, ncols = normalize_result(res)
    if sort_mode == "rowsort":
        rows = [values[k:k + ncols] for k in range(0, len(values), ncols)]
        rows.sort()
        values = [v for r in rows for v in r]
    elif sort_mode == "valuesort":
        values = sorted(values)

    ok, msg = compare_expected(values, ncols, expected, tsv)
    if not ok:
        stats.failures.append((query, msg))
        if stop_on_error:
            raise AssertionError(f"{description}\nquery: {query}\n{msg}")
    elif verbose:
        print(f"ok: {description}")
    return i


def normalize_result(res: ResultTable):
    """Result -> flat list of normalized value strings (reference:
    ResultHasher::process, sqlite-tester.cpp:35-190)."""
    ncols = len(res.names)
    values = []
    for row in res.to_pylist():
        for v, t in zip(row, res.types):
            s = format_value(v, t)
            if t.kind == K.DOUBLE or t.kind == K.FLOAT:
                s = truncate_double_digits(s, 3)
            values.append(s)
    return values, ncols


def compare_expected(values, ncols, expected, tsv) -> tuple[bool, str]:
    # hash form: "N values hashing to <md5>"
    if len(expected) == 1:
        m = re.match(r"(\d+) values hashing to ([0-9a-f]{32})", expected[0])
        if m:
            n, h = int(m.group(1)), m.group(2)
            my = md5_values(values)
            if len(values) != n:
                return False, f"value count {len(values)} != {n}"
            if my != h:
                return False, f"hash {my} != {h}"
            return True, ""
    if tsv:
        got_rows = [
            values[k:k + ncols] for k in range(0, len(values), ncols)
        ]
        exp_rows = [e.split("\t") for e in expected]
    else:
        got_rows = [[v] for v in values]
        exp_rows = [[e] for e in expected]
    if len(got_rows) != len(exp_rows):
        return False, (
            f"row count {len(got_rows)} != {len(exp_rows)}\n"
            f"got:      {got_rows[:6]}\nexpected: {exp_rows[:6]}"
        )
    for got, exp in zip(got_rows, exp_rows):
        if len(got) != len(exp):
            return False, f"col count {len(got)} != {len(exp)}: {got} vs {exp}"
        for g, e in zip(got, exp):
            if not value_matches(e.rstrip(" "), g.rstrip(" ")):
                return False, f"mismatch: expected {e!r} got {g!r} (row {got} vs {exp})"
    return True, ""


_DEC_RE = re.compile(r"(-?\d+)\.(\d+)")


def value_matches(expected: str, result: str) -> bool:
    """Fuzzy comparison (reference: compareFuzzy, sqlite-tester.cpp:275-320)."""
    if expected == result:
        return True
    em = _DEC_RE.search(expected)
    rm = _DEC_RE.search(result)
    if em and rm:
        if em.group(1) == rm.group(1):
            ea, ra = em.group(2), rm.group(2)
            if ra.startswith(ea) or ea.startswith(ra):
                return True
            if len(ra) > 4 and len(ea) > 4 and ra[:4] == ea[:4]:
                return True
    if re.fullmatch(r"0\.0+", expected) and re.fullmatch(r"0\.E-\d+", result):
        return True
    # integral doubles: the reference renders them through Arrow PrettyPrint,
    # which drops the trailing ".0" (sqlite-tester.cpp:59-64); accept either
    if result == expected + ".0" or expected == result + ".0":
        return True
    return False


def md5_values(values: list[str]) -> str:
    h = hashlib.md5()
    for v in values:
        h.update(v.encode())
        h.update(b"\n")
    return h.hexdigest()


if __name__ == "__main__":  # python -m lingodb_tpu_torch.tester.runner file.test [db]
    import sys as _sys

    from ..tools.cli import main as _main

    _sys.exit(_main(["sqlite-tester", *_sys.argv[1:]]))
