"""sqlite3 differential oracle.

Runs the reference TPC-H query texts (resources/sql/tpch/*.sql) against
sqlite3 on identical generated data, adapting the few constructs sqlite
lacks (typed date literals, literal interval arithmetic, EXTRACT,
SUBSTRING FROM/FOR). Used by tests to validate our engine's results without
the reference binaries."""

from __future__ import annotations

import re
import sqlite3

import numpy as np


def _shift_date(base: str, n: int, unit: str, sign: int) -> str:
    m = re.match(r"^(\d{4})-(\d{1,2})-(\d{1,2})$", base.strip())
    if m:
        base = f"{m.group(1)}-{int(m.group(2)):02d}-{int(m.group(3)):02d}"
    d = np.datetime64(base)
    unit = unit.rstrip("s").lower()
    if unit == "day":
        out = d + np.timedelta64(sign * n, "D")
    elif unit == "month":
        m = d.astype("datetime64[M]") + np.timedelta64(sign * n, "M")
        day = (d - d.astype("datetime64[M]").astype("datetime64[D]")).astype(int)
        out = m.astype("datetime64[D]") + day
    elif unit == "year":
        m = d.astype("datetime64[M]") + np.timedelta64(sign * 12 * n, "M")
        day = (d - d.astype("datetime64[M]").astype("datetime64[D]")).astype(int)
        out = m.astype("datetime64[D]") + day
    else:
        raise ValueError(unit)
    return str(out)


def adapt_for_sqlite(sql: str) -> str:
    # date 'X' +/- interval 'N' unit  -> computed literal
    def repl_arith(m):
        base, op, n, unit = m.group(1), m.group(2), int(m.group(3)), m.group(4)
        return "'" + _shift_date(base, n, unit, 1 if op == "+" else -1) + "'"

    sql = re.sub(
        r"date\s+'(\d{4}-\d{1,2}-\d{1,2})'\s*([+-])\s*interval\s+'(\d+)'\s+(\w+)",
        repl_arith, sql, flags=re.IGNORECASE,
    )
    # TPC-DS style: (cast('1998-02-22' as date) + interval '30 days')
    sql = re.sub(
        r"cast\s*\(\s*'(\d{4}-\d{1,2}-\d{1,2})'\s+as\s+date\s*\)\s*([+-])\s*"
        r"interval\s+'(\d+)\s*(\w+?)s?'",
        repl_arith, sql, flags=re.IGNORECASE,
    )
    def _pad(m):
        return f"'{int(m.group(1)):04d}-{int(m.group(2)):02d}-{int(m.group(3)):02d}'"

    # bare cast('X' as date) comparisons work as strings in sqlite
    sql = re.sub(
        r"cast\s*\(\s*'(\d{4})-(\d{1,2})-(\d{1,2})'\s+as\s+date\s*\)",
        _pad, sql, flags=re.IGNORECASE,
    )

    # bare typed date literal (zero-padded for sqlite string comparison)
    sql = re.sub(r"date\s+'(\d{4})-(\d{1,2})-(\d{1,2})'", _pad, sql, flags=re.IGNORECASE)
    # bare date-shaped string literals ('2002-4-01'): zero-pad so sqlite's
    # TEXT comparison against ISO-stored dates works
    sql = re.sub(r"'(\d{4})-(\d{1,2})-(\d{1,2})'", _pad, sql)
    # column + interval 'N days' -> date(col, '+N day')
    sql = re.sub(
        r"(\w+(?:\.\w+)?)\s*([+-])\s*interval\s+'(\d+)\s*(day|month|year)s?'",
        lambda m: f"date({m.group(1)}, '{m.group(2)}{m.group(3)} {m.group(4)}')",
        sql, flags=re.IGNORECASE,
    )
    # sqlite rejects parenthesized set-operation operands:
    # "(select..) except (select..)" -> "(select.. except select..)"
    sql = re.sub(r"\)\s*(union all|union|except|intersect)\s*\(\s*(select)\b",
                 r" \1 \2", sql, flags=re.IGNORECASE)
    # CAST(x AS DECIMAL/NUMERIC(p,s)) keeps integer affinity in sqlite, so
    # 294/304 would integer-divide to 0; force REAL
    sql = re.sub(r"as\s+(?:decimal|numeric)\s*(?:\(\s*\d+\s*(?:,\s*\d+)?\s*\))?",
                 "AS REAL", sql, flags=re.IGNORECASE)
    # extract(part from X)
    _FMT = {"year": "%Y", "month": "%m", "day": "%d", "hour": "%H",
            "minute": "%M", "second": "%S"}

    def _extract(m):
        part = m.group(1).lower()
        return f"CAST(strftime('{_FMT[part]}', {m.group(2)}) AS INTEGER)"

    sql = re.sub(
        r"extract\s*\(\s*(year|month|day|hour|minute|second)\s+from\s+([^)]+)\)",
        _extract, sql, flags=re.IGNORECASE,
    )
    # date_trunc('unit', X) -> strftime truncation (minute/hour enough for
    # the suites; comparisons/grouping stay consistent as strings)
    _TRUNC = {"minute": "%Y-%m-%d %H:%M:00", "hour": "%Y-%m-%d %H:00:00",
              "day": "%Y-%m-%d 00:00:00"}

    def _dtrunc(m):
        return f"strftime('{_TRUNC[m.group(1).lower()]}', {m.group(2)})"

    sql = re.sub(
        r"date_trunc\s*\(\s*'(minute|hour|day)'\s*,\s*([^)]+)\)",
        _dtrunc, sql, flags=re.IGNORECASE,
    )
    # postgres :: casts
    sql = re.sub(r"::\s*(?:float8|float4|float|double(?:\s+precision)?|real"
                 r"|decimal(?:\([^)]*\))?|numeric(?:\([^)]*\))?)",
                 " + 0.0", sql, flags=re.IGNORECASE)
    sql = re.sub(r"::\s*(?:bigint|integer|int)", " + 0", sql, flags=re.IGNORECASE)
    sql = re.sub(r"::\s*(?:varchar(?:\(\d+\))?|text|string)", " || ''", sql,
                 flags=re.IGNORECASE)
    # substring(x from a for b)
    sql = re.sub(
        r"substring\s*\(\s*(\w+(?:\.\w+)?)\s+from\s+(\d+)\s+for\s+(\d+)\s*\)",
        r"substr(\1, \2, \3)", sql, flags=re.IGNORECASE,
    )

    # numeric BETWEEN bounds: sqlite stores decimals as floats, so exact
    # boundary values (0.06 + 0.01 -> 0.069999...) silently exclude rows the
    # exact-decimal engine correctly includes. Fold constant arithmetic with
    # python Decimal and widen the bounds by an epsilon far below the data's
    # cent granularity.
    from decimal import Decimal

    def repl_between(m):
        def ev(expr):
            parts = re.split(r"\s*([+-])\s*", expr.strip())
            v = Decimal(parts[0])
            for op, rhs in zip(parts[1::2], parts[2::2]):
                v = v + Decimal(rhs) if op == "+" else v - Decimal(rhs)
            return float(v)

        lo, hi = ev(m.group(1)), ev(m.group(2))
        return f"between {lo - 1e-9} and {hi + 1e-9}"

    num = r"[\d.]+(?:\s*[+-]\s*[\d.]+)*"
    sql = re.sub(
        rf"between\s+({num})\s+and\s+({num})",
        repl_between, sql, flags=re.IGNORECASE,
    )
    return sql


def _patch_order_by_nulls(sql: str) -> str:
    """Append explicit NULLS LAST/FIRST to the final top-level ORDER BY so
    sqlite matches the SQL default (ASC->NULLS LAST, DESC->NULLS FIRST;
    sqlite's native default is the opposite)."""
    low = sql.lower()
    # find last top-level 'order by' (not inside parens e.g. window specs)
    depth = 0
    pos = -1
    i = 0
    while i < len(low):
        c = low[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "'":
            j = i + 1
            while j < len(low) and low[j] != "'":
                j += 1
            i = j
        elif depth == 0 and low.startswith("order", i) and re.match(r"order\s+by", low[i:]):
            pos = i
        i += 1
    if pos < 0:
        return sql
    m = re.match(r"order\s+by", low[pos:])
    start = pos + m.end()
    # find end of the order-by item list (top-level LIMIT/OFFSET or end)
    tail = re.search(r"\b(limit|offset)\b", low[start:])
    end = start + tail.start() if tail else len(sql)
    items_sql = sql[start:end]
    # split top-level commas
    items, depth, cur = [], 0, []
    for ch in items_sql:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    items.append("".join(cur))
    fixed = []
    for it in items:
        s = it.strip().rstrip(";").strip()
        if not s or re.search(r"\bnulls\s+(first|last)\b", s, re.IGNORECASE):
            fixed.append(it)
            continue
        if re.search(r"\bdesc\b\s*$", s, re.IGNORECASE):
            fixed.append(" " + s + " NULLS FIRST")
        else:
            fixed.append(" " + s + " NULLS LAST")
    trailer = ";" if items_sql.rstrip().endswith(";") else ""
    return sql[:start] + ",".join(fixed) + trailer + " " + sql[end:]


class _StdDev:
    """stddev_samp for sqlite (not built in)."""

    def __init__(self):
        self.vals = []

    def step(self, v):
        if v is not None:
            self.vals.append(float(v))

    def finalize(self):
        n = len(self.vals)
        if n < 2:
            return None
        m = sum(self.vals) / n
        return (sum((x - m) ** 2 for x in self.vals) / (n - 1)) ** 0.5


class _VarSamp(_StdDev):
    def finalize(self):
        n = len(self.vals)
        if n < 2:
            return None
        m = sum(self.vals) / n
        return sum((x - m) ** 2 for x in self.vals) / (n - 1)


def run_sqlite(conn, sql: str) -> list[tuple]:
    try:
        conn.create_aggregate("stddev_samp", 1, _StdDev)
        conn.create_aggregate("stddev", 1, _StdDev)
        conn.create_aggregate("var_samp", 1, _VarSamp)
        conn.create_aggregate("variance", 1, _VarSamp)
        import math
        import re as _re

        conn.create_function(
            "sqrt", 1,
            lambda x: None if x is None or x < 0 else math.sqrt(x))
        conn.create_function(
            "regexp_replace", 3,
            lambda s, p, r: None if s is None else _re.sub(p, r, s))
    except Exception:
        pass
    cur = conn.cursor()
    # sqlite's LIKE is case-insensitive by default; SQL (and our engine and
    # the reference) are case-sensitive
    cur.execute("PRAGMA case_sensitive_like=ON")
    q = _patch_order_by_nulls(adapt_for_sqlite(sql))
    for _ in range(4):
        try:
            cur.execute(q)
            return cur.fetchall()
        except sqlite3.OperationalError as e:
            # SQL resolves a final ORDER BY name against the OUTPUT columns;
            # sqlite calls it ambiguous when several FROM items carry it
            # (TPC-DS q58/q72, where the join equates them anyway). Qualify
            # with the first alias the query itself uses and retry.
            m = re.match(r"ambiguous column name: (\w+)", str(e))
            if not m:
                raise
            col = m.group(1)
            qual = re.search(rf"(\w+)\.{col}\b", q)
            lo = q.lower().rfind("order by")
            if not qual or lo < 0:
                raise
            head, tail = q[:lo], q[lo:]
            tail = re.sub(rf"(?<![\w.]){col}(?![\w.])",
                          f"{qual.group(1)}.{col}", tail)
            q = head + tail
    cur.execute(q)
    return cur.fetchall()


def rows_equal(ours: list[list], theirs: list[tuple], ordered: bool,
               rel_tol: float = 1e-6, abs_tol: float = 2e-2) -> tuple[bool, str]:
    """Compare result rows. Numerics compare with tolerance (sqlite computes
    decimals in float); strings/dates exact. abs_tol absorbs sub-cent
    rounding differences on aggregated decimals."""
    if len(ours) != len(theirs):
        return False, f"row count {len(ours)} vs {len(theirs)}"

    def norm(row):
        out = []
        for v in row:
            if isinstance(v, float):
                out.append(("f", round(v, 2)))
            elif isinstance(v, (int, np.integer)):
                out.append(("i", int(v)))
            elif v is None:
                out.append(("n",))
            else:
                out.append(("s", str(v).rstrip()))
        return tuple(out)

    a = [norm(r) for r in ours]
    b = [norm(r) for r in theirs]
    if not ordered:
        a = sorted(a)
        b = sorted(b)

    def close(x, y):
        if x[0] == "i" and y[0] == "i":
            return x[1] == y[1]  # integer columns compare exactly
        if x[0] in ("i", "f") and y[0] in ("i", "f"):
            # one side int, other float (type rendering differs): fuzzy
            fx, fy = float(x[1]), float(y[1])
            return abs(fx - fy) <= max(abs_tol, rel_tol * max(abs(fx), abs(fy)))
        if x[0] != y[0]:
            return False
        return x == y

    for i, (ra, rb) in enumerate(zip(a, b)):
        if len(ra) != len(rb):
            return False, f"col count row {i}"
        for x, y in zip(ra, rb):
            if not close(x, y):
                return False, f"row {i}: ours={ra} theirs={rb}"
    return True, ""


def our_rows(res) -> list[list]:
    """ResultTable -> python rows with decimals as floats, dates as ISO."""
    from ..runtime.vtable import dec_is_float
    from ..sql.types import K
    from ..storage.column import EPOCH

    rows = []
    for r in res.to_pylist():
        row = []
        for v, t in zip(r, res.types):
            if v is None:
                row.append(None)
            elif t.kind == K.DECIMAL and not dec_is_float(t):
                row.append(v / 10**t.s)
            elif t.kind == K.DECIMAL:
                row.append(float(v))
            elif t.kind == K.DATE:
                row.append(str(EPOCH + np.timedelta64(int(v), "D")))
            elif t.kind == K.TIMESTAMP:
                ts = np.datetime64(0, "us") + np.timedelta64(int(v), "us")
                s = str(ts).replace("T", " ")
                row.append(s[:-7] if s.endswith(".000000") else s)
            else:
                row.append(v)
        rows.append(row)
    return rows
