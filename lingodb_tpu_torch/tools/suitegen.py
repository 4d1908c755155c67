"""Generic benchmark-suite data generator.

The reference ships query suites whose data comes from downloads its
generate scripts fetch (reference: tools/generate/{ssb.sh, tpcxbb.sh,
test.sh}; resources/sql/clickbench/create.sql loads the public hits.csv).
This module needs no download: it synthesizes schema-shaped,
literal-seeded data for ANY suite directory:

  1. replay the suite's CREATE TABLE DDL through our own parser,
  2. mine every query for `column <op> literal` / LIKE / IN / BETWEEN
     constants so generated values actually hit the filters,
  3. give *key/*id/*_sk columns shared per-suffix integer domains so joins
     find partners (a table whose PK carries the suffix pins the domain),
  4. load the same rows into a sqlite3 connection for differential checks.

The JAX package's tests/test_suites.py uses its copy for ClickBench, SSB,
SSB-simplified and TPCx-BB (taxi ships no queries upstream — nothing to run)."""

from __future__ import annotations

import os
import re

import numpy as np

from ..sql.types import K

GENERIC_STRINGS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
                   "eta", "theta", "iota", "kappa", "mu", "nu", ""]


def _split_statements(sql: str):
    out, cur, ins = [], [], False
    for ch in sql:
        if ch == "'":
            ins = not ins
        if ch == ";" and not ins:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return [s.strip() for s in out if s.strip()]


def read_schema(schema_path: str) -> list[str]:
    """CREATE TABLE statements from an initialize/create script (SET/COPY
    lines dropped)."""
    ddl = []
    for stmt in _split_statements(open(schema_path).read()):
        head = stmt.lstrip().lower()
        if head.startswith("create table"):
            ddl.append(stmt)
    return ddl


_LIT_RE = re.compile(
    r"([A-Za-z_][A-Za-z0-9_.]*)\s*"
    r"(=|<>|!=|<=|>=|<|>|like|not\s+like|between|in)\s*"
    r"('(?:[^']|'')*'|-?\d+(?:\.\d+)?|\((?:\s*'(?:[^']|'')*'|[\s,0-9.'-])*\))",
    re.I)
_STR_RE = re.compile(r"'((?:[^']|'')*)'")
_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?")


def mine_literals(suite_dir: str) -> dict[str, dict]:
    """column (lowercase, unqualified) -> {"strs": set, "nums": set,
    "likes": set} across every query in the suite."""
    out: dict[str, dict] = {}
    for f in sorted(os.listdir(suite_dir)):
        if not f.endswith(".sql") or f in ("initialize.sql", "create.sql"):
            continue
        text = open(os.path.join(suite_dir, f)).read()
        for m in _LIT_RE.finditer(text):
            col = m.group(1).split(".")[-1].lower()
            op = m.group(2).lower()
            lit = m.group(3)
            d = out.setdefault(col, {"strs": set(), "nums": set(),
                                     "likes": set()})
            for sm in _STR_RE.finditer(lit):
                s = sm.group(1).replace("''", "'")
                (d["likes"] if "like" in op else d["strs"]).add(s)
            if not _STR_RE.search(lit):
                for nm in _NUM_RE.finditer(lit):
                    d["nums"].add(float(nm.group(0)))
            if op == "between":
                # second bound follows AND; grab the next literal after match
                tail = text[m.end():m.end() + 64]
                bm = re.match(r"\s*and\s*('(?:[^']|'')*'|-?\d+(?:\.\d+)?)",
                              tail, re.I)
                if bm:
                    b = bm.group(1)
                    if b.startswith("'"):
                        d["strs"].add(b.strip("'"))
                    else:
                        d["nums"].add(float(b))
    return out


def _like_matcher(pat: str) -> str:
    """A concrete string the LIKE pattern accepts."""
    return pat.replace("%", "x").replace("_", "y")


_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}")


def _gen_column(rng, name, t, n, lits, key_domains, is_pk_col):
    lname = name.lower()
    d = lits.get(lname, {"strs": set(), "nums": set(), "likes": set()})
    nullable = t.nullable
    valid = None
    if nullable:
        valid = rng.random(n) > 0.04

    def with_nulls(vals):
        return [None if valid is not None and not valid[i] else vals[i]
                for i in range(n)]

    suffix = lname.split("_", 1)[-1] if "_" in lname else lname
    keyish = (t.kind in (K.INT, K.BIGINT)
              and (lname.endswith("key") or lname.endswith("id")
                   or lname.endswith("_sk") or lname == "id"))
    if keyish:
        if is_pk_col:
            key_domains[suffix] = n
            return with_nulls(list(range(n)))
        dom = key_domains.get(suffix, max(n // 4, 64))
        vals = rng.integers(0, dom, n)
        return with_nulls([int(v) for v in vals])
    if t.kind in (K.INT, K.BIGINT):
        nums = sorted(d["nums"])
        lo, hi = (min(nums), max(nums)) if nums else (0, 1000)
        span = max(hi - lo, 10)
        pool = [int(v) for v in nums] + [
            int(lo - span * 0.3 + rng.random() * span * 1.6)
            for _ in range(16)]
        return with_nulls([int(pool[i]) for i in rng.integers(0, len(pool), n)])
    if t.kind in (K.FLOAT, K.DOUBLE, K.DECIMAL):
        nums = sorted(d["nums"])
        lo, hi = (min(nums), max(nums)) if nums else (0.0, 100.0)
        span = max(hi - lo, 1.0)
        vals = lo - span * 0.3 + rng.random(n) * span * 1.6
        if t.kind == K.DECIMAL:
            vals = np.round(vals, t.s)
        return with_nulls([float(v) for v in vals])
    if t.kind in (K.DATE, K.TIMESTAMP):
        anchors = sorted(s for s in d["strs"] if _DATE_RE.match(s))
        base = np.datetime64(anchors[0][:10]) if anchors else np.datetime64("1995-06-01")
        offs = rng.integers(-400, 400, n)
        days = base + offs.astype("timedelta64[D]")
        if t.kind == K.DATE:
            return with_nulls([str(v) for v in days])
        return with_nulls([str(v) + " 00:00:00" for v in days])
    if t.kind == K.BOOL:
        return with_nulls([bool(v) for v in rng.integers(0, 2, n)])
    # strings: literal pool + LIKE matchers + generic fillers, skewed
    pool = sorted(d["strs"]) + [_like_matcher(p) for p in sorted(d["likes"])]
    pool += GENERIC_STRINGS
    if t.kind == K.CHAR and t.p:
        pool = [s[:t.p] for s in pool]
    idx = np.minimum(rng.integers(0, len(pool), n),
                     rng.integers(0, len(pool), n))  # skew toward literals
    return with_nulls([pool[i] for i in idx])


def load_suite(session, suite_dir: str, schema_path: str,
               rows: int = 2000, dim_rows: int = 250, seed: int = 7,
               sqlite_conn=None):
    """Create + populate every table of the suite in `session` (and
    optionally a sqlite connection). Returns {table: n_rows}."""
    from ..sql.parser import parse_sql
    from ..sql import ast as A

    rng = np.random.default_rng(seed)
    lits = mine_literals(suite_dir)
    ddl = read_schema(schema_path)
    loaded = {}
    key_domains: dict[str, int] = {}
    stmts = []
    for stmt_sql in ddl:
        (stmt,) = parse_sql(stmt_sql)
        assert isinstance(stmt, A.CreateTableStmt)
        stmts.append((stmt_sql, stmt))
    # dimension tables (with a PK) load first so fact keys find domains
    stmts.sort(key=lambda p: 0 if p[1].primary_key else 1)
    for stmt_sql, stmt in stmts:
        session.sql_stmt(stmt_sql)
        n = dim_rows if stmt.primary_key else rows
        pk = {c.lower() for c in (stmt.primary_key or [])}
        cols = []
        entry = session.catalog.get_table(stmt.name)
        for cname, ctype in zip(entry.column_names, entry.column_types):
            cols.append(_gen_column(rng, cname, ctype, n, lits, key_domains,
                                    cname.lower() in pk))
        rows_py = list(map(list, zip(*cols)))
        entry.storage.append_rows(rows_py)
        loaded[stmt.name] = n
        if sqlite_conn is not None:
            cdefs = ",".join(f'"{c}"' for c in entry.column_names)
            qs = ",".join("?" * len(entry.column_names))
            sqlite_conn.execute(f'create table "{stmt.name}" ({cdefs})')
            sqlite_conn.executemany(
                f'insert into "{stmt.name}" values ({qs})', rows_py)
    return loaded
