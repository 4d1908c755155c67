"""Statements held against sqlite3, where the JAX package shares a defect
and so is no oracle for them: ORDER BY / LIMIT / OFFSET after a set
operation, and grouped string keys with NULLs under string functions, set
operations, ROLLUP and CUBE. Each entry is (the engine's statement,
sqlite3's form or None where it is the same): sqlite3 needs a LIMIT before
an OFFSET, parses a parenthesized query only as a derived table, and has no
ROLLUP or CUBE (their UNION ALL expansion stands in). The CPU tests hold the
port against sqlite3 on them (tests/test_torch_setop_modifiers.py,
tests/test_torch_null_string_keys.py); chip_smoke.py holds the card against
the port's CPU session and sqlite3 on them."""

import numpy as np

SETOP_SETUP = [
    "CREATE TABLE a(x INT)",
    "INSERT INTO a VALUES (1), (5), (3)",
    "CREATE TABLE bb(y INT)",
    "INSERT INTO bb VALUES (4), (2), (6)",
]
_U = "SELECT x FROM a UNION ALL SELECT y FROM bb"

# the trailing modifiers apply to the whole result (the JAX package binds
# them to the set operation's last branch)
SETOP_WHOLE_RESULT = {
    "union_all_order_desc_limit": (f"{_U} ORDER BY 1 DESC LIMIT 2", None),
    "union_all_limit": (f"{_U} LIMIT 4", None),
    "three_branches_order_limit": (
        f"{_U} UNION ALL SELECT 9 ORDER BY 1 LIMIT 3", None),
    "union_order_desc": (
        "SELECT x FROM a UNION SELECT y FROM bb ORDER BY 1 DESC", None),
    "except_order_desc": (
        "SELECT x FROM a EXCEPT SELECT y FROM bb ORDER BY 1 DESC", None),
    "intersect_order_desc": (
        "SELECT x FROM a INTERSECT SELECT y - 1 FROM bb ORDER BY 1 DESC", None),
    "offset_alone": (f"{_U} ORDER BY 1 OFFSET 2",
                     f"{_U} ORDER BY 1 LIMIT -1 OFFSET 2"),
    "limit_offset": (f"{_U} ORDER BY 1 DESC LIMIT 2 OFFSET 1", None),
    "subquery_in_from": (
        f"SELECT count(*) FROM ({_U} ORDER BY 1 LIMIT 2) z", None),
    "cte": (f"WITH c AS ({_U} ORDER BY 1 DESC LIMIT 3) SELECT sum(x) FROM c",
            None),
    "in_subquery": (
        "SELECT x FROM a WHERE x IN (SELECT y - 1 FROM bb UNION SELECT 9 "
        "ORDER BY 1 LIMIT 2) ORDER BY x", None),
    "plain_select_offset_alone": (
        "SELECT x FROM a ORDER BY x OFFSET 1",
        "SELECT x FROM a ORDER BY x LIMIT -1 OFFSET 1"),
    "parenthesized_query_then_order": (
        "(SELECT x FROM a ORDER BY x LIMIT 2) ORDER BY 1 DESC",
        "SELECT * FROM (SELECT x FROM a ORDER BY x LIMIT 2) ORDER BY 1 DESC"),
    "parenthesized_set_then_order_limit": (
        f"({_U} ORDER BY 1 LIMIT 3) ORDER BY 1 DESC LIMIT 2",
        f"SELECT * FROM ({_U} ORDER BY 1 LIMIT 3) ORDER BY 1 DESC LIMIT 2"),
}

# parsed as the JAX package parses them: a parenthesized branch keeps its
# own modifiers, a plain SELECT and the pipe operator's set operation too
SETOP_UNCHANGED = {
    "plain_select_order_limit": ("SELECT x FROM a ORDER BY x DESC LIMIT 2",
                                 None),
    "plain_select_limit_offset": (
        "SELECT y FROM bb ORDER BY y LIMIT 2 OFFSET 1", None),
    "parenthesized_branches": (
        "(SELECT x FROM a ORDER BY x LIMIT 1) UNION ALL "
        "(SELECT y FROM bb ORDER BY y DESC LIMIT 1)",
        "SELECT * FROM (SELECT x FROM a ORDER BY x LIMIT 1) UNION ALL "
        "SELECT * FROM (SELECT y FROM bb ORDER BY y DESC LIMIT 1)"),
    "pipe_set_operation": (
        "FROM a |> SELECT x |> UNION ALL SELECT y FROM bb ORDER BY y DESC "
        "LIMIT 1",
        "SELECT x FROM a UNION ALL "
        "SELECT * FROM (SELECT y FROM bb ORDER BY y DESC LIMIT 1)"),
}


def _lit(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return f"'{v}'"
    return str(v)


def _values(rows) -> str:
    return ", ".join("(" + ", ".join(_lit(x) for x in r) + ")" for r in rows)


def null_key_setup(rows: int = 40, seed: int = 20240601,
                   table: str = "t") -> list[str]:
    """`table`(id, v, d, s, b) of `rows` rows made from `seed`, with NULLs in
    the strings d and s and the bool b, and u(k, e, s, w) of 12 rows to join
    and correlate with (made only for the default name t)."""
    rng = np.random.default_rng(seed)

    def pick(vals, p_null):
        return None if rng.random() < p_null else vals[rng.integers(len(vals))]

    t = [(i, int(rng.integers(0, 100)), pick(["abc", "x", "y", "zz", ""], 0.2),
          pick(["p", "q", "rr"], 0.25), pick([True, False], 0.2))
         for i in range(rows)]
    out = [f"CREATE TABLE {table}(id INT, v INT, d VARCHAR(10), "
           "s VARCHAR(10), b BOOLEAN)",
           f"INSERT INTO {table} VALUES {_values(t)}"]
    if table == "t":
        u = [(pick([True, False], 0.1), pick(["abc", "x", "zz", "w"], 0.2),
              pick(["p", "q", "rr"], 0.2), int(rng.integers(0, 50)))
             for _ in range(12)]
        out += ["CREATE TABLE u(k BOOLEAN, e VARCHAR(10), s VARCHAR(10), "
                "w INT)",
                f"INSERT INTO u VALUES {_values(u)}"]
    return out


def cube_two_keys(table: str, a: str, b: str) -> tuple:
    """CUBE(a, b) over `table` with its UNION ALL expansion."""
    aggs = "count(*), sum(v)"
    return (f"SELECT {a}, {b}, {aggs} FROM {table} GROUP BY CUBE({a}, {b})",
            f"SELECT {a}, {b}, {aggs} FROM {table} GROUP BY {a}, {b} "
            f"UNION ALL SELECT {a}, NULL, {aggs} FROM {table} GROUP BY {a} "
            f"UNION ALL SELECT NULL, {b}, {aggs} FROM {table} GROUP BY {b} "
            f"UNION ALL SELECT NULL, NULL, {aggs} FROM {table}")


# over null_key_setup()'s tables; no ORDER BY: rows compare as multisets
NULL_KEY_STATEMENTS = {
    "upper": ("SELECT upper(d), count(*) FROM t GROUP BY d", None),
    "concat_const": ("SELECT d || 'q', count(*) FROM t GROUP BY d", None),
    "length": ("SELECT length(d), count(*) FROM t GROUP BY d", None),
    "replace": ("SELECT replace(d, 'a', 'b'), count(*) FROM t GROUP BY d",
                None),
    "concat_two_keys": ("SELECT d || s, count(*) FROM t GROUP BY d, s", None),
    "union_null_total": (
        "SELECT d, count(*) FROM t GROUP BY d "
        "UNION ALL SELECT NULL, count(*) FROM t", None),
    "having_union_total": (
        "SELECT d, count(*) FROM t GROUP BY d HAVING count(*) > 1 "
        "UNION ALL SELECT 'total', count(*) FROM t", None),
    "union_of_groupings": (
        "SELECT d, s, count(*) FROM t GROUP BY d, s "
        "UNION ALL SELECT d, NULL, count(*) FROM t GROUP BY d", None),
    "rollup_d": (
        "SELECT d, count(*), sum(v) FROM t GROUP BY ROLLUP(d)",
        "SELECT d, count(*), sum(v) FROM t GROUP BY d "
        "UNION ALL SELECT NULL, count(*), sum(v) FROM t"),
    "cube_b_d": cube_two_keys("t", "b", "d"),
    "cube_d_s": cube_two_keys("t", "d", "s"),
    "rollup_b_d": (
        "SELECT b, d, count(*), max(v) FROM t GROUP BY ROLLUP(b, d)",
        "SELECT b, d, count(*), max(v) FROM t GROUP BY b, d "
        "UNION ALL SELECT b, NULL, count(*), max(v) FROM t GROUP BY b "
        "UNION ALL SELECT NULL, NULL, count(*), max(v) FROM t"),
    # right in the port before; the JAX package raises on the tensor tier
    "join_grouped_key": (
        "SELECT z.d, u.w FROM (SELECT d FROM t GROUP BY d) z "
        "JOIN u ON z.d = u.e", None),
    "left_join_grouped_key": (
        "SELECT z.d, u.w FROM (SELECT d FROM t GROUP BY d) z "
        "LEFT JOIN u ON z.d = u.e", None),
    "intersect_grouped_key": (
        "SELECT d FROM t GROUP BY d INTERSECT SELECT e FROM u", None),
    "correlated_two_keys": (
        "SELECT id, (SELECT max(w) FROM u WHERE u.k = t.b AND u.s = t.s) "
        "FROM t", None),
}


def semantics_setup(rows: int = 300, seed: int = 20241017) -> list[str]:
    """w(id, g, v, m, x, s, dt) of `rows` rows made from `seed`: seven
    partitions g, NULLs in v, m, x, s and dt, and strings with a
    two-byte character ('éclair') and an empty one."""
    rng = np.random.default_rng(seed)

    def maybe(v, p_null=0.15):
        return None if rng.random() < p_null else v

    words = ["apple", "éclair", "banana", "", "kiwi", "Apple pie"]
    t = []
    for i in range(rows):
        day = 1 + int(rng.integers(0, 28))
        t.append((i, int(rng.integers(0, 7)),
                  maybe(int(rng.integers(0, 100))),
                  maybe(f"{int(rng.integers(-50000, 50000)) / 100:.2f}"),
                  maybe(float(rng.integers(-4000, 4000)) / 8),
                  maybe(words[rng.integers(len(words))]),
                  maybe(f"2020-{1 + int(rng.integers(0, 12)):02d}-{day:02d}",
                        0.1)))
    body = ", ".join(
        "(" + ", ".join("NULL" if x is None else
                        (x if j == 3 else _lit(x)) for j, x in enumerate(r))
        + ")" for r in t)
    return ["CREATE TABLE w(id INT, g INT, v INT, m DECIMAL(10,2), x DOUBLE, "
            "s VARCHAR(12), dt DATE)",
            f"INSERT INTO w VALUES {body}"]


class Raises(str):
    """In place of sqlite3's form: the statement must raise, with these
    words in its message (PostgreSQL's)."""


def _w(expr: str, where: str = "") -> str:
    return f"SELECT id, {expr} FROM w {where}ORDER BY id"


# over semantics_setup()'s table, each ordered by id. The second entry is
# sqlite3's form where it differs from the statement (PostgreSQL's result
# spelled for sqlite3 where the two disagree), or Raises(PostgreSQL's words)
SEMANTICS_STATEMENTS = {
    # lag / lead: the default fills rows outside the partition; offset 0 is
    # the current row; a NULL offset gives NULL
    "lag_default": (_w("lag(v, 1, -99) OVER (PARTITION BY g ORDER BY id)"),
                    None),
    "lead_default": (_w("lead(v, 1, -99) OVER (ORDER BY id)"), None),
    "lag_string_default": (
        _w("lag(s, 1, 'none') OVER (PARTITION BY g ORDER BY id)"), None),
    "lag_decimal_default": (
        _w("lag(m, 2, 0.5) OVER (PARTITION BY g ORDER BY id)"), None),
    "lag_int_decimal_default": (
        _w("lag(v, 1, 0.5) OVER (PARTITION BY g ORDER BY id)"), None),
    "lead_negative_default": (
        _w("lead(s, -2, 'x') OVER (PARTITION BY g ORDER BY id)"), None),
    "lag_offset_zero": (_w("lag(id, 0) OVER (ORDER BY id)"), None),
    "lead_offset_zero": (_w("lead(id, 0) OVER (ORDER BY id)"), None),
    "lag_null_offset": (_w("lag(v, NULL) OVER (ORDER BY id)"), None),
    "lag_beyond_partition": (
        _w("lag(v, 400, 7) OVER (PARTITION BY g ORDER BY id)"), None),
    # ntile: the first size mod k buckets hold one row more
    "ntile_4_of_10": (_w("ntile(4) OVER (ORDER BY id)", "WHERE id < 10 "),
                      None),
    "ntile_7_partitions": (_w("ntile(7) OVER (PARTITION BY g ORDER BY id)"),
                           None),
    "ntile_6_partitions_desc": (
        _w("ntile(6) OVER (PARTITION BY g ORDER BY v DESC NULLS FIRST, id)"), None),
    "ntile_more_than_rows": (_w("ntile(400) OVER (ORDER BY id)"), None),
    "ntile_null": (_w("ntile(NULL) OVER (ORDER BY id)"), _w("NULL")),
    "ntile_zero": (_w("ntile(0) OVER (ORDER BY id)"),
                   Raises("argument of ntile must be greater than zero")),
    # substring: the characters at [start, start + length) within the
    # string; replace with an empty search string
    "substring_zero_start": (_w("substring(s, 0, 3)"), None),
    "substring_negative_start": (_w("substring(s, -1, 3)"),
                                 _w("substr(s, 1, 1)")),
    "substring_far_negative_start": (_w("substring(s, -5, 3)"),
                                     _w("substr(s, 1, 0)")),
    "substring_from_for": (_w("substring(s FROM 0 FOR 4)"),
                           _w("substr(s, 0, 4)")),
    "substring_negative_length": (
        _w("substring(s, 1, -1)"),
        Raises("negative substring length not allowed")),
    "replace_empty_search": (_w("replace(s, '', 'x')"), None),
    "replace_null_to": (_w("replace(s, 'a', NULL)"), None),
    "replace_null_from": (_w("replace(s, NULL, 'x')"), None),
    "substring_null_start": (_w("substring(s, NULL, 2)"), None),
    "substring_null_length": (_w("substring(s, 2, NULL)"), None),
    "round_null_digits": (_w("round(m, NULL)"), None),
    "like_null": (_w("s LIKE NULL"), None),
    "date_plus_null": (_w("dt + NULL"), None),
    "null_plus_date": (_w("NULL + dt"), None),
    # more of the same: NULL in any argument of a string or date function
    "regexp_replace_null_pattern": (_w("regexp_replace(s, NULL, 'x')"),
                                    _w("NULL")),
    "regexp_replace_null_replacement": (_w("regexp_replace(s, 'a', NULL)"),
                                        _w("NULL")),
    "starts_with_null": (_w("starts_with(s, NULL)"), _w("NULL")),
    "ends_with_null": (_w("ends_with(s, NULL)"), _w("NULL")),
    "length_null": (_w("length(NULL)"), None),
    "substring_of_null": (_w("substring(NULL, 1, 2)"), None),
    "null_like": (_w("NULL LIKE 'a%'"), None),
    "ilike_null": (_w("s ILIKE NULL"), _w("s LIKE NULL")),
    "not_like_null": (_w("s NOT LIKE NULL"), None),
    "date_trunc_null_part": (_w("date_trunc(NULL, dt)"), _w("NULL")),
    "date_part_null_part": (_w("date_part(NULL, dt)"), _w("NULL")),
    "date_minus_null": (_w("dt - NULL"), None),
    "not_null": (_w("NOT NULL"), None),
    # concat() skips NULL arguments, as || does not
    "concat_skips_null_column": (_w("concat(s, 'x')"),
                                 _w("coalesce(s, '') || 'x'")),
    "concat_skips_null_literal": (_w("concat(s, NULL, '-')"),
                                  _w("coalesce(s, '') || '-'")),
    # an exact wide decimal (a division's quotient) beside a tensor column
    # (sqlite3 divides an integral value as an integer)
    "wide_decimal_plus_column": (_w("m / 3 + v"), _w("m / 3.0 + v")),
    "wide_decimal_plus_decimal": (_w("m / 3 + m * 2"),
                                  _w("m / 3.0 + m * 2")),
    # nth_value's position: below 1 raises, NULL gives NULL
    "nth_value_null": (_w("nth_value(v, NULL) OVER (ORDER BY id)"),
                       _w("NULL")),
    "nth_value_zero": (
        _w("nth_value(v, 0) OVER (ORDER BY id)"),
        Raises("argument of nth_value must be greater than zero")),
}
