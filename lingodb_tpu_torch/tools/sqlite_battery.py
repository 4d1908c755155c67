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


def errors_setup() -> list[str]:
    """z(i, k): five rows whose strings are integers but one ('abc'), and
    one NULL."""
    return ["CREATE TABLE z(i INT, k VARCHAR(10))",
            "INSERT INTO z VALUES (1, '12'), (2, 'abc'), (3, '-7'), "
            "(4, NULL), (5, '30')"]


def _z(expr: str, where: str = "") -> str:
    return f"SELECT i, {expr} FROM z {where}ORDER BY i"


# PostgreSQL rounds a double to an integer half to even (rint), spelled for
# sqlite3, which has no rint
_RINT_X = ("CAST(CASE WHEN x - floor(x) = 0.5 THEN (CASE WHEN "
           "CAST(floor(x) AS INT) % 2 = 0 THEN floor(x) ELSE floor(x) + 1 "
           "END) ELSE round(x) END AS INT)")

# Errors the data raises, as PostgreSQL raises them, over semantics_setup()'s
# w and errors_setup()'s z: INT and BIGINT arithmetic out of the type's range
# (C21), a cast from a string that parses only the rows that are live (C22),
# a cast of a decimal or a double to an integer that rounds (C23). The
# second entry is as in SEMANTICS_STATEMENTS: sqlite3's spelling of
# PostgreSQL's result, or Raises(PostgreSQL's words). A row that a filter,
# an earlier conjunct, a join or a CASE branch not taken removes never
# raises; a NULL row never does.
ERROR_STATEMENTS = {
    # C21: INT and BIGINT arithmetic
    "int_mul_chain": (_w("v * 100000 * 100000"),
                      Raises("integer out of range")),
    "int_sum_of_products": (
        "SELECT g, sum(v * 100000000) FROM w GROUP BY g ORDER BY g",
        Raises("integer out of range")),
    "int_mul_by_int_max": (_w("id * 2147483647"),
                           Raises("integer out of range")),
    "int_max_plus_column": (_w("2147483647 + v"),
                            Raises("integer out of range")),
    "int_min_minus_column": (_w("-2147483647 - v"),
                             Raises("integer out of range")),
    "int_max_plus_one": ("SELECT 2147483647 + 1",
                         Raises("integer out of range")),
    "int_negate_min": ("SELECT -CAST(-2147483648 AS INT)",
                       Raises("integer out of range")),
    "int_abs_min": ("SELECT abs(CAST(-2147483648 AS INT))",
                    Raises("integer out of range")),
    "int_min_div_minus_one": ("SELECT CAST(-2147483648 AS INT) / -1",
                              Raises("integer out of range")),
    "bigint_max_plus_column": (_w("9223372036854775807 + v"),
                               Raises("bigint out of range")),
    "bigint_min_minus_column": (_w("-9223372036854775807 - v"),
                                Raises("bigint out of range")),
    "bigint_mul_column": (_w("CAST(v AS BIGINT) * 4000000000000000000"),
                          Raises("bigint out of range")),
    "bigint_mul_past_range": (
        "SELECT CAST(-3037000500 AS BIGINT) * 3037000500",
        Raises("bigint out of range")),
    "bigint_mul_within_range": (
        "SELECT CAST(3037000499 AS BIGINT) * 3037000499", None),
    "int_edges_within_range": (
        "SELECT 2147483646 + 1, -2147483647 - 1, "
        "CAST(-2147483648 AS INT) / 1", None),
    "int_mul_within_range": (_w("v * 21474836"), None),
    "int_overflow_after_false_conjunct": (
        "SELECT id FROM w WHERE v < 22 AND v * 100000000 > 0 ORDER BY id",
        None),
    "int_overflow_in_case_not_taken": (
        _w("CASE WHEN v < 22 THEN v * 100000000 ELSE 0 END"), None),
    "int_sum_of_products_filtered": (
        "SELECT g, sum(v * 100000000) FROM w WHERE v < 22 GROUP BY g "
        "ORDER BY g", None),
    "int_overflow_on_null_rows": (
        _w("v * 100000000", "WHERE v IS NULL OR v < 22 "), None),
    # C22: a cast from a string parses the rows that are live
    "cast_live_rows_only": (_z("CAST(k AS INT)", "WHERE i <> 2 "), None),
    "cast_after_string_filter": (_z("CAST(k AS INT)", "WHERE k <> 'abc' "),
                                 None),
    "cast_in_case_not_taken": (
        _z("CASE WHEN k = 'abc' THEN 0 ELSE CAST(k AS INT) END"), None),
    "cast_after_false_conjunct": (
        "SELECT i FROM z WHERE i <> 2 AND CAST(k AS INT) > 0 ORDER BY i",
        None),
    "cast_after_join": (
        "SELECT z.i, CAST(z.k AS INT) FROM z JOIN (SELECT id FROM w "
        "WHERE id IN (1, 3, 5)) q ON z.i = q.id ORDER BY z.i", None),
    "cast_in_join_filter": (
        "SELECT z.i, w.v FROM z JOIN w ON z.i = w.id WHERE w.id <> 2 "
        "AND CAST(z.k AS INT) + w.v > 0 ORDER BY z.i", None),
    "int_overflow_in_join_filter": (
        "SELECT z.i, w.v FROM z JOIN w ON z.i = w.id AND w.v * 100000000 > "
        "z.i ORDER BY z.i", Raises("integer out of range")),
    "int_overflow_in_join_filter_removed": (
        "SELECT z.i, w.v FROM z JOIN w ON z.i = w.id AND w.v * 100000000 > "
        "z.i WHERE z.i = 3 ORDER BY z.i", None),
    "cast_in_coalesce": (
        _z("COALESCE(CAST(NULLIF(k, 'abc') AS INT), -1)"), None),
    "cast_null_rows": (_z("CAST(k AS INT)", "WHERE k IS NULL OR i > 2 "),
                       None),
    "cast_every_row": (_z("CAST(k AS INT)"),
                       Raises('invalid input syntax for type integer: "abc"')),
    "cast_every_row_bigint": (
        _z("CAST(k AS BIGINT)"),
        Raises('invalid input syntax for type bigint: "abc"')),
    "cast_every_row_numeric": (
        _z("CAST(k AS DECIMAL(10,2))"),
        Raises('invalid input syntax for type numeric: "abc"')),
    "cast_every_row_double": (
        _z("CAST(k AS DOUBLE)"),
        Raises('invalid input syntax for type double precision: "abc"')),
    "cast_every_row_date": (
        _z("CAST(k AS DATE)"),
        Raises('invalid input syntax for type date: "12"')),
    "cast_in_predicate": (
        "SELECT i FROM z WHERE CAST(k AS INT) > 0 ORDER BY i",
        Raises('invalid input syntax for type integer: "abc"')),
    "cast_fraction": ("SELECT CAST('12.7' AS INT)",
                      Raises('invalid input syntax for type integer: "12.7"')),
    "cast_exponent": ("SELECT CAST('1e3' AS INT)",
                      Raises('invalid input syntax for type integer: "1e3"')),
    "cast_blanks": ("SELECT CAST(' 42 ' AS INT), CAST(' -7' AS BIGINT)",
                    None),
    "cast_empty": ("SELECT CAST('' AS INT)",
                   Raises('invalid input syntax for type integer: ""')),
    "cast_past_int": (
        "SELECT CAST('2147483648' AS INT)",
        Raises('value "2147483648" is out of range for type integer')),
    "cast_int_edges": (
        "SELECT CAST('-2147483648' AS INT), CAST('2147483648' AS BIGINT)",
        None),
    "cast_numeric_text": (
        "SELECT CAST(' 12.5 ' AS DECIMAL(10,2)), CAST('1e3' AS DOUBLE), "
        "CAST('-.5' AS DOUBLE)", None),
    # C23: a decimal or a double to an integer rounds
    "decimal_to_int": (_w("CAST(m AS INT)"),
                       _w("CAST(round(m) AS INT)")),
    "decimal_to_bigint": (_w("CAST(m AS BIGINT)"),
                          _w("CAST(round(m) AS INT)")),
    "decimal_halves_to_int": (
        "SELECT CAST(2.5 AS INT), CAST(-2.5 AS INT), CAST(3.5 AS INT), "
        "CAST(-0.5 AS INT)", "SELECT 3, -3, 4, -1"),
    "double_halves_to_int": (
        "SELECT CAST(CAST(2.5 AS DOUBLE) AS INT), "
        "CAST(CAST(-2.5 AS DOUBLE) AS INT), CAST(CAST(3.5 AS DOUBLE) AS INT), "
        "CAST(CAST(-0.5 AS DOUBLE) AS BIGINT)", "SELECT 2, -2, 4, 0"),
    "double_to_int": (_w("CAST(x AS INT)"), _w(_RINT_X)),
    "double_to_bigint": (_w("CAST(x AS BIGINT)"), _w(_RINT_X)),
    "decimal_edge_to_int": (
        "SELECT CAST(2147483646.5 AS INT), CAST(-2147483647.5 AS INT), "
        "CAST(CAST(-2147483648.5 AS DOUBLE) AS INT)",
        "SELECT 2147483647, -2147483648, -2147483648"),
    "decimal_past_int": ("SELECT CAST(2147483647.5 AS INT)",
                         Raises("integer out of range")),
    "double_past_int": ("SELECT CAST(CAST(2147483647.5 AS DOUBLE) AS INT)",
                        Raises("integer out of range")),
    "double_past_bigint": (
        "SELECT CAST(CAST(10000000000000000000.0 AS DOUBLE) AS BIGINT)",
        Raises("bigint out of range")),
    "bigint_past_int": ("SELECT CAST(CAST(3000000000 AS BIGINT) AS INT)",
                        Raises("integer out of range")),
    "bigint_column_past_int": (
        _w("CAST(CAST(v AS BIGINT) * 100000000 AS INT)"),
        Raises("integer out of range")),
    "wide_decimal_past_bigint": (
        "SELECT CAST(CAST(99999999999999999999 AS DECIMAL(20,0)) AS BIGINT)",
        Raises("bigint out of range")),
    "decimal_column_past_int": (
        _w("CAST(m * 100000000 AS INT)"), Raises("integer out of range")),
    # the same constants in VALUES: evaluated as in a select list
    "values_decimal_to_int": (
        "SELECT * FROM (VALUES (CAST(2.5 AS INT)), (CAST(-2.5 AS INT))) v(a)",
        "SELECT 3 UNION ALL SELECT -3"),
    "values_double_to_int": (
        "SELECT * FROM (VALUES (CAST(CAST(2.5 AS DOUBLE) AS INT)), "
        "(CAST(CAST(3.5 AS DOUBLE) AS INT))) v(a)",
        "SELECT 2 UNION ALL SELECT 4"),
    "values_int_overflow": ("SELECT * FROM (VALUES (2147483647 + 1)) v(a)",
                            Raises("integer out of range")),
    "values_string_to_int": (
        "SELECT * FROM (VALUES (CAST('12.7' AS INT))) v(a)",
        Raises('invalid input syntax for type integer: "12.7"')),
}

# INSERT's coercion to the table's types, as PostgreSQL's assignment casts
# coerce (rounding and raising as CAST does): each statement inserts into a
# fresh table {t}(a INT, b BIGINT), then `SELECT a, b FROM {t} ORDER BY a`
# gives the rows of the second entry's sqlite3 statement, or the insert
# raises Raises(PostgreSQL's words)
INSERT_STATEMENTS = {
    "insert_decimal_rounds": (
        "INSERT INTO {t}(a, b) SELECT m, m FROM w WHERE m IS NOT NULL",
        "SELECT CAST(round(m) AS INT) AS a, CAST(round(m) AS INT) FROM w "
        "WHERE m IS NOT NULL ORDER BY a"),
    "insert_double_rounds": (
        "INSERT INTO {t}(a) SELECT x FROM w WHERE x IS NOT NULL",
        f"SELECT {_RINT_X} AS a, NULL FROM w WHERE x IS NOT NULL ORDER BY a"),
    "insert_strings": ("INSERT INTO {t}(a, b) VALUES (' 42 ', '-7')",
                       "SELECT 42, -7"),
    "insert_int_overflow": ("INSERT INTO {t}(a) VALUES (2147483647 + 1)",
                            Raises("integer out of range")),
    "insert_bigint_into_int": ("INSERT INTO {t}(a) VALUES (3000000000)",
                               Raises("integer out of range")),
    "insert_string_fraction": (
        "INSERT INTO {t}(a) VALUES ('12.7')",
        Raises('invalid input syntax for type integer: "12.7"')),
    "insert_column_past_int": (
        "INSERT INTO {t}(a) SELECT CAST(v AS BIGINT) * 100000000 FROM w",
        Raises("integer out of range")),
}


# ------------------------------------------------------------------ C24-C26
# Arithmetic past int64 (C24: DECIMAL products and their sums, exact as
# PostgreSQL's numeric; the JAX package wraps on its tensor tier), sum and
# avg of a BIGINT (C25: a numeric in PostgreSQL; the JAX package sums in
# int64 on both tiers) and casts past a DECIMAL's precision (C26: "numeric
# field overflow"; the JAX package keeps the value). The oracle is sqlite3
# over the same rows with its decimals held as text and computed by Python's
# decimal module (exact_functions: dadd, dsub, dmul, dgt, dround, dsum,
# davg), or Raises(PostgreSQL's words).
def wide_setup(rows: int = 240, seed: int = 20261019,
               sqlite: bool = False) -> list[str]:
    """wide(k, g, x, e, p, d, b, n, f, s) of `rows` rows made from `seed`:
    e a price near 123456.78 (e * e * e passes int64), p near 38000.123456
    ((p - 38000.123456)^2 passes int64 where |p - 38000.123456| > 3037), d
    a DECIMAL(18,2) (every tenth row small), b a BIGINT near 2^62 on three
    rows of four (NULL on some), n a DECIMAL(12,2) that is NULL, small
    (k % 3 = 0) or near 10^10, f a double, s the string 'g' || g; and
    wdim(g, label). With `sqlite` the same rows in sqlite3's form: the
    decimals as text."""
    rng = np.random.default_rng(seed)

    def dec(v: int, s: int) -> str:
        sign = "-" if v < 0 else ""
        ip, fp = divmod(abs(v), 10**s)
        return f"{sign}{ip}.{fp:0{s}d}"

    out = []
    for k in range(rows):
        g = k % 5
        x = int(rng.integers(0, 1000))
        e = dec(12345678 + 101 * k, 2)
        p = (None if rng.random() < 0.1 else
             dec(38000123456 + int(rng.integers(-5 * 10**9, 5 * 10**9)), 6))
        d = dec(int(rng.integers(-999, 1000)) if k % 10 == 0
                else int(rng.integers(-10**12, 10**12)), 2)
        b = (None if rng.random() < 0.1 else
             (1 << 62) + int(rng.integers(0, 10**6)) if k % 4
             else -int(rng.integers(0, 10**9)))
        n = (None if rng.random() < 0.25 else
             dec(int(rng.integers(0, 9999)), 2) if k % 3 == 0
             else dec(int(rng.integers(10**11, 10**12 - 1)), 2))
        f = round(float(rng.uniform(-2e4, 2e4)), 3)
        out.append((k, g, x, e, p, d, b, n, f, f"g{g}"))

    def lit(v, j):
        if v is None:
            return "NULL"
        if j == 9 or (sqlite and j in (3, 4, 5, 7)):  # strings, text
            return f"'{v}'"
        return str(v)

    body = ", ".join(
        "(" + ", ".join(lit(v, j) for j, v in enumerate(r)) + ")"
        for r in out)
    dd = "TEXT" if sqlite else None
    cols = (f"k INT, g INT, x INT, e {dd or 'DECIMAL(12,2)'}, "
            f"p {dd or 'DECIMAL(12,6)'}, d {dd or 'DECIMAL(18,2)'}, b BIGINT, "
            f"n {dd or 'DECIMAL(12,2)'}, f DOUBLE, s VARCHAR(4)")
    dim = [f"({g}, 'l{g}')" for g in range(5)]
    return [f"CREATE TABLE wide({cols})", f"INSERT INTO wide VALUES {body}",
            "CREATE TABLE wdim(g INT, label VARCHAR(8))",
            f"INSERT INTO wdim VALUES {', '.join(dim)}"]


def exact_functions(conn) -> None:
    """Register the exact decimal functions the oracle forms call on a
    sqlite3 connection: NULL in, NULL out; values exchanged as text. dmod
    and ddiv give NULL for a divisor of 0 (the engine's rule); dcastf(x,
    digits, scale) is PostgreSQL's cast of a double (digits 15) or a real
    (digits 6) to a numeric of that scale."""
    import decimal

    ctx = decimal.Context(prec=200, rounding=decimal.ROUND_HALF_UP)

    def num(v):
        return None if v is None else decimal.Decimal(str(v))

    def fn(op):
        def call(*args):
            vals = [num(a) for a in args]
            if any(v is None for v in vals):
                return None
            return str(op(*vals))
        return call

    conn.create_function("dadd", 2, fn(lambda a, b: ctx.add(a, b)))
    conn.create_function("dsub", 2, fn(lambda a, b: ctx.subtract(a, b)))
    conn.create_function("dmul", 2, fn(lambda a, b: ctx.multiply(a, b)))
    conn.create_function("dround", 2, fn(
        lambda a, s: a.quantize(decimal.Decimal(1).scaleb(-int(s)), context=ctx)))
    conn.create_function("dgt", 2, lambda a, b: None if a is None or b is None
                         else int(num(a) > num(b)))

    class Sum:
        def __init__(self):
            self.total, self.n = decimal.Decimal(0), 0

        def step(self, v):
            if v is not None:
                self.total, self.n = ctx.add(self.total, num(v)), self.n + 1

        def finalize(self):
            return None if self.n == 0 else str(self.total)

    class Avg(Sum):
        def step(self, v, s):
            self.s = int(s)
            Sum.step(self, v)

        def finalize(self):
            if self.n == 0:
                return None
            q = ctx.divide(self.total, decimal.Decimal(self.n))
            return str(q.quantize(decimal.Decimal(1).scaleb(-self.s),
                                  context=ctx))

    conn.create_aggregate("dsum", 1, Sum)
    conn.create_aggregate("davg", 2, Avg)

    def dmod(a, b):  # the truncated remainder, the dividend's sign
        if a is None or b is None or num(b) == 0:
            return None
        return str(ctx.remainder(num(a), num(b)))

    def ddiv(a, b):
        if a is None or b is None or num(b) == 0:
            return None
        return str(ctx.divide(num(a), num(b)))

    def dcastf(x, digits, scale):
        # PostgreSQL's float8_numeric / float4_numeric: printf's "%.*g" at
        # DBL_DIG / FLT_DIG digits (a REAL's value is a float32), then the
        # typmod's scale, half away from zero
        if x is None:
            return None
        x = float(x)
        if int(digits) == 6:
            x = float(np.float32(x))
        d = decimal.Decimal(f"%.{int(digits)}g" % x)
        return str(d.quantize(decimal.Decimal(1).scaleb(-int(scale)),
                              context=ctx))

    conn.create_function("dmod", 2, dmod)
    conn.create_function("ddiv", 2, ddiv)
    conn.create_function("dcastf", 3, dcastf)


def exact_rows(res) -> list[list]:
    """A result's rows with its decimals as exact Decimals."""
    from decimal import Decimal

    from ..sql.types import K

    return [[None if v is None else
             Decimal(f"{int(v)}E-{t.s}") if t.kind == K.DECIMAL else v
             for v, t in zip(r, res.types)] for r in res.to_pylist()]


def exact_equal(got: list[list], want: list) -> tuple[bool, str]:
    """exact_rows against the oracle's rows: strings as strings, numbers as
    exact values, the oracle's exact decimal rounded half away from zero to
    the result's scale (the engine's decimal types keep at most 38
    digits)."""
    from decimal import ROUND_HALF_UP, Context, Decimal

    if len(got) != len(want):
        return False, f"{len(got)} rows against {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        if len(a) != len(b):
            return False, f"row {i}: {a} against {b}"
        for x, y in zip(a, b):
            if x is None or y is None:
                ok = x is None and y is None
            elif isinstance(x, str):
                ok = x == str(y)
            elif isinstance(x, Decimal):
                ok = x == Decimal(str(y)).quantize(
                    x, rounding=ROUND_HALF_UP, context=Context(prec=200))
            else:
                ok = Decimal(str(x)) == Decimal(str(y))
            if not ok:
                return False, f"row {i}: {a} against {b}"
    return True, ""


_P = "dsub(p, '38000.123456')"
_VAR = f"dmul({_P}, {_P})"
_E3 = "dmul(dmul(e, e), e)"
WIDE_STATEMENTS = {
    # C24: products and sums past int64
    "cube": ("SELECT k, e * e * e FROM wide ORDER BY k",
             f"SELECT k, {_E3} FROM wide ORDER BY k"),
    "sum_cube": ("SELECT sum(e * e * e) FROM wide",
                 f"SELECT dsum({_E3}) FROM wide"),
    "grouped_sum_cube": (
        "SELECT g, sum(e * e * e), count(*) FROM wide GROUP BY g ORDER BY g",
        f"SELECT g, dsum({_E3}), count(*) FROM wide GROUP BY g ORDER BY g"),
    "grouped_avg_cube": (
        "SELECT g, avg(e * e * e) FROM wide GROUP BY g ORDER BY g",
        f"SELECT g, davg({_E3}, 8) FROM wide GROUP BY g ORDER BY g"),
    "variance_by_hand": (
        "SELECT sum((p - 38000.123456) * (p - 38000.123456)) FROM wide",
        f"SELECT dsum({_VAR}) FROM wide"),
    "grouped_variance_by_hand": (
        "SELECT g, sum((p - 38000.123456) * (p - 38000.123456)), count(p) "
        "FROM wide WHERE k > 3 GROUP BY g ORDER BY g",
        f"SELECT g, dsum({_VAR}), count(p) FROM wide WHERE k > 3 GROUP BY g "
        "ORDER BY g"),
    "variance_rows": (
        "SELECT k, (p - 38000.123456) * (p - 38000.123456) FROM wide "
        "ORDER BY k", f"SELECT k, {_VAR} FROM wide ORDER BY k"),
    "d_cube": ("SELECT k, d * d * d FROM wide ORDER BY k",
               "SELECT k, dmul(dmul(d, d), d) FROM wide ORDER BY k"),
    "d_square_plus_d": ("SELECT k, d * d + d FROM wide ORDER BY k",
                        "SELECT k, dadd(dmul(d, d), d) FROM wide ORDER BY k"),
    "price_times_d": ("SELECT k, e * d FROM wide ORDER BY k",
                      "SELECT k, dmul(e, d) FROM wide ORDER BY k"),
    "cube_minus_d": ("SELECT k, e * e * e - d FROM wide ORDER BY k",
                     f"SELECT k, dsub({_E3}, d) FROM wide ORDER BY k"),
    "bigint_times_price": ("SELECT k, b * e FROM wide ORDER BY k",
                           "SELECT k, dmul(b, e) FROM wide ORDER BY k"),
    "cube_in_predicate": (
        "SELECT k FROM wide WHERE e * e * e > 1881800000000000 ORDER BY k",
        f"SELECT k FROM wide WHERE dgt({_E3}, '1881800000000000') ORDER BY k"),
    "cube_in_case": (
        "SELECT k, CASE WHEN g = 0 THEN e * e * e ELSE e END FROM wide "
        "ORDER BY k",
        f"SELECT k, CASE WHEN g = 0 THEN {_E3} ELSE e END FROM wide "
        "ORDER BY k"),
    "cube_of_nullable": (
        "SELECT k, coalesce(n * n * n, 0) FROM wide ORDER BY k",
        "SELECT k, coalesce(dmul(dmul(n, n), n), 0) FROM wide ORDER BY k"),
    "topk_epilogue_cube": (
        "SELECT g, sum(e) * sum(e) * sum(e) AS c FROM wide GROUP BY g "
        "ORDER BY g LIMIT 3",
        "SELECT g, dmul(dmul(dsum(e), dsum(e)), dsum(e)) AS c FROM wide "
        "GROUP BY g ORDER BY g LIMIT 3"),
    "chain_cube": (
        "SELECT wide.k, wdim.label FROM wide JOIN wdim ON wide.g = wdim.g "
        "WHERE wide.k > 3 AND wide.e * wide.e * wide.e > 1881800000000000 "
        "ORDER BY wide.k",
        "SELECT wide.k, wdim.label FROM wide JOIN wdim ON wide.g = wdim.g "
        f"WHERE wide.k > 3 AND dgt({_E3}, '1881800000000000') "
        "ORDER BY wide.k"),
    "charge_that_fits": (
        "SELECT g, sum(e * (1 - 0.05) * (1 + 0.08)) FROM wide GROUP BY g "
        "ORDER BY g",
        "SELECT g, dsum(dmul(dmul(e, '0.95'), '1.08')) FROM wide GROUP BY g "
        "ORDER BY g"),
    # rows the statement does not read (a conjunct that is FALSE, a NULL)
    # neither mark nor raise
    "filtered_rows_do_not_mark": (
        "SELECT k FROM wide WHERE n < 100 AND n * n * n >= 0 ORDER BY k",
        "SELECT k FROM wide WHERE CAST(n AS REAL) < 100 ORDER BY k"),
    "null_rows_do_not_mark": (
        "SELECT k, n * n * n FROM wide WHERE n IS NULL OR k % 3 = 0 "
        "ORDER BY k",
        "SELECT k, dmul(dmul(n, n), n) FROM wide WHERE n IS NULL OR k % 3 = 0 "
        "ORDER BY k"),
    # C25: sum and avg of a BIGINT are numerics
    "sum_bigint": ("SELECT sum(b) FROM wide", "SELECT dsum(b) FROM wide"),
    "avg_bigint": ("SELECT avg(b) FROM wide", "SELECT davg(b, 19) FROM wide"),
    "grouped_sum_avg_bigint": (
        "SELECT g, sum(b), avg(b), count(b) FROM wide GROUP BY g ORDER BY g",
        "SELECT g, dsum(b), davg(b, 19), count(b) FROM wide GROUP BY g "
        "ORDER BY g"),
    "grouped_sum_bigint_filtered": (
        "SELECT g, sum(b) FROM wide WHERE k > 10 GROUP BY g ORDER BY g",
        "SELECT g, dsum(b) FROM wide WHERE k > 10 GROUP BY g ORDER BY g"),
    "running_sum_bigint": (
        "SELECT k, sum(b) OVER (ORDER BY k) FROM wide ORDER BY k",
        "SELECT k, (SELECT dsum(b) FROM wide w2 WHERE w2.k <= wide.k) "
        "FROM wide ORDER BY k"),
    "partition_sum_bigint": (
        "SELECT k, sum(b) OVER (PARTITION BY g) FROM wide ORDER BY k",
        "SELECT k, (SELECT dsum(b) FROM wide w2 WHERE w2.g = wide.g) "
        "FROM wide ORDER BY k"),
    "frame_sum_bigint": (
        "SELECT k, sum(b) OVER (ORDER BY k ROWS BETWEEN 2 PRECEDING AND "
        "CURRENT ROW) FROM wide ORDER BY k",
        "SELECT k, (SELECT dsum(b) FROM wide w2 WHERE w2.k BETWEEN "
        "wide.k - 2 AND wide.k) FROM wide ORDER BY k"),
    "sum_distinct_bigint": ("SELECT sum(DISTINCT b) FROM wide",
                            "SELECT dsum(DISTINCT b) FROM wide"),
    "grouped_sum_distinct_bigint": (
        "SELECT g, sum(DISTINCT b) FROM wide GROUP BY g ORDER BY g",
        "SELECT g, dsum(DISTINCT b) FROM wide GROUP BY g ORDER BY g"),
    "having_sum_bigint": (
        "SELECT g FROM wide GROUP BY g HAVING sum(b) > 9223372036854775807 "
        "ORDER BY g",
        "SELECT g FROM wide GROUP BY g HAVING dgt(dsum(b), "
        "'9223372036854775807') ORDER BY g"),
    "sum_bigint_of_negatives": ("SELECT sum(b) FROM wide WHERE b < 0",
                                "SELECT dsum(b) FROM wide WHERE b < 0"),
    "sum_int_stays_bigint": ("SELECT sum(x) FROM wide",
                             "SELECT sum(x) FROM wide"),
    # C26: a cast past the precision raises
    "cast_literal_past_precision": (
        "SELECT CAST(12345.678 AS DECIMAL(5,2))",
        Raises("numeric field overflow")),
    "cast_literal_rounds_past_precision": (
        "SELECT CAST(999.995 AS DECIMAL(5,2))",
        Raises("numeric field overflow")),
    "cast_literal_rounds_within": ("SELECT CAST(999.994 AS DECIMAL(5,2))",
                                   "SELECT '999.99'"),
    "cast_string_past_precision": (
        "SELECT CAST('123456.7' AS DECIMAL(5,1))",
        Raises("numeric field overflow")),
    "cast_column_past_precision": (
        "SELECT k, CAST(d AS DECIMAL(4,2)) FROM wide ORDER BY k",
        Raises("numeric field overflow")),
    "cast_price_narrower": ("SELECT k, CAST(e AS DECIMAL(7,2)) FROM wide",
                            Raises("numeric field overflow")),
    "cast_price_that_fits": (
        "SELECT k, CAST(e AS DECIMAL(8,1)) FROM wide ORDER BY k",
        "SELECT k, dround(e, 1) FROM wide ORDER BY k"),
    "cast_int_past_precision": ("SELECT k, CAST(x AS DECIMAL(3,1)) FROM wide",
                                Raises("numeric field overflow")),
    "cast_double_past_precision": (
        "SELECT k, CAST(f AS DECIMAL(6,2)) FROM wide",
        Raises("numeric field overflow")),
    "cast_filtered_rows_fit": (
        "SELECT k, CAST(d AS DECIMAL(4,2)) FROM wide WHERE k % 10 = 0 "
        "ORDER BY k",
        "SELECT k, d FROM wide WHERE k % 10 = 0 ORDER BY k"),
    "cast_null_rows_fit": (
        "SELECT k, CAST(n AS DECIMAL(6,2)) FROM wide WHERE n IS NULL "
        "OR k % 3 = 0 ORDER BY k",
        "SELECT k, n FROM wide WHERE n IS NULL OR k % 3 = 0 ORDER BY k"),
    "cast_bigint_to_wide": (
        "SELECT k, CAST(b AS DECIMAL(38,10)) FROM wide ORDER BY k",
        "SELECT k, b FROM wide ORDER BY k"),
    "cast_price_to_wide_scale": (
        "SELECT k, CAST(e AS DECIMAL(30,18)) FROM wide ORDER BY k",
        "SELECT k, e FROM wide ORDER BY k"),
}
# the C24 statements, also held against the JAX package's host tier (exact
# there: its device tier wraps)
WIDE_JAX_EXACT = ("cube", "sum_cube", "grouped_sum_cube", "variance_by_hand",
                  "grouped_variance_by_hand", "variance_rows", "d_cube",
                  "d_square_plus_d", "price_times_d", "cube_minus_d",
                  "bigint_times_price", "cube_in_predicate", "cube_in_case",
                  "cube_of_nullable", "topk_epilogue_cube", "chain_cube",
                  "charge_that_fits")
# statements whose live rows all fit: they run once, never again exactly
WIDE_NO_RERUN = ("charge_that_fits", "filtered_rows_do_not_mark",
                 "cast_price_that_fits", "cast_filtered_rows_fit",
                 "cast_null_rows_fit", "sum_int_stays_bigint")


# ------------------------------------------------------------------ C27, C29
# DECIMAL % that wrapped in int64 on both tiers (C27: the operands rescaled
# to the result's scale with no check), and casts from DOUBLE and REAL to
# DECIMAL that rounded the binary value where PostgreSQL rounds its 15 (a
# REAL's 6) significant digits first (C29). The JAX package shares both
# faults: the oracle is sqlite3 over the same rows with its decimals held as
# text (exact_functions: dmod, ddiv, dcastf, dsum, dgt), or Raises(words).
def mod_cast_setup(rows: int = 160, seed: int = 20261020,
                   sqlite: bool = False) -> list[str]:
    """mc(k, g, a, b, c, e, d, i, f, r, h, s) of `rows` rows made from `seed`:
    a DECIMAL(18,0) up to 10^18, b a DECIMAL(18,10), c a DECIMAL(12,2) up to
    10^10, e a DECIMAL(4,2), d a DECIMAL(18,2), i a BIGINT near +-9 * 10^18
    on half the rows, f a DOUBLE price of three decimals, r a REAL, h a
    DOUBLE up to 9.3 * 10^18; b, c, e are 0 on some rows and every column
    but k, g and s is NULL on some; s is 'g' || g. The first rows hold the
    edges (123456789012 % 1.5, 0.285, 1.005, 2.675, 99.995, 2^53 + 1, 9.2 *
    10^18 ...). And
    mdim(g, label). With `sqlite` the same rows in sqlite3's form: the
    decimals as text."""
    rng = np.random.default_rng(seed)

    def dec(v: int, s: int) -> str:
        sign = "-" if v < 0 else ""
        ip, fp = divmod(abs(v), 10**s)
        return f"{sign}{ip}.{fp:0{s}d}" if s else f"{sign}{ip}"

    edges = [  # a, b, c, e, i, f, r, h
        (123456789012, 15 * 10**9, 12345678, 1, 9 * 10**18, "0.285", "2.675",
         "9.2e18"),
        (-987654321, 225 * 10**8, 999999999999, 1, -9 * 10**18, "1.005",
         "0.285", "-9.2e18"),
        (999999999999999999, 7 * 10**7, -999999999999, -1, 7, "2.675",
         "1.005", "9.3e18"),
        (5, 0, 0, 0, 0, "99.995", "99.995", "9007199254740993.0"),
        (None, 1, 100, 9999, None, "-0.125", "-0.125", "9007199254740991.0"),
        (-5, -15 * 10**9, None, None, -7, "0.004999999999999999", "0.005",
         "1000000000000000.5"),
        (10**17, 3, 1, -9999, 123456789, "0.005", None, "-0.0"),
        (-10**17, -10**10, -1, 7, -(1 << 62), "-0.0", "0.0", None),
    ]
    out = []
    for k in range(rows):
        if k < len(edges):
            a, b, c, e, i, f, r, h = edges[k]
        else:
            def maybe(v, p=0.1):
                return None if rng.random() < p else v

            a = maybe(int(rng.integers(-10**17, 10**17)) if k % 3
                      else int(rng.integers(-10**12, 10**12)))
            b = maybe(0 if k % 17 == 0 else int(rng.integers(-10**14, 10**14)))
            c = maybe(0 if k % 13 == 0 else int(rng.integers(-10**11, 10**11)))
            e = maybe(0 if k % 11 == 0 else int(rng.integers(-9999, 10000)))
            i = maybe(int(rng.integers(-9 * 10**18, 9 * 10**18)) if k % 2
                      else int(rng.integers(-10**6, 10**6)))
            f = maybe(repr(round(float(rng.uniform(-1e5, 1e5)), 3)))
            r = maybe(repr(round(float(rng.uniform(-1e3, 1e3)), 3)))
            h = maybe(repr(float(rng.uniform(-1, 1))
                           * 10.0 ** int(rng.integers(0, 19))))
        d = None if k % 9 == 4 else int(rng.integers(-10**17, 10**17))
        out.append((k, k % 4, None if a is None else dec(a, 0),
                    None if b is None else dec(b, 10),
                    None if c is None else dec(c, 2),
                    None if e is None else dec(e, 2),
                    None if d is None else dec(d, 2), i, f, r, h,
                    f"g{k % 4}"))

    def lit(v, j):
        if v is None:
            return "NULL"
        if j == 11 or (sqlite and 2 <= j <= 6):  # strings, text
            return f"'{v}'"
        return str(v)

    body = ", ".join(
        "(" + ", ".join(lit(v, j) for j, v in enumerate(row)) + ")"
        for row in out)
    dd = "TEXT" if sqlite else None
    cols = (f"k INT, g INT, a {dd or 'DECIMAL(18,0)'}, "
            f"b {dd or 'DECIMAL(18,10)'}, c {dd or 'DECIMAL(12,2)'}, "
            f"e {dd or 'DECIMAL(4,2)'}, d {dd or 'DECIMAL(18,2)'}, i BIGINT, "
            "f DOUBLE, r REAL, h DOUBLE, s VARCHAR(4)")
    dim = [f"({g}, 'l{g}')" for g in range(4)]
    return [f"CREATE TABLE mc({cols})", f"INSERT INTO mc VALUES {body}",
            "CREATE TABLE mdim(g INT, label VARCHAR(8))",
            f"INSERT INTO mdim VALUES {', '.join(dim)}"]


def _mc(expr: str, where: str = "") -> str:
    return f"SELECT k, {expr} FROM mc {where}ORDER BY k"


def _cf(col: str, scale: int) -> str:  # the oracle's cast of f, h or r
    return f"dcastf({col}, {6 if col.endswith('r') else 15}, {scale})"


# over mod_cast_setup()'s tables. A tuple statement runs its first entries
# as statements and its last as the query, {t} a fresh table's name; the
# second entry is sqlite3's form, or Raises(PostgreSQL's words)
MOD_CAST_STATEMENTS = {
    # C27: % rescales both operands to the result's scale
    "a_mod_b": (_mc("a % b"), _mc("dmod(a, b)")),
    "bigint_mod_literal": (_mc("i % 1.5"), _mc("dmod(i, '1.5')")),
    "bigint_mod_price": (_mc("i % c"), _mc("dmod(i, c)")),
    "price_mod_bigint": (_mc("c % i"), _mc("dmod(c, i)")),
    "decimal_mod_int": (_mc("b % g"), _mc("dmod(b, g)")),
    "a_mod_small_literal": (_mc("a % 0.0007"), _mc("dmod(a, '0.0007')")),
    "sum_a_mod_b": ("SELECT sum(a % b) FROM mc",
                    "SELECT dsum(dmod(a, b)) FROM mc"),
    "literal_mod_literal": (
        "SELECT CAST(999999999999999999 AS DECIMAL(18,0)) % "
        "CAST(0.007 AS DECIMAL(18,3))", "SELECT '0.000'"),
    "d_mod_007_fits": (_mc("d % 0.07"), _mc("dmod(d, '0.07')")),
    "grouped_sum_mod": (
        "SELECT g, sum(a % b), count(*) FROM mc GROUP BY g ORDER BY g",
        "SELECT g, dsum(dmod(a, b)), count(*) FROM mc GROUP BY g ORDER BY g"),
    "grouped_min_max_mod": (
        "SELECT g, min(i % c), max(i % c) FROM mc GROUP BY g ORDER BY g",
        "SELECT g, min(CAST(dmod(i, c) AS REAL)), max(CAST(dmod(i, c) AS "
        "REAL)) FROM mc GROUP BY g ORDER BY g"),
    "chain_mod": (
        "SELECT mc.k, mdim.label FROM mc JOIN mdim ON mc.g = mdim.g "
        "WHERE mc.k > 3 AND mc.a % mc.b > 0 ORDER BY mc.k",
        "SELECT mc.k, mdim.label FROM mc JOIN mdim ON mc.g = mdim.g "
        "WHERE mc.k > 3 AND dgt(dmod(mc.a, mc.b), '0') ORDER BY mc.k"),
    "topk_epilogue_mod": (
        "SELECT g, sum(a) % sum(b) AS r FROM mc GROUP BY g ORDER BY g LIMIT 3",
        "SELECT g, dmod(dsum(a), dsum(b)) AS r FROM mc GROUP BY g "
        "ORDER BY g LIMIT 3"),
    "mod_in_predicate": (
        "SELECT k FROM mc WHERE i % c > 1000 ORDER BY k",
        "SELECT k FROM mc WHERE dgt(dmod(i, c), '1000') ORDER BY k"),
    "mod_in_case": (_mc("CASE WHEN g = 0 THEN a % b ELSE c END"),
                    _mc("CASE WHEN g = 0 THEN dmod(a, b) ELSE c END")),
    "zero_divisors_are_null": (
        _mc("a % b, i % c", "WHERE b = 0 OR c = 0 OR b IS NULL "),
        _mc("dmod(a, b), dmod(i, c)", "WHERE CAST(b AS REAL) = 0 OR "
            "CAST(c AS REAL) = 0 OR b IS NULL ")),
    # C29: a double (a real) to 15 (6) digits, then to the scale
    "cast_double_2": (_mc("CAST(f AS DECIMAL(12,2))"), _mc(_cf("f", 2))),
    "cast_double_0": (_mc("CAST(f AS DECIMAL(18,0))"), _mc(_cf("f", 0))),
    "cast_double_6": (_mc("CAST(f AS DECIMAL(18,6))"), _mc(_cf("f", 6))),
    "cast_real_2": (_mc("CAST(r AS DECIMAL(12,2))"), _mc(_cf("r", 2))),
    "cast_real_4": (_mc("CAST(r AS DECIMAL(12,4))"), _mc(_cf("r", 4))),
    "cast_big_double_exact": (_mc("CAST(h AS DECIMAL(19,0))"),
                              _mc(_cf("h", 0))),
    "cast_big_double_scale_2": (_mc("CAST(h AS DECIMAL(38,2))"),
                                _mc(_cf("h", 2))),
    "cast_literal_double": (
        "SELECT CAST(CAST(0.285 AS DOUBLE) AS DECIMAL(12,2)), "
        "CAST(CAST(1.005 AS DOUBLE) AS DECIMAL(12,2)), "
        "CAST(CAST(2.675 AS REAL) AS DECIMAL(12,2))",
        "SELECT '0.29', '1.01', '2.68'"),
    "cast_literal_past_precision": (
        "SELECT CAST(CAST(99.995 AS DOUBLE) AS DECIMAL(4,2))",
        Raises("numeric field overflow")),
    "cast_column_past_precision": (_mc("CAST(f AS DECIMAL(6,2))"),
                                   Raises("numeric field overflow")),
    "cast_filtered_rows_fit": (
        _mc("CAST(f AS DECIMAL(6,2))", "WHERE abs(f) < 1000 "),
        _mc(_cf("f", 2), "WHERE abs(f) < 1000 ")),
    "cast_null_rows_fit": (
        _mc("CAST(r AS DECIMAL(5,2))", "WHERE r IS NULL OR abs(r) < 100 "),
        _mc(_cf("r", 2), "WHERE r IS NULL OR abs(r) < 100 ")),
    "grouped_sum_cast_double": (
        "SELECT g, sum(CAST(f AS DECIMAL(15,2))) FROM mc GROUP BY g "
        "ORDER BY g",
        f"SELECT g, dsum({_cf('f', 2)}) FROM mc GROUP BY g ORDER BY g"),
    "grouped_sum_cast_real": (
        "SELECT g, sum(CAST(r AS DECIMAL(15,2))) FROM mc GROUP BY g "
        "ORDER BY g",
        f"SELECT g, dsum({_cf('r', 2)}) FROM mc GROUP BY g ORDER BY g"),
    "chain_cast": (
        "SELECT mc.k, mdim.label FROM mc JOIN mdim ON mc.g = mdim.g "
        "WHERE mc.k > 3 AND CAST(mc.f AS DECIMAL(12,2)) > 1.0 ORDER BY mc.k",
        "SELECT mc.k, mdim.label FROM mc JOIN mdim ON mc.g = mdim.g "
        f"WHERE mc.k > 3 AND dgt({_cf('mc.f', 2)}, '1.0') ORDER BY mc.k"),
    "topk_epilogue_cast": (
        "SELECT g, CAST(max(f) AS DECIMAL(12,2)) AS m FROM mc GROUP BY g "
        "ORDER BY g LIMIT 3",
        f"SELECT g, {_cf('max(f)', 2)} AS m FROM mc GROUP BY g "
        "ORDER BY g LIMIT 3"),
    "insert_select_casts": (
        ("CREATE TABLE {t}(k INT, v DECIMAL(10,2))",
         "INSERT INTO {t} SELECT k, f FROM mc WHERE f IS NOT NULL",
         "SELECT k, v FROM {t} ORDER BY k"),
        _mc(_cf("f", 2), "WHERE f IS NOT NULL ")),
    "insert_values_casts": (
        ("CREATE TABLE {t}(k INT, v DECIMAL(10,2))",
         "INSERT INTO {t} VALUES (1, CAST(0.285 AS DOUBLE)), "
         "(3, CAST(-1.005 AS DOUBLE))",
         # (alone: beside a double, VALUES would make the real a double)
         "INSERT INTO {t} VALUES (2, CAST(2.675 AS REAL))",
         "SELECT k, v FROM {t} ORDER BY k"),
        "SELECT 1, '0.29' UNION ALL SELECT 2, '2.68' UNION ALL "
        "SELECT 3, '-1.01'"),
    "insert_past_precision": (
        ("CREATE TABLE {t}(k INT, v DECIMAL(4,2))",
         "INSERT INTO {t} VALUES (1, CAST(99.995 AS DOUBLE))",
         "SELECT k, v FROM {t} ORDER BY k"),
        Raises("numeric field overflow")),
    # division at the edges of quotient types int64 holds (DECIMAL(18,6),
    # DECIMAL(18,14)): the int64 path is exact there; a wide quotient type
    # goes exact
    "div_price_by_cent": (_mc("c / e"), _mc("ddiv(c, e)")),
    "div_price_by_literal": (_mc("c / 0.07"), _mc("ddiv(c, '0.07')")),
    "div_cent_by_price": (_mc("e / c"), _mc("ddiv(e, c)")),
    "div_bigint_wide": (_mc("i / 1.5"), _mc("ddiv(i, '1.5')")),
    "grouped_sum_div": (  # each quotient rounded to its scale, 6
        "SELECT g, sum(c / e) FROM mc GROUP BY g ORDER BY g",
        "SELECT g, dsum(dround(ddiv(c, e), 6)) FROM mc GROUP BY g "
        "ORDER BY g"),
    "div_by_zero_is_null": (
        _mc("c / e, e / c", "WHERE e = 0 OR c = 0 "),
        _mc("ddiv(c, e), ddiv(e, c)",
            "WHERE CAST(e AS REAL) = 0 OR CAST(c AS REAL) = 0 ")),
}
# statements whose operands the bounds prove: no check is built
MOD_CAST_UNCHECKED = ("d_mod_007_fits",)
