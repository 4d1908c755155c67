"""SQL lexer.

Frontend replacement for the reference's flex lexer
(reference: src/compiler/frontend/lexer.l, 428 LoC). Produces a token stream
for the recursive-descent parser.
"""

from __future__ import annotations

from dataclasses import dataclass

KEYWORDS = {
    # statement heads
    "select", "insert", "update", "delete", "create", "drop", "copy", "set",
    "with", "values", "table", "view", "index", "function", "returns",
    "language",
    # clauses
    "from", "where", "group", "by", "having", "order", "limit", "offset",
    "union", "intersect", "except", "all", "distinct", "as", "on", "using",
    "join", "inner", "left", "right", "full", "outer", "cross", "natural",
    "asc", "desc", "nulls", "first", "last", "recursive",
    # predicates / operators
    "and", "or", "not", "in", "like", "ilike", "between", "is", "null",
    "exists", "any", "some", "case", "when", "then", "else", "end",
    "cast", "extract", "substring", "for", "true", "false", "similar", "to",
    # types
    "integer", "int", "smallint", "bigint", "float", "real", "double",
    "precision", "decimal", "numeric", "varchar", "char", "character",
    "varying", "text", "string", "bool", "boolean", "date", "timestamp",
    "interval", "day", "days", "month", "months", "year", "years", "hour",
    "minute", "second", "time",
    # misc
    "primary", "key", "foreign", "references", "unique", "default", "check",
    "explain", "verbose", "analyze",
    "constraint", "if", "replace", "into", "returning",
}


@dataclass
class Token:
    kind: str  # 'kw', 'ident', 'int', 'float', 'string', 'op', 'param', 'eof'
    value: str
    pos: int


class LexError(Exception):
    pass


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":  # string literal, '' escapes
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':  # quoted identifier
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated identifier at {i}")
            toks.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c == "$" and sql.startswith("$$", i):  # dollar-quoted body (UDFs)
            j = sql.find("$$", i + 2)
            if j < 0:
                raise LexError(f"unterminated $$ at {i}")
            toks.append(Token("string", sql[i + 2:j], i))
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            isfloat = False
            while j < n and (sql[j].isdigit() or sql[j] == "."):
                if sql[j] == ".":
                    isfloat = True
                j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    isfloat = True
                    j = k
                    while j < n and sql[j].isdigit():
                        j += 1
            toks.append(Token("float" if isfloat else "int", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            lw = word.lower()
            if lw in KEYWORDS:
                toks.append(Token("kw", lw, i))
            else:
                toks.append(Token("ident", lw, i))
            i = j
            continue
        # operators (longest-match)
        for op in ("<=", ">=", "<>", "!=", "||", "::", "|>"):
            if sql.startswith(op, i):
                toks.append(Token("op", op, i))
                i += len(op)
                break
        else:
            if c in "+-*/%(),.;=<>[]?:":
                toks.append(Token("op", c, i))
                i += 1
            else:
                raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks
