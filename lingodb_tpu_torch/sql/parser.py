"""SQL parser: recursive descent with Pratt-style expression parsing.

Frontend replacement for the reference's bison grammar
(reference: src/compiler/frontend/parser.y, 3727 LoC). Covers the statement
surface exercised by the reference's test suites: SELECT (CTEs, set ops,
joins, subqueries, window functions, VALUES), CREATE TABLE, CREATE FUNCTION,
INSERT, COPY, SET, DROP TABLE.
"""

from __future__ import annotations

from . import ast as A
from .lexer import Token, tokenize
from .types import IntervalUnit, Type


class ParseError(Exception):
    pass


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # ---- token helpers ------------------------------------------------------
    def peek(self, ahead=0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def at_op(self, *ops) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def accept_kw(self, *kws) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def accept_op(self, *ops) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw):
        if not self.accept_kw(kw):
            raise ParseError(f"expected {kw.upper()} but got {self.peek().value!r} at {self.peek().pos}")

    def expect_op(self, op):
        if not self.accept_op(op):
            raise ParseError(f"expected {op!r} but got {self.peek().value!r} at {self.peek().pos}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            self.next()
            return t.value
        # allow non-reserved keywords as identifiers in common positions
        if t.kind == "kw" and t.value in _SOFT_KEYWORDS:
            self.next()
            return t.value
        raise ParseError(f"expected identifier, got {t.value!r} at {t.pos}")

    def ident_any(self) -> str:
        """Identifier position where any keyword is allowed (e.g. after AS)."""
        t = self.peek()
        if t.kind in ("ident", "kw"):
            self.next()
            return t.value
        raise ParseError(f"expected identifier, got {t.value!r} at {t.pos}")

    # ---- entry --------------------------------------------------------------
    def parse_statements(self) -> list:
        stmts = []
        while self.peek().kind != "eof":
            if self.accept_op(";"):
                continue
            stmts.append(self.parse_statement())
            self.accept_op(";")
        return stmts

    def parse_statement(self):
        t = self.peek()
        if t.kind == "kw":
            if t.value in ("select", "with", "values") or self.at_op("("):
                return self.parse_select()
            if t.value == "create":
                return self.parse_create()
            if t.value == "insert":
                return self.parse_insert()
            if t.value == "copy":
                return self.parse_copy()
            if t.value == "set":
                return self.parse_set()
            if t.value == "drop":
                return self.parse_drop()
            if t.value == "from":
                return self.parse_pipe_sql()
            if t.value == "explain":
                self.next()
                verbose = bool(self.accept_kw("verbose"))
                analyze = bool(self.accept_kw("analyze"))
                return A.ExplainStmt(self.parse_statement(), verbose, analyze)
        if t.kind == "op" and t.value == "(":
            return self.parse_select()
        raise ParseError(f"unsupported statement start {t.value!r} at {t.pos}")

    # ---- pipe-syntax SQL -------------------------------------------------------
    # reference: PipeOperatorType handling in sql_analyzer.cpp:186-300 —
    # FROM t |> WHERE ... |> JOIN ... |> AGGREGATE ... GROUP BY ... |> SELECT
    # ... |> EXTEND ... |> ORDER BY ... |> LIMIT n. Desugared into nested
    # SelectStmt nodes here.
    def parse_pipe_sql(self) -> A.SelectStmt:
        self.expect_kw("from")
        stmt = A.SelectStmt(items=[A.SelectItem(A.Star(), None)])
        stmt.from_refs = [self.parse_table_ref()]
        while self.accept_op(","):
            stmt.from_refs.append(self.parse_table_ref())
        return self._parse_pipe_ops(stmt)

    def _parse_pipe_ops(self, stmt: A.SelectStmt) -> A.SelectStmt:

        def is_pristine():
            return (
                len(stmt.items) == 1
                and isinstance(stmt.items[0].expr, A.Star)
                and stmt.items[0].expr.table is None
                and not stmt.group_by
                and not stmt.order_by
                and stmt.limit is None
            )

        def wrap():
            nonlocal stmt
            inner = stmt
            stmt = A.SelectStmt(items=[A.SelectItem(A.Star(), None)])
            stmt.from_refs = [A.SubqueryRef(inner, alias=f"__pipe{id(inner) % 9973}")]

        while self.at_op("|>"):
            self.next()
            t = self.peek()
            kw = t.value if t.kind in ("kw", "ident") else None
            if kw == "where":
                self.next()
                cond = self.parse_expr()
                if stmt.group_by or not is_pristine() and stmt.items[0].alias is not None:
                    wrap()
                if stmt.group_by:
                    wrap()
                stmt.where = cond if stmt.where is None else A.BinaryOp("and", stmt.where, cond)
            elif kw == "select":
                self.next()
                if not is_pristine():
                    wrap()
                stmt.items = []
                while True:
                    stmt.items.append(self.parse_select_item())
                    if not self.accept_op(","):
                        break
            elif kw == "extend":
                # EXTEND appends computed columns; prior pipe SELECT items
                # stay visible (they are plain projections, so appending to
                # the same SELECT preserves semantics and name scoping)
                self.next()
                while True:
                    stmt.items.append(self.parse_select_item())
                    if not self.accept_op(","):
                        break
            elif kw == "aggregate":
                self.next()
                if not is_pristine():
                    wrap()
                aggs = []
                while True:
                    aggs.append(self.parse_select_item())
                    if not self.accept_op(","):
                        break
                group_items = []
                if self.accept_kw("group"):
                    self.expect_kw("by")
                    while True:
                        group_items.append(self.parse_expr())
                        if not self.accept_op(","):
                            break
                stmt.items = [A.SelectItem(g, None) for g in group_items] + aggs
                stmt.group_by = group_items
            elif kw in ("join", "inner", "left", "right", "full", "cross"):
                if not is_pristine() or stmt.where is not None or stmt.group_by:
                    wrap()
                kind = "inner"
                if kw != "join":
                    kind = kw
                    self.next()
                    self.accept_kw("outer")
                self.expect_kw("join")
                right = self.parse_table_primary()
                cond = None
                using = []
                if self.accept_kw("on"):
                    cond = self.parse_expr()
                elif self.accept_kw("using"):
                    self.expect_op("(")
                    while True:
                        using.append(self.ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                stmt.from_refs = [
                    A.JoinRef(kind, stmt.from_refs[0] if len(stmt.from_refs) == 1 else
                              _fold_cross(stmt.from_refs), right, cond, using)
                ]
            elif kw == "order":
                self.next()
                self.expect_kw("by")
                while True:
                    e = self.parse_expr()
                    item = A.OrderItem(e)
                    if self.accept_kw("desc"):
                        item.ascending = False
                    else:
                        self.accept_kw("asc")
                    if self.accept_kw("nulls"):
                        item.nulls_first = self.next().value == "first"
                    stmt.order_by.append(item)
                    if not self.accept_op(","):
                        break
            elif kw == "limit":
                self.next()
                stmt.limit = self.parse_expr()
                if self.accept_kw("offset"):
                    stmt.offset = self.parse_expr()
            elif kw in ("union", "intersect", "except"):
                op = kw
                self.next()
                if op == "union" and self.accept_kw("all"):
                    op = "union_all"
                else:
                    self.accept_kw("distinct")
                right = self.parse_select_core()
                stmt = A.SelectStmt(set_op=op, left=stmt, right=right)
            else:
                raise ParseError(f"unsupported pipe operator {kw!r} at {t.pos}")
        return stmt

    # ---- DDL / DML ------------------------------------------------------------
    def parse_create(self):
        self.expect_kw("create")
        if self.accept_kw("or"):
            self.expect_kw("replace")
        if self.accept_kw("view"):
            return self.parse_create_view()
        if self.accept_kw("table"):
            name = self.ident()
            self.expect_op("(")
            cols: list[A.ColumnDef] = []
            pk: list[str] = []
            while True:
                if self.at_kw("primary"):
                    self.next()
                    self.expect_kw("key")
                    self.expect_op("(")
                    while True:
                        pk.append(self.ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                elif self.at_kw("unique", "check", "foreign", "constraint"):
                    # consume constraint to matching level (ignored)
                    self._skip_constraint()
                else:
                    cname = self.ident_any()
                    ctype = self.parse_type()
                    cd = A.ColumnDef(cname, ctype)
                    while True:
                        if self.accept_kw("not"):
                            self.expect_kw("null")
                            cd.not_null = True
                        elif self.accept_kw("primary"):
                            self.expect_kw("key")
                            cd.primary_key = True
                            cd.not_null = True
                        elif self.accept_kw("null"):
                            pass
                        elif self.accept_kw("unique"):
                            pass
                        elif self.accept_kw("default"):
                            self.parse_expr()
                        else:
                            break
                    cols.append(cd)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            for c in cols:
                if c.primary_key:
                    pk.append(c.name)
            return A.CreateTableStmt(name, cols, pk)
        if self.accept_kw("index"):
            # CREATE INDEX name ON table(col, ...) — hash index
            # (reference: CREATE INDEX via RelationHelper / IndexCatalogEntry)
            iname = self.ident()
            self.expect_kw("on")
            tname = self.ident()
            icols: list[str] = []
            self.expect_op("(")
            while True:
                icols.append(self.ident_any())
                # per-column order is irrelevant to a hash index: accept+drop
                if self.accept_kw("asc") or self.accept_kw("desc"):
                    if self.accept_kw("nulls"):
                        self.next()
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return A.CreateIndexStmt(iname, tname, icols)
        if self.accept_kw("function"):
            return self.parse_create_function()
        raise ParseError(f"unsupported CREATE at {self.peek().pos}")

    def _skip_constraint(self):
        depth = 0
        while self.peek().kind != "eof":
            if self.at_op("("):
                depth += 1
            elif self.at_op(")"):
                if depth == 0:
                    return
                depth -= 1
            elif self.at_op(",") and depth == 0:
                return
            self.next()

    def parse_create_view(self):
        name = self.ident()
        self.expect_kw("as")
        q = self.parse_select()
        return A.CreateViewStmt(name, q)

    def parse_create_function(self):
        name = self.ident()
        self.expect_op("(")
        arg_names, arg_types = [], []
        if not self.at_op(")"):
            while True:
                an = self.ident()
                at = self.parse_type()
                arg_names.append(an)
                arg_types.append(at)
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        self.expect_kw("returns")
        ret = self.parse_type()
        lang = "sql"
        body = ""
        while self.peek().kind != "eof" and not self.at_op(";"):
            if self.accept_kw("language"):
                lang = self.ident()
            elif self.peek().kind == "string":
                body = self.next().value
            elif self.accept_kw("as"):
                continue
            else:
                self.next()
        return A.CreateFunctionStmt(name, arg_names, arg_types, ret, lang.lower(), body)

    def parse_insert(self):
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        columns = []
        if self.at_op("(") :
            self.expect_op("(")
            while True:
                columns.append(self.ident_any())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        query = self.parse_select()
        return A.InsertStmt(table, columns, query)

    def parse_copy(self):
        self.expect_kw("copy")
        table = self.ident()
        self.expect_kw("from")
        path = self.next().value
        options = {}
        # postgres-style: WITH/(...) options or bare CSV options
        while self.peek().kind != "eof" and not self.at_op(";"):
            t = self.next()
            v = t.value
            if v == "(":
                continue
            if v in (")",):
                continue
            key = v.lower()
            if key in ("delimiter", "escape", "quote", "null"):
                val = self.next().value
                options[key] = val
            elif key == "csv" or key == "format":
                options["format"] = "csv"
            elif key == "header":
                options["header"] = True
        return A.CopyStmt(table, path, options)

    def parse_set(self):
        self.expect_kw("set")
        key = self.ident()
        while self.at_op("."):
            self.next()
            key += "." + self.ident()
        self.accept_op("=")
        self.accept_kw("to")
        t = self.next()
        return A.SetStmt(key, t.value)

    def parse_drop(self):
        self.expect_kw("drop")
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.ident()  # exists
            if_exists = True
        return A.DropTableStmt(self.ident(), if_exists)

    # ---- SELECT ---------------------------------------------------------------
    def parse_select(self) -> A.SelectStmt:
        if self.at_kw("from"):  # pipe-syntax subquery/statement
            return self.parse_pipe_sql()
        ctes: list[A.CTE] = []
        if self.accept_kw("with"):
            recursive = self.accept_kw("recursive")
            while True:
                name = self.ident()
                col_aliases = []
                if self.at_op("("):
                    self.next()
                    while True:
                        col_aliases.append(self.ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                q = self.parse_select()
                self.expect_op(")")
                ctes.append(A.CTE(name, q, col_aliases, recursive))
                if not self.accept_op(","):
                    break
        stmt = self.parse_set_expr()
        stmt.ctes = ctes + stmt.ctes
        if self.at_op("|>"):  # pipe operators may chain onto a regular SELECT
            stmt = self._parse_pipe_ops(stmt)
        return stmt

    def parse_set_expr(self) -> A.SelectStmt:
        left = self.parse_select_core(modifiers=False)
        while self.at_kw("union", "intersect", "except"):
            op = self.next().value
            if self.accept_kw("all"):
                op = op + "_all"
            else:
                self.accept_kw("distinct")
            right = self.parse_select_core(modifiers=False)
            node = A.SelectStmt(set_op=op, left=left, right=right)
            left = node
        # trailing ORDER BY / LIMIT / OFFSET apply to the whole set
        # expression; an unparenthesized branch takes none of its own. A
        # parenthesized query that has its own modifiers becomes a derived
        # table, so that the trailing ones apply to its result.
        if ((left.order_by or left.limit is not None
             or left.offset is not None)
                and self.at_kw("order", "limit", "offset")):
            left = A.SelectStmt(items=[A.SelectItem(A.Star())],
                                from_refs=[A.SubqueryRef(left)])
        self._parse_modifiers(left)
        return left

    def parse_select_core(self, modifiers: bool = True) -> A.SelectStmt:
        if self.at_op("("):
            self.next()
            inner = self.parse_select()
            self.expect_op(")")
            return inner
        if self.at_kw("values"):
            self.next()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return A.SelectStmt(values=rows)
        self.expect_kw("select")
        stmt = A.SelectStmt()
        if self.accept_kw("distinct"):
            stmt.distinct = True
        else:
            self.accept_kw("all")
        while True:
            item = self.parse_select_item()
            stmt.items.append(item)
            if not self.accept_op(","):
                break
        if self.accept_kw("from"):
            while True:
                stmt.from_refs.append(self.parse_table_ref())
                if not self.accept_op(","):
                    break
        if self.accept_kw("where"):
            stmt.where = self.parse_expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            while True:
                stmt.group_by.append(self.parse_expr())
                if not self.accept_op(","):
                    break
        if self.accept_kw("having"):
            stmt.having = self.parse_expr()
        if modifiers:
            self._parse_modifiers(stmt)
        return stmt

    def _parse_modifiers(self, stmt: A.SelectStmt):
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                item = A.OrderItem(e)
                if self.accept_kw("desc"):
                    item.ascending = False
                else:
                    self.accept_kw("asc")
                if self.accept_kw("nulls"):
                    if self.accept_kw("first"):
                        item.nulls_first = True
                    else:
                        self.expect_kw("last")
                        item.nulls_first = False
                stmt.order_by.append(item)
                if not self.accept_op(","):
                    break
        if self.accept_kw("limit"):
            stmt.limit = self.parse_expr()
        if self.accept_kw("offset"):
            stmt.offset = self.parse_expr()

    def parse_select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Star())
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident_any()
        elif self.peek().kind == "ident" or (self.peek().kind == "kw" and self.peek().value in _SOFT_KEYWORDS):
            alias = self.ident()
        return A.SelectItem(e, alias)

    # ---- table refs -------------------------------------------------------------
    def parse_table_ref(self) -> A.TableRef:
        left = self.parse_table_primary()
        while True:
            natural = False
            if self.accept_kw("natural"):
                natural = True
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.parse_table_primary()
                left = A.JoinRef("cross", left, right)
                continue
            kind = None
            if self.accept_kw("join"):
                kind = "inner"
            elif self.accept_kw("inner"):
                self.expect_kw("join")
                kind = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "full"
            if kind is None:
                if natural:
                    raise ParseError("NATURAL requires JOIN")
                return left
            right = self.parse_table_primary()
            cond = None
            using: list[str] = []
            if not natural:
                if self.accept_kw("on"):
                    cond = self.parse_expr()
                elif self.accept_kw("using"):
                    self.expect_op("(")
                    while True:
                        using.append(self.ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
            left = A.JoinRef(kind, left, right, cond, using, natural)

    def parse_table_primary(self) -> A.TableRef:
        if self.at_op("("):
            self.next()
            if self.at_kw("select", "with", "values", "from") or self.at_op("("):
                # could be a (possibly parenthesized) query expression with set
                # ops, or a parenthesized join tree — try query first, backtrack
                save = self.i
                try:
                    sub = self.parse_select()
                    self.expect_op(")")
                    alias, col_aliases = self._parse_alias()
                    return A.SubqueryRef(sub, alias or "", col_aliases)
                except ParseError:
                    if self.at_kw("select", "with", "values", "from"):
                        raise
                    self.i = save
            ref = self.parse_table_ref()
            self.expect_op(")")
            return ref
        if self.at_kw("values"):
            sub = self.parse_select_core()
            alias, col_aliases = self._parse_alias()
            return A.SubqueryRef(sub, alias or "", col_aliases)
        name = self.ident()
        alias, col_aliases = self._parse_alias()
        if col_aliases:
            raise ParseError("column aliases only allowed on subqueries")
        return A.BaseTableRef(name, alias)

    def _parse_alias(self):
        alias = None
        col_aliases: list[str] = []
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        if alias and self.at_op("("):
            self.next()
            while True:
                col_aliases.append(self.ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return alias, col_aliases

    # ---- expressions ---------------------------------------------------------
    def parse_expr(self) -> A.Expr:
        return self.parse_or()

    def parse_or(self) -> A.Expr:
        left = self.parse_and()
        while self.at_kw("or"):
            self.next()
            left = A.BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> A.Expr:
        left = self.parse_not()
        while self.at_kw("and"):
            self.next()
            left = A.BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> A.Expr:
        if self.at_kw("not") and not (self.peek(1).kind == "kw" and self.peek(1).value == "exists"):
            self.next()
            return A.UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> A.Expr:
        if self.at_kw("exists") or (self.at_kw("not") and self.peek(1).value == "exists"):
            negated = self.accept_kw("not")
            self.expect_kw("exists")
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return A.Exists(sub, negated)
        left = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                # ANY/ALL/SOME quantified comparison
                if self.at_kw("any", "some", "all"):
                    q = self.next().value
                    q = "any" if q == "some" else q
                    self.expect_op("(")
                    sub = self.parse_select()
                    self.expect_op(")")
                    left = A.QuantifiedComparison(op, left, sub, q)
                else:
                    right = self.parse_additive()
                    left = A.BinaryOp(op, left, right)
                continue
            negated = False
            save = self.i
            if self.accept_kw("not"):
                if self.at_kw("in", "like", "ilike", "between", "similar"):
                    negated = True
                else:
                    self.i = save
                    break
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                if self.accept_kw("null"):
                    left = A.IsNull(left, neg)
                elif self.accept_kw("true"):
                    e = A.BinaryOp("is_true", left, A.Literal(True))
                    left = A.UnaryOp("not", e) if neg else e
                elif self.accept_kw("false"):
                    e = A.BinaryOp("is_false", left, A.Literal(False))
                    left = A.UnaryOp("not", e) if neg else e
                else:
                    raise ParseError(f"unsupported IS at {self.peek().pos}")
                continue
            if self.accept_kw("between"):
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                left = A.Between(left, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with", "values", "from"):
                    sub = self.parse_select()
                    self.expect_op(")")
                    left = A.InSubquery(left, sub, negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = A.InList(left, items, negated)
                continue
            if self.at_kw("like", "ilike"):
                ci = self.next().value == "ilike"
                pat = self.parse_additive()
                left = A.Like(left, pat, negated, ci)
                continue
            if self.accept_kw("similar"):
                self.expect_kw("to")
                pat = self.parse_additive()
                left = A.Like(left, pat, negated, False)
                continue
            break
        return left

    def parse_additive(self) -> A.Expr:
        left = self.parse_multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.next().value
            left = A.BinaryOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> A.Expr:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = A.BinaryOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> A.Expr:
        if self.at_op("-"):
            self.next()
            return A.UnaryOp("-", self.parse_unary())
        if self.at_op("+"):
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> A.Expr:
        e = self.parse_primary()
        while self.accept_op("::"):
            e = A.Cast(e, self.parse_type())
        return e

    def parse_primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return A.Literal(int(t.value))
        if t.kind == "float":
            self.next()
            return A.Literal(t.value, None)  # keep string; binder decides decimal/double
        if t.kind == "string":
            self.next()
            return A.Literal(t.value, Type.string())
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.at_kw("select", "with", "from"):
                sub = self.parse_select()
                self.expect_op(")")
                return A.ScalarSubquery(sub)
            e = self.parse_expr()
            if self.at_op(","):
                # row constructor (a, b) — used in IN ((..),(..)); minimal support
                items = [e]
                while self.accept_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                return A.FuncCall("row", items)
            self.expect_op(")")
            return e
        if t.kind == "kw":
            v = t.value
            if v == "null":
                self.next()
                return A.Literal(None, Type.null())
            if v == "true":
                self.next()
                return A.Literal(True, Type.bool_())
            if v == "false":
                self.next()
                return A.Literal(False, Type.bool_())
            if v == "case":
                return self.parse_case()
            if v == "cast":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                ty = self.parse_type()
                self.expect_op(")")
                return A.Cast(e, ty)
            if v == "extract":
                self.next()
                self.expect_op("(")
                part = self.next().value
                self.expect_kw("from")
                e = self.parse_expr()
                self.expect_op(")")
                return A.ExtractExpr(part.lower(), e)
            if v == "substring":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                if self.accept_kw("from"):
                    start = self.parse_expr()
                    length = None
                    if self.accept_kw("for"):
                        length = self.parse_expr()
                else:
                    self.expect_op(",")
                    start = self.parse_expr()
                    length = None
                    if self.accept_op(","):
                        length = self.parse_expr()
                self.expect_op(")")
                return A.SubstringExpr(e, start, length)
            if v == "date" and self.peek(1).kind == "string":
                self.next()
                s = self.next().value
                return A.Literal(s, Type.date())
            if v == "timestamp" and self.peek(1).kind == "string":
                self.next()
                s = self.next().value
                return A.Literal(s, Type.timestamp())
            if v == "interval":
                self.next()
                tok = self.next()
                text = tok.value
                unit = None
                if self.peek().kind == "kw" and self.peek().value in _INTERVAL_UNITS:
                    unit = self.next().value
                return A.Literal(("interval", text, unit), None)
            if v in _SOFT_KEYWORDS:
                pass  # fall through: treat as identifier/function
            elif v in ("exists", "not"):
                return self.parse_comparison()
            else:
                raise ParseError(f"unexpected keyword {v!r} at {t.pos}")
        # identifier: column ref or function call
        name = self.ident()
        if self.at_op("("):
            return self.parse_func_call(name)
        parts = [name]
        while self.at_op(".") :
            self.next()
            if self.at_op("*"):
                self.next()
                return A.Star(table=parts[0])
            parts.append(self.ident())
        return A.ColumnRef(parts)

    def parse_func_call(self, name: str) -> A.Expr:
        self.expect_op("(")
        distinct = False
        star = False
        args: list[A.Expr] = []
        if self.at_op("*"):
            self.next()
            star = True
        elif not self.at_op(")"):
            if self.accept_kw("distinct"):
                distinct = True
            else:
                self.accept_kw("all")
            args.append(self.parse_expr())
            while self.accept_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        over = None
        if self.peek().kind == "ident" and self.peek().value == "over":
            self.next()
            over = self.parse_window_spec()
        return A.FuncCall(name.lower(), args, distinct, star, over)

    def parse_window_spec(self) -> A.WindowSpec:
        self.expect_op("(")
        spec = A.WindowSpec()
        if self.peek().kind == "ident" and self.peek().value == "partition":
            self.next()
            self.expect_kw("by")
            while True:
                spec.partition_by.append(self.parse_expr())
                if not self.accept_op(","):
                    break
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                item = A.OrderItem(e)
                if self.accept_kw("desc"):
                    item.ascending = False
                else:
                    self.accept_kw("asc")
                if self.accept_kw("nulls"):
                    item.nulls_first = self.next().value == "first"
                spec.order_by.append(item)
                if not self.accept_op(","):
                    break
        # frame clause: ROWS/RANGE BETWEEN x AND y
        if self.peek().kind == "ident" and self.peek().value in ("rows", "range", "groups"):
            mode = self.next().value
            def bound():
                if self.peek().value == "unbounded":
                    self.next()
                    d = self.next().value  # preceding/following
                    return f"unbounded_{d}"
                if self.peek().value == "current":
                    self.next()
                    self.next()  # row
                    return "current_row"
                n = self.parse_expr()
                d = self.next().value
                return (n, d)
            if self.accept_kw("between"):
                start = bound()
                self.expect_kw("and")
                end = bound()
            else:
                start = bound()
                end = "current_row"
            spec.frame = (mode, start, end)
        self.expect_op(")")
        return spec

    def parse_case(self) -> A.Expr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            c = self.parse_expr()
            self.expect_kw("then")
            v = self.parse_expr()
            whens.append((c, v))
        else_ = None
        if self.accept_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return A.Case(operand, whens, else_)

    # ---- types ------------------------------------------------------------------
    def parse_type(self) -> Type:
        t = self.next()
        name = t.value.lower()
        if name in ("integer", "int"):
            return Type.int_()
        if name == "smallint":
            return Type.int_()
        if name == "bigint":
            return Type.bigint()
        if name in ("float", "real"):
            # FLOAT(p) -> double if p > 24 (pg semantics); plain FLOAT = double in pg
            if self.at_op("("):
                self.next()
                p = int(self.next().value)
                self.expect_op(")")
                return Type.float_() if p <= 24 else Type.double()
            return Type.float_() if name == "real" else Type.double()
        if name == "double":
            self.accept_kw("precision")
            return Type.double()
        if name in ("decimal", "numeric"):
            p, s = 18, 0
            if self.at_op("("):
                self.next()
                p = int(self.next().value)
                if self.accept_op(","):
                    s = int(self.next().value)
                self.expect_op(")")
            return Type.decimal(p, s)
        if name in ("varchar", "text", "string"):
            if self.at_op("("):
                self.next()
                self.next()
                self.expect_op(")")
            return Type.string()
        if name in ("char", "character"):
            if self.accept_kw("varying"):
                if self.at_op("("):
                    self.next()
                    self.next()
                    self.expect_op(")")
                return Type.string()
            n = 1
            if self.at_op("("):
                self.next()
                n = int(self.next().value)
                self.expect_op(")")
            return Type.char(n)
        if name in ("bool", "boolean"):
            return Type.bool_()
        if name == "date":
            return Type.date()
        if name == "timestamp":
            return Type.timestamp()
        if name == "interval":
            return Type.interval(IntervalUnit.DAYTIME)
        if name in ("float4",):
            return Type.float_()
        if name in ("float8",):
            return Type.double()
        if name in ("int2", "int4"):
            return Type.int_()
        if name in ("int8",):
            return Type.bigint()
        raise ParseError(f"unsupported type {name!r} at {t.pos}")


_SOFT_KEYWORDS = {
    "date", "timestamp", "time", "year", "month", "day", "hour", "minute",
    "second", "language", "first", "last", "left", "right", "replace", "set",
    "values", "key", "index", "string", "text", "copy", "table", "returns",
}

_INTERVAL_UNITS = {"day", "days", "month", "months", "year", "years", "hour", "minute", "second"}


def _fold_cross(refs: list) -> "A.TableRef":
    out = refs[0]
    for r in refs[1:]:
        out = A.JoinRef("cross", out, r, None)
    return out


def parse_sql(sql: str) -> list:
    from ..utils import compilestats

    compilestats.add("parses")
    return Parser(sql).parse_statements()
