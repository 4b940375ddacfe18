"""Recursive-descent SQL parser (reference: pkg/sql/parsers — redesigned;
the reference compiles a goyacc grammar, this is a hand-written parser over
the same dialect surface, grown feature-by-feature with the engine)."""

from __future__ import annotations

import datetime
from typing import List, Optional

from matrixone_tpu_torch.sql import ast
from matrixone_tpu_torch.sql.lexer import Token, tokenize


class ParseError(ValueError):
    pass


# THE aggregate name registry (reference: aggexec) — binder, operators,
# and the distributed-fragment planner all import these; keeping one
# definition is what stops the families drifting apart
BASIC_AGGS = frozenset(["count", "sum", "avg", "min", "max"])
STDDEV_AGGS = frozenset(["stddev", "std", "stddev_pop", "stddev_samp",
                         "variance", "var_pop", "var_samp"])
BIT_AGGS = frozenset(["bit_and", "bit_or", "bit_xor"])
AGG_FUNCS = BASIC_AGGS | STDDEV_AGGS | BIT_AGGS | {"any_value"}


def parse(sql: str) -> List[ast.Node]:
    """Parse a semicolon-separated script -> list of statements."""
    return Parser(tokenize(sql), src=sql).parse_script()


def parse_one(sql: str) -> ast.Node:
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected one statement, got {len(stmts)}")
    return stmts[0]


class Parser:
    def __init__(self, tokens: List[Token], src: str = ""):
        self.toks = tokens
        self.src = src
        self.i = 0
        self._qmark_prefix = None   # lazy '?'-op prefix counts (Params)

    def _param_index(self, pos: int) -> int:
        """Number of '?' op tokens strictly before toks[pos].  Derived
        from token POSITION (not parse order) so backtracking can't
        skew it; the prefix table makes it O(1) per placeholder where
        a rescan would be quadratic in statement size (a templated
        multi-row INSERT carries tens of thousands of '?')."""
        if self._qmark_prefix is None:
            seen, pre = 0, []
            for tk in self.toks:
                pre.append(seen)
                if tk.kind == "op" and tk.value == "?":
                    seen += 1
            self._qmark_prefix = pre
        return self._qmark_prefix[pos]

    # ---- token helpers
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def accept_soft_kw(self, word: str) -> bool:
        """Accept a NON-RESERVED keyword (lexed as ident): window-frame
        words like ROWS/PRECEDING stay usable as column names."""
        t = self.peek()
        if t.kind == "ident" and t.value.lower() == word:
            self.next()
            return True
        return False

    def expect_soft_kw(self, word: str) -> None:
        if not self.accept_soft_kw(word):
            raise ParseError(f"expected {word!r} near "
                             f"{self.peek().value!r} "
                             f"(pos {self.peek().pos})")

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise ParseError(f"expected {kw.upper()} near {self.peek().value!r}"
                             f" (pos {self.peek().pos})")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise ParseError(f"expected {op!r} near {self.peek().value!r}"
                             f" (pos {self.peek().pos})")

    def ident(self) -> str:
        t = self.peek()
        # allow non-reserved keywords as identifiers in name position
        if t.kind in ("ident", "kw"):
            self.next()
            return t.value
        raise ParseError(f"expected identifier near {t.value!r} (pos {t.pos})")

    # ---- script / statements
    def parse_script(self) -> List[ast.Node]:
        out = []
        while self.peek().kind != "eof":
            out.append(self.statement())
            while self.accept_op(";"):
                pass
        return out

    def statement(self) -> ast.Node:
        if self.at_kw("with"):
            return self.with_select()
        if self.at_kw("select"):
            return self.select_or_union()
        if self.at_kw("create"):
            return self.create()
        if self.at_kw("drop"):
            return self.drop()
        if self.at_kw("insert"):
            return self.insert()
        if self.at_kw("delete"):
            return self.delete()
        if self.at_kw("update"):
            return self.update()
        if self.at_kw("explain"):
            self.next()
            analyze = self.accept_kw("analyze")
            return ast.Explain(self.statement(), analyze=analyze)
        if self.at_kw("show"):
            return self.show()
        t0 = self.peek()
        if t0.kind == "ident" and t0.value.lower() in ("describe", "desc_table"):
            self.next()
            return ast.ShowColumns(self.ident())
        if t0.kind == "ident" and t0.value.lower() == "load":
            # LOAD DATA INFILE 'path' INTO TABLE t [FORMAT csv|parquet]
            self.next()
            w = self.ident()
            if w.lower() != "data":
                raise ParseError("expected LOAD DATA")
            w = self.ident()
            if w.lower() != "infile":
                raise ParseError("expected LOAD DATA INFILE")
            tok = self.next()
            if tok.kind != "str":
                raise ParseError("LOAD DATA INFILE requires a path string")
            path = tok.value
            self.expect_kw("into")
            self.expect_kw("table")
            table = self.ident()
            fmt = ""
            t = self.peek()
            if t.kind == "ident" and t.value.lower() == "format":
                self.next()
                fmt = self.ident().lower()
            return ast.LoadData(path, table, fmt)
        if t0.kind == "ident" and t0.value.lower() == "refresh":
            self.next()
            w = self.ident()
            if w.lower() == "materialized":
                w2 = self.ident()
                if w2.lower() != "view":
                    raise ParseError(
                        "expected REFRESH MATERIALIZED VIEW")
                return ast.RefreshMaterializedView(self.ident())
            if w.lower() != "dynamic":
                raise ParseError("expected REFRESH DYNAMIC TABLE "
                                 "or REFRESH MATERIALIZED VIEW")
            self.expect_kw("table")
            return ast.RefreshDynamicTable(self.ident())
        if t0.kind == "ident" and t0.value.lower() == "kill":
            self.next()
            query_only = False
            t = self.peek()
            if t.kind == "ident" and t.value.lower() == "query":
                self.next()
                query_only = True
            tok = self.next()
            if tok.kind != "int":
                raise ParseError("KILL requires a connection id")
            return ast.Kill(int(tok.value), query_only=query_only)
        if t0.kind == "ident" and t0.value.lower() == "alter":
            self.next()
            self.expect_kw("table")
            table = self.ident()
            act = self.ident().lower()
            if act not in ("truncate", "drop"):
                raise ParseError(f"unsupported ALTER TABLE action {act!r}")
            self.expect_kw("partition")
            return ast.AlterPartition(table, act, self.ident())
        if self.at_kw("analyze"):
            self.next()
            self.expect_kw("table")
            return ast.AnalyzeTable(self.ident())
        if self.at_kw("restore"):
            self.next()
            self.expect_kw("table")
            table = self.ident()
            self.expect_kw("from")
            self.expect_kw("snapshot")
            return ast.RestoreTable(table, self.ident())
        if self.at_kw("set"):
            self.next()
            name = self.ident()
            self.expect_op("=")
            return ast.SetVariable(name, self.expr())
        if self.accept_kw("begin"):
            return ast.BeginTxn()
        if self.accept_kw("commit"):
            return ast.CommitTxn()
        if self.accept_kw("rollback"):
            return ast.RollbackTxn()
        if self.at_ident("grant"):
            return self.grant()
        if self.at_ident("revoke"):
            return self.revoke()
        raise ParseError(f"unsupported statement near {self.peek().value!r}")

    # ---------------------------------------------- accounts/privileges
    def at_ident(self, word: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value.lower() == word

    def _word(self, what: str = "name") -> str:
        """A bare word: keyword or identifier (privilege names like
        SELECT/DROP are keywords; user/role names are identifiers).
        Case is preserved — privilege-name call sites lowercase."""
        t = self.next()
        if t.kind not in ("kw", "ident"):
            raise ParseError(f"expected {what}, got {t.value!r}")
        return t.value

    def _expect_word(self, word: str) -> None:
        t = self.next()
        if t.kind not in ("kw", "ident") or t.value.lower() != word:
            raise ParseError(f"expected {word.upper()}")

    def _str_lit(self, what: str) -> str:
        tok = self.next()
        if tok.kind != "str":
            raise ParseError(f"{what} must be a string literal")
        return tok.value

    def grant(self) -> ast.Node:
        self.next()                      # GRANT
        first = self._word("privilege or role")
        words = [first]
        while self.accept_op(","):
            words.append(self._word("privilege"))
        if len(words) == 1 and not self.at_kw("on"):
            # GRANT role TO [USER] user — names keep their case
            self._expect_word("to")
            if self.at_ident("user"):
                self.next()
            return ast.GrantRole(first, self._word("user"))
        self.expect_kw("on")
        self.accept_kw("table")
        obj = "*" if self.accept_op("*") else self.ident()
        self._expect_word("to")
        return ast.GrantPriv([w.lower() for w in words], obj,
                             self._word("role"))

    def revoke(self) -> ast.Node:
        self.next()                      # REVOKE
        first = self._word("privilege or role")
        words = [first]
        while self.accept_op(","):
            words.append(self._word("privilege"))
        if len(words) == 1 and not self.at_kw("on"):
            self.expect_kw("from")
            if self.at_ident("user"):
                self.next()
            return ast.RevokeRole(first, self._word("user"))
        self.expect_kw("on")
        self.accept_kw("table")
        obj = "*" if self.accept_op("*") else self.ident()
        self.expect_kw("from")
        return ast.RevokePriv([w.lower() for w in words], obj,
                              self._word("role"))

    def show(self) -> ast.Node:
        self.expect_kw("show")
        if self.accept_kw("tables"):
            return ast.ShowTables()
        nxt0 = self.peek()
        if nxt0.kind == "ident" and nxt0.value.lower() in ("session",
                                                           "global") \
                and self.peek(1).kind == "ident" \
                and self.peek(1).value.lower() == "variables":
            self.next()               # scope word (session semantics)
            nxt0 = self.peek()
        if nxt0.kind == "ident" and nxt0.value.lower() == "variables":
            self.next()
            like = None
            if self.accept_kw("like"):
                tok = self.next()
                if tok.kind != "str":
                    raise ParseError("SHOW VARIABLES LIKE needs a string")
                like = tok.value
            return ast.ShowVariables(like)
        if self.accept_kw("snapshots"):
            return ast.ShowSnapshots()
        if nxt0.kind == "ident" and nxt0.value.lower() == "trace":
            self.next()
            return ast.ShowTrace()
        if self.at_ident("accounts"):
            self.next()
            return ast.ShowAccounts()
        if self.at_ident("grants"):
            self.next()
            user = None
            t = self.peek()
            if t.kind in ("kw", "ident") and t.value.lower() == "for":
                self.next()
                user = self.next().value
            return ast.ShowGrants(user)
        nxt = self.peek()
        if nxt.kind == "ident" and nxt.value.lower() == "functions":
            self.next()
            return ast.ShowFunctions()
        if nxt.kind == "ident" and nxt.value.lower() == "materialized":
            self.next()
            w = self.ident()
            if w.lower() != "views":
                raise ParseError("expected SHOW MATERIALIZED VIEWS")
            return ast.ShowMaterializedViews()
        if nxt.kind == "ident" and nxt.value.lower() == "stages":
            self.next()
            return ast.ShowStages()
        if nxt.kind == "ident" and nxt.value.lower() == "publications":
            self.next()
            return ast.ShowPublications()
        if nxt.kind == "ident" and nxt.value.lower() == "processlist":
            self.next()
            return ast.ShowProcesslist()
        if nxt.kind == "ident" and nxt.value.lower() == "partitions":
            self.next()
            self.expect_kw("from")
            return ast.ShowPartitions(self.ident())
        if nxt.kind == "ident" and nxt.value.lower() == "columns":
            self.next()
            self.expect_kw("from")
            return ast.ShowColumns(self.ident())
        if nxt.kind == "ident" and nxt.value.lower() == "indexes":
            self.next()
            self.expect_kw("from")
            return ast.ShowIndexes(self.ident())
        if self.accept_kw("create"):
            self.expect_kw("table")
            return ast.ShowCreateTable(self.ident())
        raise ParseError("unsupported SHOW")

    # ---- SELECT
    def with_select(self) -> ast.Node:
        """WITH name AS (select ...) [, ...] select ... (non-recursive)."""
        self.expect_kw("with")
        ctes = []
        while True:
            name = self.ident()
            self.expect_kw("as")
            self.expect_op("(")
            sub = self.select_or_union()
            self.expect_op(")")
            ctes.append((name, sub))
            if not self.accept_op(","):
                break
        stmt = self.select_or_union()
        if isinstance(stmt, ast.Union):
            for arm in stmt.selects:
                arm.ctes = list(ctes) + list(arm.ctes)
        else:
            stmt.ctes = list(ctes) + list(stmt.ctes)
        return stmt

    def select_or_union(self) -> ast.Node:
        first = self.select()
        if not self.at_kw("union"):
            return first
        selects, alls = [first], []
        while self.accept_kw("union"):
            alls.append(self.accept_kw("all"))
            selects.append(self.select())
        # a trailing ORDER BY / LIMIT binds to the whole UNION (MySQL);
        # the select() of the last arm grabbed it — move it up
        last = selects[-1]
        u = ast.Union(selects, alls, order_by=last.order_by,
                      limit=last.limit, offset=last.offset)
        last.order_by, last.limit, last.offset = [], None, None
        return u

    def select(self) -> ast.Select:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        items = [self.select_item()]
        while self.accept_op(","):
            items.append(self.select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self.table_expr()
        where = self.expr() if self.accept_kw("where") else None
        group_by: List[ast.Node] = []
        fill = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.expr())
            while self.accept_op(","):
                group_by.append(self.expr())
            t = self.peek()
            if t.kind == "ident" and t.value.lower() == "fill" \
                    and self.peek(1).kind == "op" \
                    and self.peek(1).value == "(":
                # GROUP BY ... FILL(PREV | LINEAR | VALUE, x)
                # (reference: colexec/fill null-fill modes)
                self.next()
                self.expect_op("(")
                mode = self.ident().lower()
                if mode not in ("prev", "linear", "value", "none"):
                    raise ParseError(f"unknown FILL mode {mode!r}")
                const = None
                if mode == "value":
                    self.expect_op(",")
                    neg = self.accept_op("-")
                    tok = self.next()
                    if tok.kind not in ("int", "float"):
                        raise ParseError(
                            f"FILL(VALUE, ...) requires a numeric literal "
                            f"(near {tok.value!r}, pos {tok.pos})")
                    const = float(tok.value) * (-1 if neg else 1)
                self.expect_op(")")
                if mode != "none":
                    fill = (mode, const)
        having = self.expr() if self.accept_kw("having") else None
        order_by: List[ast.OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.order_item())
            while self.accept_op(","):
                order_by.append(self.order_item())
        limit = offset = None
        if self.accept_kw("limit"):
            limit = int(self.next().value)
            if self.accept_op(","):  # LIMIT off, n
                offset = limit
                limit = int(self.next().value)
            elif self.accept_kw("offset"):
                offset = int(self.next().value)
        return ast.Select(items=items, from_=from_, where=where,
                          group_by=group_by, having=having,
                          order_by=order_by, limit=limit, offset=offset,
                          distinct=distinct, fill=fill)

    def select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        return ast.SelectItem(e, alias)

    def order_item(self) -> ast.OrderItem:
        e = self.expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        else:
            self.accept_kw("asc")
        return ast.OrderItem(e, desc)

    def table_expr(self) -> ast.Node:
        left = self.table_primary()
        while True:
            if self.accept_op(","):
                right = self.table_primary()
                left = ast.Join("cross", left, right)
                continue
            kind = None
            at_full = self._at_full_join()
            if self.at_kw("join", "inner", "left", "right", "cross") \
                    or at_full:
                if self.accept_kw("inner"):
                    kind = "inner"
                elif self.accept_kw("left"):
                    self.accept_kw("outer")
                    kind = "left"
                elif self.accept_kw("right"):
                    self.accept_kw("outer")
                    kind = "right"
                elif at_full:
                    self.next()
                    self.accept_kw("outer")
                    kind = "full"
                elif self.accept_kw("cross"):
                    kind = "cross"
                else:
                    kind = "inner"
                self.expect_kw("join")
                right = self.table_primary()
                on = self.expr() if self.accept_kw("on") else None
                left = ast.Join(kind, left, right, on)
                continue
            return left

    def table_primary(self) -> ast.Node:
        if self.accept_op("("):
            sel = self.select_or_union()
            self.expect_op(")")
            has_as = self.accept_kw("as")
            if not has_as and self.peek().kind != "ident":
                raise ParseError(
                    f"derived table requires an alias (near "
                    f"{self.peek().value!r}, pos {self.peek().pos})")
            alias = self.ident()
            return self._maybe_sample(ast.SubqueryRef(sel, alias))
        name = self.ident()
        snapshot = None
        as_of_ts = None
        # time travel: t AS OF SNAPSHOT 'name' | t AS OF TIMESTAMP 12345
        if self.at_kw("as") and self.peek(1).kind == "kw" \
                and self.peek(1).value == "of":
            self.next()
            self.next()
            if self.accept_kw("snapshot"):
                t = self.next()
                snapshot = t.value
            elif self.accept_kw("timestamp"):
                as_of_ts = int(self.next().value)
            else:
                raise ParseError("AS OF requires SNAPSHOT or TIMESTAMP")
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident" and not self._at_sample() \
                and not self._at_full_join():
            alias = self.ident()
        return self._maybe_sample(
            ast.TableRef(name, alias, snapshot=snapshot, as_of_ts=as_of_ts))

    def _at_full_join(self) -> bool:
        t = self.peek()
        return (t.kind == "ident" and t.value.lower() == "full"
                and self.peek(1).kind == "kw"
                and self.peek(1).value in ("outer", "join"))

    def _at_sample(self) -> bool:
        t = self.peek()
        return (t.kind == "ident" and t.value.lower() == "sample"
                and self.peek(1).kind in ("int", "float"))

    def _maybe_sample(self, ref: ast.Node) -> ast.Node:
        """`t SAMPLE 100 ROWS` / `t SAMPLE 1.5 PERCENT` table suffix
        (reference: colexec/sample)."""
        if not self._at_sample():
            return ref
        self.next()
        v = float(self.next().value)
        u = self.peek()
        if u.kind == "ident" and u.value.lower() in ("rows", "percent"):
            self.next()
            return ast.SampleRef(ref, v, u.value.lower())
        raise ParseError("SAMPLE requires ROWS or PERCENT")

    # ---- DDL / DML
    def create(self) -> ast.Node:
        self.expect_kw("create")
        t0 = self.peek()
        if self.at_kw("or") \
                or (t0.kind == "ident" and t0.value.lower() == "function") \
                or (t0.kind == "ident" and t0.value.lower() == "aggregate"
                    and self.peek(1).kind == "ident"
                    and self.peek(1).value.lower() == "function"):
            return self._create_function()
        if t0.kind == "ident" and t0.value.lower() == "account":
            # CREATE ACCOUNT [IF NOT EXISTS] name
            #   ADMIN_NAME 'user' IDENTIFIED BY 'password'
            self.next()
            ine = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                ine = True
            name = self.ident()
            self._expect_word("admin_name")
            admin = self._str_lit("ADMIN_NAME")
            self._expect_word("identified")
            self._expect_word("by")
            return ast.CreateAccount(name, admin,
                                     self._str_lit("password"), ine)
        if t0.kind == "ident" and t0.value.lower() == "user":
            # CREATE USER [IF NOT EXISTS] name IDENTIFIED BY 'password'
            self.next()
            ine = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                ine = True
            name = self.ident()
            self._expect_word("identified")
            self._expect_word("by")
            return ast.CreateUser(name, self._str_lit("password"), ine)
        if t0.kind == "ident" and t0.value.lower() == "role":
            self.next()
            return ast.CreateRole(self.ident())
        if t0.kind == "ident" and t0.value.lower() == "stage":
            # CREATE STAGE name URL = 'url'
            self.next()
            name = self.ident()
            kw = self.ident()
            if kw.lower() != "url":
                raise ParseError("CREATE STAGE requires URL = '...'")
            self.expect_op("=")
            tok = self.next()
            if tok.kind != "str":
                raise ParseError("stage URL must be a string")
            return ast.CreateStage(name, tok.value)
        if t0.kind == "ident" and t0.value.lower() == "publication":
            # CREATE PUBLICATION name TABLE t1 [, t2 ...]
            self.next()
            name = self.ident()
            self.expect_kw("table")
            tables = [self.ident()]
            while self.accept_op(","):
                tables.append(self.ident())
            return ast.CreatePublication(name, tables)
        if t0.kind == "ident" and t0.value.lower() == "source":
            # CREATE SOURCE name (cols): append-only connector-fed table
            self.next()
            name = self.ident()
            self.expect_op("(")
            cols = [self.column_def()]
            while self.accept_op(","):
                cols.append(self.column_def())
            self.expect_op(")")
            return ast.CreateSource(name, cols)
        if t0.kind == "ident" and t0.value.lower() == "dynamic":
            # CREATE DYNAMIC TABLE name AS select ...
            self.next()
            self.expect_kw("table")
            name = self.ident()
            self.expect_kw("as")
            start = self.peek().pos
            sel = self.select_or_union() if self.at_kw("select") \
                else self.with_select()
            end = (self.peek().pos if self.peek().kind != "eof"
                   else len(self.src))
            return ast.CreateDynamicTable(
                name, sel, self.src[start:end].rstrip().rstrip(";"))
        if t0.kind == "ident" and t0.value.lower() == "materialized":
            # CREATE MATERIALIZED VIEW name AS select ...
            self.next()
            w = self.ident()
            if w.lower() != "view":
                raise ParseError("expected CREATE MATERIALIZED VIEW")
            name = self.ident()
            self.expect_kw("as")
            start = self.peek().pos
            sel = self.select_or_union() if self.at_kw("select") \
                else self.with_select()
            end = (self.peek().pos if self.peek().kind != "eof"
                   else len(self.src))
            return ast.CreateMaterializedView(
                name, sel, self.src[start:end].rstrip().rstrip(";"))
        if t0.kind == "ident" and t0.value.lower() == "external":
            # CREATE EXTERNAL TABLE t (cols) LOCATION 'url' FORMAT fmt
            self.next()
            self.expect_kw("table")
            name = self.ident()
            self.expect_op("(")
            cols = [self.column_def()]
            while self.accept_op(","):
                cols.append(self.column_def())
            self.expect_op(")")
            w = self.ident()
            if w.lower() != "location":
                raise ParseError("EXTERNAL TABLE requires LOCATION '...'")
            tok = self.next()
            if tok.kind != "str":
                raise ParseError("LOCATION must be a string")
            location = tok.value
            fmt = ""
            snap = None
            t = self.peek()
            if t.kind == "ident" and t.value.lower() == "format":
                self.next()
                fmt = self.ident().lower()
            if self.at_kw("snapshot"):
                # iceberg time travel: ... FORMAT iceberg SNAPSHOT <id>
                self.next()
                tok = self.next()
                if tok.kind != "int":
                    raise ParseError("SNAPSHOT requires an integer id")
                snap = int(tok.value)
            return ast.CreateExternalTable(name, cols, location, fmt,
                                           snapshot=snap)
        if self.accept_kw("table"):
            if_not = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not = True
            name = self.ident()
            self.expect_op("(")
            cols: List[ast.ColumnDef] = []
            pk: List[str] = []
            while True:
                if self.accept_kw("primary"):
                    self.expect_kw("key")
                    self.expect_op("(")
                    pk.append(self.ident())
                    while self.accept_op(","):
                        pk.append(self.ident())
                    self.expect_op(")")
                else:
                    cols.append(self.column_def())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            for c in cols:
                if c.primary_key and c.name not in pk:
                    pk.append(c.name)
            part = self._partition_clause()
            return ast.CreateTable(name, cols, pk, if_not,
                                   partition_by=part)
        if self.accept_kw("snapshot"):
            return ast.CreateSnapshot(self.ident())
        return self._create_rest()

    def _create_function(self) -> ast.Node:
        """CREATE [OR REPLACE] [AGGREGATE] FUNCTION f(x FLOAT, ...)
        RETURNS FLOAT LANGUAGE PYTHON [PROPERTIES ('k'='v', ...)]
        AS $$ body $$ | AS 'body'."""
        or_replace = False
        if self.accept_kw("or"):
            self._expect_word("replace")
            or_replace = True
        aggregate = False
        t = self.peek()
        if t.kind == "ident" and t.value.lower() == "aggregate":
            self.next()
            aggregate = True
        self._expect_word("function")
        name = self.ident()

        def type_args() -> tuple:
            if not self.accept_op("("):
                return ()
            vals = [int(self.next().value)]
            while self.accept_op(","):
                vals.append(int(self.next().value))
            self.expect_op(")")
            return tuple(vals)

        self.expect_op("(")
        args = []
        if not self.at_op(")"):
            while True:
                aname = self.ident()
                tname = self.ident().lower()
                args.append((aname, tname, type_args()))
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        self._expect_word("returns")
        rtype = self.ident().lower()
        rargs = type_args()
        self._expect_word("language")
        lang = self.ident().lower()
        props = {}
        t = self.peek()
        if t.kind == "ident" and t.value.lower() == "properties":
            self.next()
            self.expect_op("(")
            while True:
                k = self._str_lit("property name")
                self.expect_op("=")
                v = self._str_lit("property value")
                props[k.lower()] = v
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        self.expect_kw("as")
        body = self._str_lit("function body")
        return ast.CreateFunction(name, args, rtype, rargs, lang, body,
                                  props, or_replace, aggregate)

    def _partition_clause(self):
        """PARTITION BY RANGE(col) (PARTITION p VALUES LESS THAN (x|
        MAXVALUE), ...) | PARTITION BY HASH(col) PARTITIONS n.
        SHARDS n is accepted as an alias of PARTITIONS n: a table hash-
        partitioned on its join/group column with n == query_shards is
        read co-partitioned by the device-shard executor (no row ever
        crosses an exchange, parallel/dist_query.py)."""
        if not self.accept_kw("partition"):
            return None
        self.expect_kw("by")
        kind = self.ident().lower()
        if kind not in ("range", "hash"):
            raise ParseError(f"unsupported PARTITION BY {kind!r}")
        self.expect_op("(")
        col = self.ident()
        self.expect_op(")")
        if kind == "hash":
            t = self.peek()
            if not (t.kind == "ident"
                    and t.value.lower() in ("partitions", "shards")):
                raise ParseError(
                    "HASH partitioning requires PARTITIONS n (SHARDS n)")
            self.next()
            n = int(self.next().value)
            if n < 1:
                raise ParseError("PARTITIONS must be >= 1")
            return {"kind": "hash", "column": col, "n": n}
        self.expect_op("(")
        parts = []
        while True:
            self.expect_kw("partition")
            pname = self.ident()
            self.expect_kw("values")
            less = self.ident()
            than = self.ident()
            if less.lower() != "less" or than.lower() != "than":
                raise ParseError("expected VALUES LESS THAN")
            self.expect_op("(")
            t = self.peek()
            if t.kind == "ident" and t.value.lower() == "maxvalue":
                self.next()
                bound = None
            else:
                neg = self.accept_op("-")
                tok = self.next()
                if tok.kind in ("int", "float"):
                    bound = float(tok.value) * (-1 if neg else 1)
                elif tok.kind == "str" and not neg:
                    bound = tok.value        # date string, bound later
                else:
                    raise ParseError("bad partition bound")
            self.expect_op(")")
            parts.append((pname, bound))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return {"kind": "range", "column": col, "parts": parts}

    def _create_rest(self) -> ast.Node:
        if self.accept_kw("index"):
            name = self.ident()
            using = None
            if self.accept_kw("using"):
                using = self.ident()
            self.expect_kw("on")
            table = self.ident()
            self.expect_op("(")
            columns = [self.ident()]
            while self.accept_op(","):
                columns.append(self.ident())
            self.expect_op(")")
            options = {}
            while self.peek().kind in ("ident", "kw") and self.peek().value not in (";",):
                if self.peek().kind == "eof":
                    break
                key = self.ident()
                self.expect_op("=")
                t = self.next()
                options[key] = t.value
            return ast.CreateIndex(name, table, columns, using, options)
        raise ParseError("unsupported CREATE")

    def column_def(self) -> ast.ColumnDef:
        name = self.ident()
        type_name = self.ident()
        args: tuple = ()
        if self.accept_op("("):
            vals = [int(self.next().value)]
            while self.accept_op(","):
                vals.append(int(self.next().value))
            self.expect_op(")")
            args = tuple(vals)
        not_null = False
        primary = False
        default = None
        auto_inc = False
        while True:
            if self.accept_kw("not"):
                self.expect_kw("null")
                not_null = True
            elif self.accept_kw("null"):
                pass
            elif self.accept_kw("primary"):
                self.expect_kw("key")
                primary = True
            elif self.accept_kw("default"):
                default = self.expr()
            elif self.accept_kw("auto_increment"):
                auto_inc = True
            else:
                break
        return ast.ColumnDef(name, type_name.lower(), args, not_null, primary,
                             default, auto_inc)

    def drop(self) -> ast.Node:
        self.expect_kw("drop")
        if self.accept_kw("snapshot"):
            return ast.DropSnapshot(self.ident())
        t0 = self.peek()
        if t0.kind == "ident" and t0.value.lower() == "function":
            self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropFunction(self.ident(), if_exists)
        if t0.kind == "ident" and t0.value.lower() == "materialized":
            self.next()
            w = self.ident()
            if w.lower() != "view":
                raise ParseError("expected DROP MATERIALIZED VIEW")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropMaterializedView(self.ident(), if_exists)
        if t0.kind == "ident" and t0.value.lower() == "stage":
            self.next()
            return ast.DropStage(self.ident())
        if t0.kind == "ident" and t0.value.lower() == "publication":
            self.next()
            return ast.DropPublication(self.ident())
        if t0.kind == "ident" and t0.value.lower() == "account":
            self.next()
            return ast.DropAccount(self.ident())
        if t0.kind == "ident" and t0.value.lower() == "user":
            self.next()
            return ast.DropUser(self.ident())
        if t0.kind == "ident" and t0.value.lower() == "role":
            self.next()
            return ast.DropRole(self.ident())
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ast.DropTable(self.ident(), if_exists)

    def insert(self) -> ast.Node:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        columns: List[str] = []
        if self.accept_op("("):
            columns.append(self.ident())
            while self.accept_op(","):
                columns.append(self.ident())
            self.expect_op(")")
        if self.accept_kw("values"):
            rows = []
            while True:
                self.expect_op("(")
                row = [self.expr()]
                while self.accept_op(","):
                    row.append(self.expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return ast.Insert(table, columns, rows=rows)
        if self.at_kw("select"):
            return ast.Insert(table, columns, select=self.select())
        raise ParseError("INSERT requires VALUES or SELECT")

    def delete(self) -> ast.Node:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.ident()
        where = self.expr() if self.accept_kw("where") else None
        return ast.Delete(table, where)

    def update(self) -> ast.Node:
        self.expect_kw("update")
        table = self.ident()
        self.expect_kw("set")
        assigns = []
        name = self.ident()
        self.expect_op("=")
        assigns.append((name, self.expr()))
        while self.accept_op(","):
            name = self.ident()
            self.expect_op("=")
            assigns.append((name, self.expr()))
        where = self.expr() if self.accept_kw("where") else None
        return ast.Update(table, assigns, where)

    # ---- expressions (precedence climbing)
    def expr(self) -> ast.Node:
        return self.or_expr()

    def or_expr(self) -> ast.Node:
        left = self.and_expr()
        while self.accept_kw("or"):
            left = ast.BinaryOp("or", left, self.and_expr())
        return left

    def and_expr(self) -> ast.Node:
        left = self.not_expr()
        while self.accept_kw("and"):
            left = ast.BinaryOp("and", left, self.not_expr())
        return left

    def not_expr(self) -> ast.Node:
        if self.accept_kw("not"):
            return ast.UnaryOp("not", self.not_expr())
        return self.comparison()

    def comparison(self) -> ast.Node:
        left = self.additive()
        while True:
            if self.at_op("=", "<", ">", "<=", ">=", "!=", "<>"):
                op = self.next().value
                if op == "<>":
                    op = "!="
                left = ast.BinaryOp(op, left, self.additive())
            elif self.at_kw("like"):
                self.next()
                left = ast.BinaryOp("like", left, self.additive())
            elif self.at_kw("not") and self.peek(1).value == "like":
                self.next()
                self.next()
                left = ast.UnaryOp(
                    "not", ast.BinaryOp("like", left, self.additive()))
            elif self.at_kw("is"):
                self.next()
                negated = self.accept_kw("not")
                self.expect_kw("null")
                left = ast.IsNull(left, negated)
            elif self.at_kw("in") or (self.at_kw("not") and
                                      self.peek(1).value == "in"):
                negated = self.accept_kw("not")
                self.expect_kw("in")
                self.expect_op("(")
                if self.at_kw("select"):
                    sub = self.select()
                    self.expect_op(")")
                    left = ast.InList(left, [ast.Subquery(sub)], negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = ast.InList(left, items, negated)
            elif self.at_kw("between") or (self.at_kw("not") and
                                           self.peek(1).value == "between"):
                negated = self.accept_kw("not")
                self.expect_kw("between")
                low = self.additive()
                self.expect_kw("and")
                high = self.additive()
                left = ast.Between(left, low, high, negated)
            else:
                return left

    def additive(self) -> ast.Node:
        left = self.multiplicative()
        while self.at_op("+", "-"):
            op = self.next().value
            right = self.multiplicative()
            if isinstance(right, ast.IntervalLiteral):
                left = ast.BinaryOp("date" + op, left, right)
            else:
                left = ast.BinaryOp(op, left, right)
        return left

    def multiplicative(self) -> ast.Node:
        left = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = ast.BinaryOp(op, left, self.unary())
        return left

    def unary(self) -> ast.Node:
        if self.accept_op("-"):
            operand = self.unary()
            if isinstance(operand, ast.Literal) and operand.kind == "int":
                return ast.Literal(-operand.value, operand.kind)
            if isinstance(operand, ast.Literal) and operand.kind == "float":
                # float literal values are TEXT (decimal scale detection
                # happens at bind); negate textually
                text = str(operand.value)
                return ast.Literal(text[1:] if text.startswith("-")
                                   else "-" + text, "float")
            return ast.UnaryOp("-", operand)
        if self.accept_op("+"):
            return self.unary()
        return self.primary()

    def primary(self) -> ast.Node:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return ast.Literal(int(t.value), "int")
        if t.kind == "float":
            self.next()
            # keep the literal text: the binder types short decimal literals
            # as exact DECIMAL64 (MySQL semantics), not float
            return ast.Literal(t.value, "float")
        if t.kind == "str":
            self.next()
            return ast.Literal(t.value, "str")
        if self.accept_op("?"):
            return ast.Param(self._param_index(self.i - 1))
        if t.kind == "sysvar":
            self.next()
            name = t.value
            for scope in ("session.", "global."):
                if name.startswith(scope):
                    name = name[len(scope):]
            return ast.SysVar(name)
        if t.kind == "kw":
            if self.accept_kw("null"):
                return ast.Literal(None, "null")
            if self.accept_kw("true"):
                return ast.Literal(True, "bool")
            if self.accept_kw("false"):
                return ast.Literal(False, "bool")
            if self.accept_kw("date"):
                if self.at_op("("):
                    # function form: DATE(expr) extracts the date part
                    self.expect_op("(")
                    arg = self.expr()
                    self.expect_op(")")
                    return ast.FuncCall("date", [arg])
                s = self.next()
                if s.kind != "str":
                    raise ParseError("DATE literal requires a string")
                d = datetime.date.fromisoformat(s.value)
                return ast.DateLiteral((d - datetime.date(1970, 1, 1)).days)
            if self.accept_kw("interval"):
                v = self.next()
                unit = self.ident()
                unit = unit.rstrip("s")
                return ast.IntervalLiteral(int(v.value), unit)
            if self.accept_kw("case"):
                whens = []
                operand = None
                if not self.at_kw("when"):
                    operand = self.expr()
                while self.accept_kw("when"):
                    cond = self.expr()
                    if operand is not None:
                        cond = ast.BinaryOp("=", operand, cond)
                    self.expect_kw("then")
                    whens.append((cond, self.expr()))
                else_ = self.expr() if self.accept_kw("else") else None
                self.expect_kw("end")
                return ast.Case(whens, else_)
            if self.accept_kw("extract"):
                # EXTRACT(unit FROM expr) -> unit(expr)
                self.expect_op("(")
                unit = self.ident().lower()
                self.expect_kw("from")
                e = self.expr()
                self.expect_op(")")
                return ast.FuncCall(unit, [e])
            if self.accept_kw("cast"):
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("as")
                tname = self.ident()
                args: tuple = ()
                if self.accept_op("("):
                    vals = [int(self.next().value)]
                    while self.accept_op(","):
                        vals.append(int(self.next().value))
                    self.expect_op(")")
                    args = tuple(vals)
                self.expect_op(")")
                return ast.Cast(e, tname.lower(), args)
            if self.accept_kw("exists"):
                self.expect_op("(")
                sel = self.select()
                self.expect_op(")")
                return ast.Exists(sel)
            if t.value in AGG_FUNCS:
                return self.func_or_column()
        if self.accept_op("("):
            if self.at_kw("select"):
                sel = self.select()
                self.expect_op(")")
                return ast.Subquery(sel)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind in ("ident", "kw"):
            return self.func_or_column()
        raise ParseError(f"unexpected token {t.value!r} (pos {t.pos})")

    def _maybe_over(self, fc: "ast.FuncCall") -> ast.Node:
        if not self.accept_kw("over"):
            return fc
        self.expect_op("(")
        spec = ast.WindowSpec()
        if self.accept_kw("partition"):
            self.expect_kw("by")
            spec.partition_by.append(self.expr())
            while self.accept_op(","):
                spec.partition_by.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            spec.order_by.append(self.order_item())
            while self.accept_op(","):
                spec.order_by.append(self.order_item())
        # inside OVER(...) nothing else can start with these idents, so
        # soft keywords are unambiguous here
        if self.accept_soft_kw("rows"):
            spec.frame = ("rows",) + self._frame_bounds()
        elif self.accept_soft_kw("range"):
            # only the two frames equivalent to defaults are accepted
            # (numeric RANGE needs typed interval arithmetic)
            lo, hi = self._frame_bounds()
            if lo != ("unbounded_preceding", None) or \
                    hi not in (("current", None),
                               ("unbounded_following", None)):
                raise ParseError(
                    "only RANGE BETWEEN UNBOUNDED PRECEDING AND "
                    "CURRENT ROW / UNBOUNDED FOLLOWING are supported")
            if hi == ("unbounded_following", None):
                spec.frame = ("rows", lo, hi)    # whole partition
        self.expect_op(")")
        fc.window = spec
        return fc

    def _frame_bounds(self):
        """BETWEEN <bound> AND <bound> | <bound> (hi = CURRENT ROW)."""
        if self.accept_kw("between"):
            lo = self._frame_bound()
            self.expect_kw("and")
            return lo, self._frame_bound()
        return self._frame_bound(), ("current", None)

    def _frame_bound(self):
        if self.accept_soft_kw("unbounded"):
            if self.accept_soft_kw("preceding"):
                return ("unbounded_preceding", None)
            self.expect_soft_kw("following")
            return ("unbounded_following", None)
        if self.accept_soft_kw("current"):
            self.expect_soft_kw("row")
            return ("current", None)
        t = self.peek()
        if t.kind == "int":
            self.next()
            k = int(t.value)
            if self.accept_soft_kw("preceding"):
                return ("preceding", k)
            self.expect_soft_kw("following")
            return ("following", k)
        raise ParseError(
            f"expected frame bound near {t.value!r} (pos {t.pos})")

    def func_or_column(self) -> ast.Node:
        name = self.ident()
        if name.lower() == "match" and self.at_op("("):
            # MySQL fulltext: MATCH (col [, col...]) AGAINST ('query')
            self.expect_op("(")
            cols = [self.expr()]
            while self.accept_op(","):
                cols.append(self.expr())
            self.expect_op(")")
            nxt = self.peek()
            if nxt.kind == "ident" and nxt.value.lower() == "against":
                self.next()
                self.expect_op("(")
                q = self.expr()
                self.expect_op(")")
                return ast.FuncCall("match_against", cols + [q])
            return ast.FuncCall("match", cols)
        if name.lower() in ("timestampadd", "timestampdiff") \
                and self.at_op("("):
            # MySQL: the first argument is a bare interval-unit keyword
            # (MINUTE, DAY, ...), not an expression
            self.expect_op("(")
            unit = self.ident().lower()
            self.expect_op(",")
            a1 = self.expr()
            self.expect_op(",")
            a2 = self.expr()
            self.expect_op(")")
            return ast.FuncCall(name.lower(),
                                [ast.Literal(unit, "str"), a1, a2])
        if name.lower() == "convert" and self.at_op("("):
            # CONVERT(expr, type) = CAST(expr AS type)
            save = self.i
            self.expect_op("(")
            inner = self.expr()
            if self.accept_op(","):
                tname = self.ident().lower()
                targs = []
                if self.accept_op("("):
                    while not self.at_op(")"):
                        targs.append(int(self.next().value))
                        self.accept_op(",")
                    self.expect_op(")")
                self.expect_op(")")
                return ast.Cast(inner, tname, targs)
            self.i = save          # CONVERT(x USING ...) etc: fall through
        if self.accept_op("("):
            if self.accept_op("*"):
                self.expect_op(")")
                return self._maybe_over(
                    ast.FuncCall(name.lower(), [], star=True))
            distinct = self.accept_kw("distinct")
            args = []
            if not self.at_op(")"):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
            self.expect_op(")")
            fc = ast.FuncCall(name.lower(), args, distinct=distinct)
            return self._maybe_over(fc)
        if self.accept_op("."):
            col = self.ident()
            return ast.ColumnRef(col, table=name)
        return ast.ColumnRef(name)
