"""SQL tokenizer and recursive-descent parser for the TPC-H subset.

Supported grammar (sufficient for TPC-H Q1/Q3/Q4-rewrite/Q5/Q6/Q12/Q14 and
generated property-test queries):

    SELECT item [, item]*
    FROM table [, table]* [JOIN table ON col = col]*
    [WHERE pred]
    [GROUP BY expr [, expr]*]
    [ORDER BY expr [ASC|DESC] [, ...]]
    [LIMIT n]

Expressions: + - * /, comparisons, AND/OR/NOT, BETWEEN, IN (...), LIKE,
CASE WHEN .. THEN .. ELSE .. END, DATE 'yyyy-mm-dd', INTERVAL 'n' unit,
aggregates SUM/AVG/MIN/MAX/COUNT(*).
"""

from __future__ import annotations

import re

from repro_torch.sql import ast

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d+|\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<op><>|<=|>=|=|<|>|\+|-|\*|/|\(|\)|,|\.)
    | (?P<word>[A-Za-z_][A-Za-z_0-9]*)
    )""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit", "and", "or",
    "not", "between", "in", "like", "case", "when", "then", "else", "end",
    "as", "asc", "desc", "date", "interval", "year", "month", "day", "join",
    "on", "sum", "avg", "count", "min", "max", "distinct",
}


class Token:
    def __init__(self, kind: str, value):
        self.kind = kind      # num | str | op | word | kw | eof
        self.value = value

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(sql: str) -> list[Token]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m or m.end() == pos:
            if sql[pos:].strip() == "":
                break
            raise SyntaxError(f"bad token at: {sql[pos:pos+20]!r}")
        pos = m.end()
        if m.group("num") is not None:
            text = m.group("num")
            out.append(Token("num", float(text) if "." in text
                             else int(text)))
        elif m.group("str") is not None:
            out.append(Token("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("op") is not None:
            out.append(Token("op", m.group("op")))
        else:
            w = m.group("word").lower()
            out.append(Token("kw" if w in KEYWORDS else "word", w))
    out.append(Token("eof", None))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- plumbing ------------------------------------------------------------
    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value=None) -> Token | None:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value=None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            raise SyntaxError(
                f"expected {kind} {value!r}, got {self.peek()!r}")
        return t

    # -- statement -----------------------------------------------------------
    def parse(self) -> ast.SelectStmt:
        self.expect("kw", "select")
        items = [self._select_item()]
        while self.accept("op", ","):
            items.append(self._select_item())
        self.expect("kw", "from")
        tables = [self.expect("word").value]
        joins = []
        while True:
            if self.accept("op", ","):
                tables.append(self.expect("word").value)
            elif self.accept("kw", "join"):
                tbl = self.expect("word").value
                self.expect("kw", "on")
                cond = self._expr()
                joins.append(ast.JoinClause(tbl, cond))
            else:
                break
        where = self._expr() if self.accept("kw", "where") else None
        group_by: list[ast.Expr] = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self._expr())
            while self.accept("op", ","):
                group_by.append(self._expr())
        order_by: list[ast.OrderItem] = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            order_by.append(self._order_item())
            while self.accept("op", ","):
                order_by.append(self._order_item())
        limit = None
        if self.accept("kw", "limit"):
            limit = int(self.expect("num").value)
        self.expect("eof")
        return ast.SelectStmt(tuple(items), tuple(tables), tuple(joins),
                              where, tuple(group_by), tuple(order_by), limit)

    def _select_item(self) -> ast.SelectItem:
        e = self._expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("word").value
        elif self.peek().kind == "word":
            alias = self.next().value
        return ast.SelectItem(e, alias)

    def _order_item(self) -> ast.OrderItem:
        e = self._expr()
        desc = False
        if self.accept("kw", "desc"):
            desc = True
        else:
            self.accept("kw", "asc")
        return ast.OrderItem(e, desc)

    # -- expressions (precedence climbing) ------------------------------------
    def _expr(self) -> ast.Expr:
        return self._or()

    def _or(self) -> ast.Expr:
        terms = [self._and()]
        while self.accept("kw", "or"):
            terms.append(self._and())
        return terms[0] if len(terms) == 1 else ast.Or(tuple(terms))

    def _and(self) -> ast.Expr:
        terms = [self._not()]
        while self.accept("kw", "and"):
            terms.append(self._not())
        return terms[0] if len(terms) == 1 else ast.And(tuple(terms))

    def _not(self) -> ast.Expr:
        if self.accept("kw", "not"):
            return ast.Not(self._not())
        return self._predicate()

    def _predicate(self) -> ast.Expr:
        left = self._additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("<", "<=", ">", ">=", "=", "<>"):
            self.next()
            return ast.Cmp(t.value, left, self._additive())
        if t.kind == "kw" and t.value == "between":
            self.next()
            lo = self._additive()
            self.expect("kw", "and")
            hi = self._additive()
            return ast.Between(left, lo, hi)
        if t.kind == "kw" and t.value == "in":
            self.next()
            self.expect("op", "(")
            vals = [self._additive()]
            while self.accept("op", ","):
                vals.append(self._additive())
            self.expect("op", ")")
            return ast.InList(left, tuple(vals))
        if t.kind == "kw" and t.value == "like":
            self.next()
            pat = self.expect("str").value
            return ast.Like(left, pat)
        return left

    def _additive(self) -> ast.Expr:
        e = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                e = ast.BinOp(t.value, e, self._multiplicative())
            else:
                return e

    def _multiplicative(self) -> ast.Expr:
        e = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/"):
                self.next()
                e = ast.BinOp(t.value, e, self._unary())
            else:
                return e

    def _unary(self) -> ast.Expr:
        if self.accept("op", "-"):
            return ast.BinOp("-", ast.Lit(0), self._unary())
        return self._primary()

    def _primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return ast.Lit(t.value)
        if t.kind == "str":
            self.next()
            return ast.Lit(t.value, "str")
        if self.accept("op", "("):
            e = self._expr()
            self.expect("op", ")")
            return e
        if t.kind == "kw" and t.value == "date":
            self.next()
            return ast.Lit(self.expect("str").value, "date")
        if t.kind == "kw" and t.value == "interval":
            self.next()
            n = self.expect("str").value
            unit = self.expect("kw").value
            if unit not in ("year", "month", "day"):
                raise SyntaxError(f"bad interval unit {unit}")
            return ast.Lit((int(n), unit), "interval")
        if t.kind == "kw" and t.value in ("sum", "avg", "min", "max",
                                          "count"):
            fn = self.next().value
            self.expect("op", "(")
            if fn == "count" and self.accept("op", "*"):
                self.expect("op", ")")
                return ast.Agg("count", None)
            self.accept("kw", "distinct")  # tolerated, not semantically used
            arg = self._expr()
            self.expect("op", ")")
            return ast.Agg(fn, arg)
        if t.kind == "kw" and t.value == "case":
            self.next()
            self.expect("kw", "when")
            cond = self._expr()
            self.expect("kw", "then")
            then = self._expr()
            if self.accept("kw", "else"):
                orelse = self._expr()
            else:
                orelse = ast.Lit(0)
            self.expect("kw", "end")
            return ast.Case(cond, then, orelse)
        if t.kind == "word":
            self.next()
            # qualified name t.col → treat the column name as canonical
            if self.accept("op", "."):
                return ast.Col(self.expect("word").value)
            return ast.Col(t.value)
        raise SyntaxError(f"unexpected token {t!r}")


def parse(sql: str) -> ast.SelectStmt:
    return Parser(sql).parse()
