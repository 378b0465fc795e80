"""Expression and statement AST shared by the parser, binder, and planner.

Every node is a frozen dataclass with a canonical ``key()`` serialization,
which the result registry hashes (paper section 3.4: cache identifiers are
computed from the plan after logical optimization).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


class Expr:
    def key(self) -> Any:
        raise NotImplementedError

    def children(self) -> tuple["Expr", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str

    def key(self):
        return ("col", self.name)


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    value: Any          # python int/float/str; dates pre-parsed to int days
    kind: str = "num"   # num | str | date

    def key(self):
        return ("lit", self.kind, self.value)


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str             # + - * /
    left: Expr
    right: Expr

    def key(self):
        return ("bin", self.op, self.left.key(), self.right.key())

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    op: str             # < <= > >= = <>
    left: Expr
    right: Expr

    def key(self):
        return ("cmp", self.op, self.left.key(), self.right.key())

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class And(Expr):
    terms: tuple[Expr, ...]

    def key(self):
        return ("and",) + tuple(t.key() for t in self.terms)

    def children(self):
        return self.terms


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    terms: tuple[Expr, ...]

    def key(self):
        return ("or",) + tuple(t.key() for t in self.terms)

    def children(self):
        return self.terms


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    term: Expr

    def key(self):
        return ("not", self.term.key())

    def children(self):
        return (self.term,)


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    cond: Expr
    then: Expr
    orelse: Expr

    def key(self):
        return ("case", self.cond.key(), self.then.key(), self.orelse.key())

    def children(self):
        return (self.cond, self.then, self.orelse)


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    term: Expr
    values: tuple[Expr, ...]

    def key(self):
        return ("in", self.term.key()) + tuple(v.key() for v in self.values)

    def children(self):
        return (self.term,) + self.values


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    term: Expr
    lo: Expr
    hi: Expr

    def key(self):
        return ("between", self.term.key(), self.lo.key(), self.hi.key())

    def children(self):
        return (self.term, self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class Like(Expr):
    term: Expr
    pattern: str

    def key(self):
        return ("like", self.term.key(), self.pattern)

    def children(self):
        return (self.term,)


@dataclasses.dataclass(frozen=True)
class Agg(Expr):
    fn: str             # sum | avg | count | min | max
    arg: Expr | None    # None for count(*)

    def key(self):
        return ("agg", self.fn, self.arg.key() if self.arg else None)

    def children(self):
        return (self.arg,) if self.arg is not None else ()


# -- statements ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: str | None


@dataclasses.dataclass(frozen=True)
class JoinClause:
    table: str
    on: Expr            # equality predicate


@dataclasses.dataclass(frozen=True)
class OrderItem:
    expr: Expr
    desc: bool


@dataclasses.dataclass(frozen=True)
class SelectStmt:
    items: tuple[SelectItem, ...]
    tables: tuple[str, ...]
    joins: tuple[JoinClause, ...]
    where: Expr | None
    group_by: tuple[Expr, ...]
    order_by: tuple[OrderItem, ...]
    limit: int | None


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def collect_columns(e: Expr) -> list[str]:
    return [n.name for n in walk(e) if isinstance(n, Col)]


def collect_aggs(e: Expr) -> list[Agg]:
    out, seen = [], set()
    for n in walk(e):
        if isinstance(n, Agg) and n.key() not in seen:
            seen.add(n.key())
            out.append(n)
    return out


def map_expr(e: Expr, fn) -> Expr:
    """Bottom-up structural rewrite: fn applied to each node after its
    children have been rewritten."""
    if isinstance(e, BinOp):
        e = BinOp(e.op, map_expr(e.left, fn), map_expr(e.right, fn))
    elif isinstance(e, Cmp):
        e = Cmp(e.op, map_expr(e.left, fn), map_expr(e.right, fn))
    elif isinstance(e, And):
        e = And(tuple(map_expr(t, fn) for t in e.terms))
    elif isinstance(e, Or):
        e = Or(tuple(map_expr(t, fn) for t in e.terms))
    elif isinstance(e, Not):
        e = Not(map_expr(e.term, fn))
    elif isinstance(e, Case):
        e = Case(map_expr(e.cond, fn), map_expr(e.then, fn),
                 map_expr(e.orelse, fn))
    elif isinstance(e, InList):
        e = InList(map_expr(e.term, fn),
                   tuple(map_expr(v, fn) for v in e.values))
    elif isinstance(e, Between):
        e = Between(map_expr(e.term, fn), map_expr(e.lo, fn),
                    map_expr(e.hi, fn))
    elif isinstance(e, Like):
        e = Like(map_expr(e.term, fn), e.pattern)
    elif isinstance(e, Agg):
        e = Agg(e.fn, map_expr(e.arg, fn) if e.arg is not None else None)
    return fn(e)


def conjuncts(e: Expr | None) -> list[Expr]:
    if e is None:
        return []
    if isinstance(e, And):
        out = []
        for t in e.terms:
            out.extend(conjuncts(t))
        return out
    return [e]


def make_and(terms: Sequence[Expr]) -> Expr | None:
    terms = list(terms)
    if not terms:
        return None
    if len(terms) == 1:
        return terms[0]
    return And(tuple(terms))
