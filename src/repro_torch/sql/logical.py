"""Logical query plan (LQP) and the binder (paper Fig. 2, green boxes).

The binder validates a parsed statement against the external catalog,
resolves column types, rewrites string literals on dictionary columns to
dictionary codes (including LIKE prefix patterns → IN code lists), folds
date/interval arithmetic, extracts join edges from WHERE/ON equality
predicates, and emits a logical plan tree.

TPC-H-scoped simplifications (documented in DESIGN.md): equi-joins must be
FK→PK (the build side's key is its primary key — true for every TPC-H join
we target), no NULL semantics (TPC-H data has no NULLs), group-by keys are
plain columns.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
from typing import Any

import numpy as np

from repro_torch.data.catalog import Catalog
from repro_torch.sql import ast

# Primary keys for build-side uniqueness reasoning.
PRIMARY_KEYS = {
    "orders": "o_orderkey", "customer": "c_custkey", "part": "p_partkey",
    "supplier": "s_suppkey", "nation": "n_nationkey",
    "region": "r_regionkey",
}


@dataclasses.dataclass(frozen=True)
class ColType:
    kind: str                       # num | dict | bytes
    dtype: str                      # numpy dtype string
    dictionary: tuple[str, ...] | None = None


Schema = dict[str, ColType]


# -- logical nodes ------------------------------------------------------------

class LNode:
    def key(self) -> Any:
        raise NotImplementedError

    def children(self) -> tuple["LNode", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class LScan(LNode):
    table: str
    schema_cols: tuple[str, ...]

    def key(self):
        return ("scan", self.table, self.schema_cols)


@dataclasses.dataclass(frozen=True)
class LFilter(LNode):
    child: LNode
    pred: ast.Expr

    def key(self):
        return ("filter", self.child.key(), self.pred.key())

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class LProject(LNode):
    child: LNode
    exprs: tuple[tuple[str, ast.Expr], ...]   # (output name, expr)

    def key(self):
        return ("project", self.child.key(),
                tuple((n, e.key()) for n, e in self.exprs))

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class LJoin(LNode):
    """Equi-join; ``right`` is the build side whose key is unique (PK)."""
    left: LNode
    right: LNode
    left_key: str
    right_key: str

    def key(self):
        return ("join", self.left.key(), self.right.key(), self.left_key,
                self.right_key)

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class LAggregate(LNode):
    child: LNode
    group_cols: tuple[str, ...]
    # (output name, fn, arg expr or None for count(*))
    aggs: tuple[tuple[str, str, ast.Expr | None], ...]

    def key(self):
        return ("agg", self.child.key(), self.group_cols,
                tuple((n, f, a.key() if a else None)
                      for n, f, a in self.aggs))

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class LSort(LNode):
    child: LNode
    keys: tuple[tuple[str, bool], ...]        # (column name, desc)

    def key(self):
        return ("sort", self.child.key(), self.keys)

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class LLimit(LNode):
    child: LNode
    n: int

    def key(self):
        return ("limit", self.child.key(), self.n)

    def children(self):
        return (self.child,)


def semantic_hash(node: LNode) -> str:
    """Cache identifier: hash of the logical plan structure (section 3.4)."""
    return hashlib.sha256(repr(node.key()).encode()).hexdigest()[:24]


# -- binder -------------------------------------------------------------------

class BindError(Exception):
    pass


_EPOCH = np.datetime64("1970-01-01")


def _date_to_int(s: str) -> int:
    return int((np.datetime64(s) - _EPOCH).astype(int))


def _shift_date(days: int, n: int, unit: str, sign: int) -> int:
    d = _EPOCH + np.timedelta64(days, "D")
    if unit == "day":
        return int(((d + sign * np.timedelta64(n, "D")) - _EPOCH
                    ).astype(int))
    months = {"year": 12 * n, "month": n}[unit]
    m = d.astype("datetime64[M]") + sign * np.timedelta64(months, "M")
    frac = (d - d.astype("datetime64[M]").astype("datetime64[D]"))
    return int(((m.astype("datetime64[D]") + frac) - _EPOCH).astype(int))


class Binder:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    # .. column/typing helpers ..
    def _table_schema(self, table: str) -> Schema:
        meta = self.catalog.table(table)
        return {c.name: ColType(c.kind, c.dtype, c.dictionary)
                for c in meta.schema}

    def bind(self, stmt: ast.SelectStmt) -> tuple[LNode, Schema]:
        tables = list(stmt.tables) + [j.table for j in stmt.joins]
        for t in tables:
            self.catalog.table(t)  # existence check
        schemas = {t: self._table_schema(t) for t in tables}
        col_home: dict[str, str] = {}
        for t in tables:
            for c in schemas[t]:
                if c in col_home:
                    raise BindError(f"ambiguous column {c}")
                col_home[c] = t

        env: Schema = {}
        for t in tables:
            env.update(schemas[t])

        def fold(e: ast.Expr) -> ast.Expr:
            return map_fold(e, env)

        # Split WHERE into join edges and filters.
        where = fold(stmt.where) if stmt.where is not None else None
        join_edges: list[tuple[str, str, str, str]] = []
        filters: list[ast.Expr] = []
        for c in ast.conjuncts(where):
            edge = self._as_join_edge(c, col_home)
            if edge is not None:
                join_edges.append(edge)
            else:
                filters.append(c)
        for j in stmt.joins:
            edge = self._as_join_edge(fold(j.on), col_home)
            if edge is None:
                raise BindError(f"JOIN ON must be col = col: {j.on}")
            join_edges.append(edge)

        plan = self._plan_joins(tables, schemas, col_home, join_edges,
                                filters)

        # Aggregation / projection.
        group_cols = []
        for g in stmt.group_by:
            if not isinstance(g, ast.Col):
                raise BindError("GROUP BY supports plain columns only")
            if g.name not in env:
                raise BindError(f"unknown group column {g.name}")
            group_cols.append(g.name)

        out_names: list[str] = []
        out_exprs: list[ast.Expr] = []
        for i, item in enumerate(stmt.items):
            e = fold(item.expr)
            name = item.alias or (e.name if isinstance(e, ast.Col)
                                  else f"col{i}")
            out_names.append(name)
            out_exprs.append(e)

        agg_terms: list[ast.Agg] = []
        for e in out_exprs:
            agg_terms.extend(a for a in ast.collect_aggs(e)
                             if a.key() not in
                             [x.key() for x in agg_terms])

        out_schema: Schema = {}
        if agg_terms or group_cols:
            # avg → sum/count decomposition for distributed merging
            phys_aggs: list[tuple[str, str, ast.Expr | None]] = []

            def agg_slot(a: ast.Agg) -> ast.Expr:
                if a.fn == "avg":
                    s = _intern(phys_aggs, "sum", a.arg)
                    c = _intern(phys_aggs, "count", a.arg)
                    return ast.BinOp("/", ast.Col(s), ast.Col(c))
                return ast.Col(_intern(phys_aggs, a.fn, a.arg))

            def replace_aggs(e: ast.Expr) -> ast.Expr:
                return ast.map_expr(
                    e, lambda n: agg_slot(n) if isinstance(n, ast.Agg)
                    else n)

            final_exprs = [replace_aggs(e) for e in out_exprs]
            plan = LAggregate(plan, tuple(group_cols), tuple(phys_aggs))
            agg_env: Schema = {c: env[c] for c in group_cols}
            for name, fn, arg in phys_aggs:
                agg_env[name] = ColType("num", "<f8" if fn != "count"
                                        else "<i8")
            out_schema = {}
            exprs = []
            for name, e in zip(out_names, final_exprs):
                exprs.append((name, e))
                out_schema[name] = _expr_type(e, agg_env)
            plan = LProject(plan, tuple(exprs))
        else:
            exprs = list(zip(out_names, out_exprs))
            plan = LProject(plan, tuple(exprs))
            out_schema = {n: _expr_type(e, env) for n, e in exprs}

        if stmt.order_by:
            keys = []
            for o in stmt.order_by:
                e = fold(o.expr)
                if isinstance(e, ast.Col) and e.name in out_schema:
                    keys.append((e.name, o.desc))
                else:
                    raise BindError("ORDER BY must reference output columns")
            plan = LSort(plan, tuple(keys))
        if stmt.limit is not None:
            plan = LLimit(plan, stmt.limit)
        return plan, out_schema

    # .. join graph ..
    def _as_join_edge(self, e: ast.Expr, col_home: dict[str, str]):
        if (isinstance(e, ast.Cmp) and e.op == "="
                and isinstance(e.left, ast.Col)
                and isinstance(e.right, ast.Col)):
            lt, rt = col_home.get(e.left.name), col_home.get(e.right.name)
            if lt is None or rt is None:
                raise BindError(f"unknown column in {e}")
            if lt != rt:
                return (lt, e.left.name, rt, e.right.name)
        return None

    def _plan_joins(self, tables, schemas, col_home, join_edges, filters):
        # Per-table filter pushdown happens here (pre-optimizer) simply by
        # attaching filters to their home scan; the rule optimizer handles
        # the general (post-join) case.
        table_filters: dict[str, list[ast.Expr]] = {t: [] for t in tables}
        cross_filters: list[ast.Expr] = []
        for f in filters:
            home = {col_home[c] for c in ast.collect_columns(f)
                    if c in col_home}
            if len(home) == 1:
                table_filters[next(iter(home))].append(f)
            else:
                cross_filters.append(f)

        def scan(t: str) -> LNode:
            node: LNode = LScan(t, tuple(schemas[t].keys()))
            pred = ast.make_and(table_filters[t])
            if pred is not None:
                node = LFilter(node, pred)
            return node

        if len(tables) == 1:
            plan = scan(tables[0])
        else:
            # Greedy: start from the largest table (fact side), repeatedly
            # join a connected table; build side key must be its PK.
            sizes = {t: self.catalog.table(t).rows for t in tables}
            edges = list(join_edges)
            current = max(tables, key=lambda t: sizes[t])
            joined = {current}
            plan = scan(current)
            while len(joined) < len(tables):
                cand = None
                for e in edges:
                    lt, lk, rt, rk = e
                    if lt in joined and rt not in joined:
                        cand = (rt, lk, rk, e)
                    elif rt in joined and lt not in joined:
                        cand = (lt, rk, lk, e)
                    else:
                        continue
                    break
                if cand is None:
                    raise BindError("join graph is disconnected")
                new_t, probe_key, build_key, e = cand
                if PRIMARY_KEYS.get(new_t) != build_key:
                    raise BindError(
                        f"build side {new_t}.{build_key} is not a PK "
                        "(only FK→PK joins are supported)")
                plan = LJoin(plan, scan(new_t), probe_key, build_key)
                joined.add(new_t)
                edges.remove(e)
            # surviving edges are extra equality constraints → filters
            for lt, lk, rt, rk in edges:
                cross_filters.append(ast.Cmp("=", ast.Col(lk), ast.Col(rk)))
        pred = ast.make_and(cross_filters)
        if pred is not None:
            plan = LFilter(plan, pred)
        return plan


def _intern(phys_aggs: list, fn: str, arg: ast.Expr | None) -> str:
    for name, f, a in phys_aggs:
        if f == fn and ((a is None and arg is None)
                        or (a is not None and arg is not None
                            and a.key() == arg.key())):
            return name
    name = f"_agg{len(phys_aggs)}"
    phys_aggs.append((name, fn, arg))
    return name


def _expr_type(e: ast.Expr, env: Schema) -> ColType:
    if isinstance(e, ast.Col):
        if e.name not in env:
            raise BindError(f"unknown column {e.name}")
        return env[e.name]
    if isinstance(e, ast.Lit):
        if e.kind == "date":
            return ColType("num", "<i4")
        if e.kind == "str":
            return ColType("bytes", "S32")
        return ColType("num", "<i8" if isinstance(e.value, int) else "<f8")
    if isinstance(e, (ast.Cmp, ast.And, ast.Or, ast.Not, ast.Between,
                      ast.InList, ast.Like)):
        return ColType("num", "|b1")
    if isinstance(e, ast.BinOp):
        lt = _expr_type(e.left, env)
        rt = _expr_type(e.right, env)
        if e.op == "/" or "f" in lt.dtype or "f" in rt.dtype:
            return ColType("num", "<f8")
        return ColType("num", "<i8")
    if isinstance(e, ast.Case):
        return _expr_type(e.then, env)
    if isinstance(e, ast.Agg):
        return ColType("num", "<i8" if e.fn == "count" else "<f8")
    raise BindError(f"cannot type {e}")


# -- constant folding & dictionary rewriting ----------------------------------

def map_fold(e: ast.Expr, env: Schema) -> ast.Expr:
    """Fold dates/intervals/constants and rewrite dict-column literals."""

    def fold_node(n: ast.Expr) -> ast.Expr:
        if isinstance(n, ast.Lit) and n.kind == "date":
            return ast.Lit(_date_to_int(n.value), "num")
        if isinstance(n, ast.BinOp) and isinstance(n.right, ast.Lit) \
                and n.right.kind == "interval":
            if not (isinstance(n.left, ast.Lit) and n.left.kind == "num"):
                raise BindError("interval arithmetic needs a date literal")
            nval, unit = n.right.value
            sign = 1 if n.op == "+" else -1
            return ast.Lit(_shift_date(n.left.value, nval, unit, sign),
                           "num")
        if isinstance(n, ast.BinOp) and isinstance(n.left, ast.Lit) \
                and isinstance(n.right, ast.Lit) \
                and n.left.kind == "num" and n.right.kind == "num":
            a, b = n.left.value, n.right.value
            v = {"+": a + b, "-": a - b, "*": a * b,
                 "/": a / b if b else 0.0}[n.op]
            return ast.Lit(v, "num")
        if isinstance(n, ast.Cmp):
            rewritten = _rewrite_dict_cmp(n, env)
            if rewritten is not None:
                return rewritten
        if isinstance(n, ast.InList):
            rewritten = _rewrite_dict_in(n, env)
            if rewritten is not None:
                return rewritten
        if isinstance(n, ast.Like):
            return _rewrite_like(n, env)
        if isinstance(n, ast.Between):
            return ast.And((ast.Cmp(">=", n.term, n.lo),
                            ast.Cmp("<=", n.term, n.hi)))
        return n

    return ast.map_expr(e, fold_node)


def _dict_code(ct: ColType, value: str) -> int:
    try:
        return ct.dictionary.index(value)
    except ValueError:
        return -1  # never matches


def _rewrite_dict_cmp(n: ast.Cmp, env: Schema):
    for a, b, flip in ((n.left, n.right, False), (n.right, n.left, True)):
        if isinstance(a, ast.Col) and isinstance(b, ast.Lit) \
                and b.kind == "str" and a.name in env \
                and env[a.name].kind == "dict":
            if n.op not in ("=", "<>"):
                raise BindError(
                    f"only =/<> comparisons on dict column {a.name}")
            code = _dict_code(env[a.name], b.value)
            return ast.Cmp(n.op, a, ast.Lit(code, "num"))
    return None


def _rewrite_dict_in(n: ast.InList, env: Schema):
    if isinstance(n.term, ast.Col) and n.term.name in env \
            and env[n.term.name].kind == "dict":
        codes = []
        for v in n.values:
            if not (isinstance(v, ast.Lit) and v.kind == "str"):
                raise BindError("IN list on dict column must be strings")
            codes.append(ast.Lit(_dict_code(env[n.term.name], v.value),
                                 "num"))
        return ast.InList(n.term, tuple(codes))
    return None


def _rewrite_like(n: ast.Like, env: Schema) -> ast.Expr:
    if not (isinstance(n.term, ast.Col) and n.term.name in env
            and env[n.term.name].kind == "dict"):
        raise BindError("LIKE is supported on dictionary columns only")
    pattern = n.pattern.replace("%", "*").replace("_", "?")
    ct = env[n.term.name]
    codes = [i for i, v in enumerate(ct.dictionary)
             if fnmatch.fnmatchcase(v, pattern)]
    if not codes:
        return ast.Cmp("=", ast.Lit(0, "num"), ast.Lit(1, "num"))
    return ast.InList(n.term, tuple(ast.Lit(c, "num") for c in codes))
