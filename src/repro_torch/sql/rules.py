"""Rule-based logical optimizer (paper section 3.2).

Conventional heuristics oblivious of the serverless execution environment:
predicate pushdown, projection pruning, and trivial-filter elimination.
Join ordering happens during binding (greedy, FK→PK); subquery flattening
is unnecessary for the supported grammar.
"""

from __future__ import annotations

import dataclasses

from repro_torch.sql import ast
from repro_torch.sql.logical import (LAggregate, LFilter, LJoin, LLimit, LNode,
                               LProject, LScan, LSort)


def _columns_of(node: LNode) -> set[str]:
    """Output columns of a logical node."""
    if isinstance(node, LScan):
        return set(node.schema_cols)
    if isinstance(node, LFilter):
        return _columns_of(node.child)
    if isinstance(node, LProject):
        return {n for n, _ in node.exprs}
    if isinstance(node, LJoin):
        return _columns_of(node.left) | _columns_of(node.right)
    if isinstance(node, LAggregate):
        return set(node.group_cols) | {n for n, _, _ in node.aggs}
    if isinstance(node, (LSort, LLimit)):
        return _columns_of(node.child)
    raise TypeError(node)


def _ordered_columns_of(node: LNode) -> list[str]:
    """Output columns in *schema* order — LScan's tuple order is the
    catalog's column order (keys first), so callers that must keep "one
    arbitrary column" alive pick deterministically, and pick a key
    column rather than whatever a hash-randomized set yields first
    (string-typed payload columns cannot enter an XLA block)."""
    if isinstance(node, LScan):
        return list(node.schema_cols)
    if isinstance(node, (LFilter, LSort, LLimit)):
        return _ordered_columns_of(node.child)
    if isinstance(node, LProject):
        return [n for n, _ in node.exprs]
    if isinstance(node, LJoin):
        return (_ordered_columns_of(node.left)
                + _ordered_columns_of(node.right))
    if isinstance(node, LAggregate):
        return list(node.group_cols) + [n for n, _, _ in node.aggs]
    raise TypeError(node)


# -- rule: predicate pushdown -------------------------------------------------

def _subst_cols(e: ast.Expr, mapping: dict[str, str]) -> ast.Expr:
    """Rewrite column references through a rename map (frozen dataclass
    expressions are rebuilt bottom-up)."""
    if isinstance(e, ast.Col):
        return ast.Col(mapping.get(e.name, e.name))
    if not e.children():
        return e
    kw = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Expr):
            kw[f.name] = _subst_cols(v, mapping)
        elif isinstance(v, tuple) and v and isinstance(v[0], ast.Expr):
            kw[f.name] = tuple(_subst_cols(x, mapping) for x in v)
        else:
            kw[f.name] = v
    return type(e)(**kw)


def push_filters(node: LNode) -> LNode:
    if isinstance(node, LFilter):
        child = push_filters(node.child)
        terms = ast.conjuncts(node.pred)
        if isinstance(child, LJoin):
            left_cols = _columns_of(child.left)
            right_cols = _columns_of(child.right)
            to_left, to_right, stay = [], [], []
            for t in terms:
                cols = set(ast.collect_columns(t))
                if cols <= left_cols:
                    to_left.append(t)
                elif cols <= right_cols:
                    to_right.append(t)
                else:
                    stay.append(t)
            left, right = child.left, child.right
            if to_left:
                left = push_filters(
                    LFilter(left, ast.make_and(to_left)))
            if to_right:
                right = push_filters(
                    LFilter(right, ast.make_and(to_right)))
            out: LNode = LJoin(left, right, child.left_key, child.right_key)
            if stay:
                out = LFilter(out, ast.make_and(stay))
            return out
        if isinstance(child, LProject):
            # Push terms below pure column-rename projections: per-row
            # renames create/delete no rows, so the filter commutes once
            # its column references are mapped to pre-projection names.
            # This exposes build-side selectivity to the scan (zone-map
            # pruning and row estimates feeding the semi-join cost gate).
            rename = {n: e.name for n, e in child.exprs
                      if isinstance(e, ast.Col)}
            down, stay = [], []
            for t in terms:
                if set(ast.collect_columns(t)) <= set(rename):
                    down.append(_subst_cols(t, rename))
                else:
                    stay.append(t)
            if down:
                inner = push_filters(
                    LFilter(child.child, ast.make_and(down)))
                out = LProject(inner, child.exprs)
                if stay:
                    return LFilter(out, ast.make_and(stay))
                return out
        if isinstance(child, LFilter):
            merged = ast.make_and(ast.conjuncts(child.pred) + terms)
            return push_filters(LFilter(child.child, merged))
        return LFilter(child, node.pred)
    if isinstance(node, LProject):
        return LProject(push_filters(node.child), node.exprs)
    if isinstance(node, LJoin):
        return LJoin(push_filters(node.left), push_filters(node.right),
                     node.left_key, node.right_key)
    if isinstance(node, LAggregate):
        return LAggregate(push_filters(node.child), node.group_cols,
                          node.aggs)
    if isinstance(node, LSort):
        return LSort(push_filters(node.child), node.keys)
    if isinstance(node, LLimit):
        return LLimit(push_filters(node.child), node.n)
    return node


# -- rule: projection pruning -------------------------------------------------

def prune_columns(node: LNode, needed: set[str] | None = None) -> LNode:
    """Top-down pass narrowing scans to the transitively required columns."""
    if needed is None:
        needed = _columns_of(node)

    if isinstance(node, LScan):
        cols = tuple(c for c in node.schema_cols if c in needed)
        return LScan(node.table, cols)
    if isinstance(node, LFilter):
        child_needed = needed | set(ast.collect_columns(node.pred))
        return LFilter(prune_columns(node.child, child_needed), node.pred)
    if isinstance(node, LProject):
        kept = tuple((n, e) for n, e in node.exprs if n in needed)
        kept = kept or node.exprs[:1]
        child_needed = set()
        for _, e in kept:
            child_needed |= set(ast.collect_columns(e))
        return LProject(prune_columns(node.child, child_needed), kept)
    if isinstance(node, LJoin):
        need = set(needed) | {node.left_key, node.right_key}
        left_cols = _columns_of(node.left)
        right_cols = _columns_of(node.right)
        return LJoin(prune_columns(node.left, need & left_cols),
                     prune_columns(node.right, need & right_cols),
                     node.left_key, node.right_key)
    if isinstance(node, LAggregate):
        child_needed = set(node.group_cols)
        for _, _, arg in node.aggs:
            if arg is not None:
                child_needed |= set(ast.collect_columns(arg))
        if not child_needed:
            # count(*) over no columns: keep one column alive — the
            # schema-order first (a key column), deterministically
            child_needed = set(_ordered_columns_of(node.child)[:1])
        return LAggregate(prune_columns(node.child, child_needed),
                          node.group_cols, node.aggs)
    if isinstance(node, LSort):
        child_needed = needed | {k for k, _ in node.keys}
        return LSort(prune_columns(node.child, child_needed), node.keys)
    if isinstance(node, LLimit):
        return LLimit(prune_columns(node.child, needed), node.n)
    raise TypeError(node)


# -- rule: trivial filter elimination ------------------------------------------

def _is_true(e: ast.Expr) -> bool:
    return isinstance(e, ast.Lit) and bool(e.value)


def drop_trivial_filters(node: LNode) -> LNode:
    if isinstance(node, LFilter):
        child = drop_trivial_filters(node.child)
        terms = [t for t in ast.conjuncts(node.pred) if not _is_true(t)]
        if not terms:
            return child
        return LFilter(child, ast.make_and(terms))
    if isinstance(node, LProject):
        return LProject(drop_trivial_filters(node.child), node.exprs)
    if isinstance(node, LJoin):
        return LJoin(drop_trivial_filters(node.left),
                     drop_trivial_filters(node.right),
                     node.left_key, node.right_key)
    if isinstance(node, LAggregate):
        return LAggregate(drop_trivial_filters(node.child), node.group_cols,
                          node.aggs)
    if isinstance(node, LSort):
        return LSort(drop_trivial_filters(node.child), node.keys)
    if isinstance(node, LLimit):
        return LLimit(drop_trivial_filters(node.child), node.n)
    return node


def optimize(plan: LNode) -> LNode:
    """Apply the rule set to fixpoint (bounded)."""
    for _ in range(4):
        new = drop_trivial_filters(prune_columns(push_filters(plan)))
        if new.key() == plan.key():
            return new
        plan = new
    return plan
