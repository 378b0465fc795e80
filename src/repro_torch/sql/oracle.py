"""Single-node numpy reference engine ("oracle") over logical plans.

Used by tests and benchmarks to validate the distributed serverless engine:
both engines evaluate the same bound + optimized LQP, so any divergence is
an execution bug, not a semantics mismatch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sql import ast
from repro_torch.sql.logical import (LAggregate, LFilter, LJoin, LLimit, LNode,
                               LProject, LScan, LSort)

Table = dict[str, np.ndarray]


def eval_expr(e: ast.Expr, cols: Table) -> np.ndarray:
    if isinstance(e, ast.Col):
        return cols[e.name]
    if isinstance(e, ast.Lit):
        return np.asarray(e.value)
    if isinstance(e, ast.BinOp):
        a, b = eval_expr(e.left, cols), eval_expr(e.right, cols)
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        if e.op == "/":
            return a / b
    if isinstance(e, ast.Cmp):
        a, b = eval_expr(e.left, cols), eval_expr(e.right, cols)
        return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
                "=": a == b, "<>": a != b}[e.op]
    if isinstance(e, ast.And):
        out = eval_expr(e.terms[0], cols)
        for t in e.terms[1:]:
            out = out & eval_expr(t, cols)
        return out
    if isinstance(e, ast.Or):
        out = eval_expr(e.terms[0], cols)
        for t in e.terms[1:]:
            out = out | eval_expr(t, cols)
        return out
    if isinstance(e, ast.Not):
        return ~eval_expr(e.term, cols)
    if isinstance(e, ast.Case):
        c = eval_expr(e.cond, cols)
        return np.where(c, eval_expr(e.then, cols),
                        eval_expr(e.orelse, cols))
    if isinstance(e, ast.InList):
        t = eval_expr(e.term, cols)
        out = np.zeros(t.shape, bool)
        for v in e.values:
            out |= (t == eval_expr(v, cols))
        return out
    raise TypeError(f"oracle cannot evaluate {e}")


def run(plan: LNode, tables: dict[str, Table]) -> Table:
    if isinstance(plan, LScan):
        t = tables[plan.table]
        return {c: t[c] for c in plan.schema_cols}
    if isinstance(plan, LFilter):
        t = run(plan.child, tables)
        mask = eval_expr(plan.pred, t)
        return {c: v[mask] for c, v in t.items()}
    if isinstance(plan, LProject):
        t = run(plan.child, tables)
        out = {}
        for name, e in plan.exprs:
            v = eval_expr(e, t)
            if v.ndim == 0:
                n = len(next(iter(t.values()))) if t else 1
                v = np.broadcast_to(v, (n,)).copy()
            out[name] = v
        return out
    if isinstance(plan, LJoin):
        left = run(plan.left, tables)
        right = run(plan.right, tables)
        bkeys = right[plan.right_key]
        order = np.argsort(bkeys, kind="stable")
        skeys = bkeys[order]
        probe = left[plan.left_key]
        pos = np.searchsorted(skeys, probe)
        pos_c = np.clip(pos, 0, max(len(skeys) - 1, 0))
        hit = (len(skeys) > 0) & (skeys[pos_c] == probe)
        out = {c: v[hit] for c, v in left.items()}
        sel = order[pos_c[hit]]
        for c, v in right.items():
            if c not in out:
                out[c] = v[sel]
        return out
    if isinstance(plan, LAggregate):
        t = run(plan.child, tables)
        n = len(next(iter(t.values()))) if t else 0
        if plan.group_cols:
            keys = np.stack([t[c] for c in plan.group_cols], axis=1)
            uniq, inv = np.unique(keys, axis=0, return_inverse=True)
            g = uniq.shape[0]
        else:
            uniq = None
            inv = np.zeros(n, dtype=np.int64)
            g = 1
        out: Table = {}
        if uniq is not None:
            for i, c in enumerate(plan.group_cols):
                out[c] = uniq[:, i].astype(t[c].dtype)
        for name, fn, arg in plan.aggs:
            if fn == "count":
                vals = np.ones(n)
            else:
                vals = eval_expr(arg, t).astype(np.float64)
                if vals.ndim == 0:
                    vals = np.broadcast_to(vals, (n,)).copy()
            if fn in ("sum", "count"):
                r = np.bincount(inv, weights=vals, minlength=g)
                out[name] = r.astype(np.int64) if fn == "count" else r
            elif fn == "min":
                r = np.full(g, np.inf)
                np.minimum.at(r, inv, vals)
                out[name] = r
            elif fn == "max":
                r = np.full(g, -np.inf)
                np.maximum.at(r, inv, vals)
                out[name] = r
            else:
                raise TypeError(fn)
        return out
    if isinstance(plan, LSort):
        t = run(plan.child, tables)
        keys = []
        for name, desc in reversed(plan.keys):
            k = t[name]
            keys.append(-k if desc else k)
        order = np.lexsort(keys) if keys else np.arange(0)
        return {c: v[order] for c, v in t.items()}
    if isinstance(plan, LLimit):
        t = run(plan.child, tables)
        return {c: v[:plan.n] for c, v in t.items()}
    raise TypeError(plan)
