"""AST expression → torch evaluator compilation, plus expression
(de)serialization for shipping fragment plans to workers as JSON-able
payloads (the paper serializes PQP fragments into function invocation
payloads, section 3.3).

Promotion: the reference runs under JAX with x64, where a Python float
literal is weakly typed and ``int64 / int64`` is float64. Torch promotes a
Python float against an int64 tensor to float32, and ``int / int`` to
float32 too. So literals become 0-dim int64/float64 tensors on the
columns' device (a 0-dim float64 tensor lifts an integer column to
float64, and leaves a float column's width alone, as a weak JAX literal
does), and ``/`` of two integer operands divides in float64 when they
promote to int64 and in float32 otherwise (``int32 / 7`` is float32 in
JAX too), and by a literal as ``x * (1 / c)``, as the jitted reference
runs it: ``kernels.common.true_divide``, the rule the kernel programs
share.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import true_divide
from repro_torch.sql import ast


def _device_of(cols) -> torch.device:
    for v in cols.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _literal(value):
    """Closure returning ``value`` as a 0-dim tensor on the columns'
    device (cached per device: a host→device copy per call would stall
    the fragment's stream)."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return lambda cols: value
    dtype = torch.int64 if isinstance(value, int) else torch.float64
    cache: dict = {}

    def lit(cols):
        dev = _device_of(cols)
        t = cache.get(dev)
        if t is None:
            t = cache[dev] = torch.tensor(value, dtype=dtype, device=dev)
        return t
    return lit


def compile_expr(e: ast.Expr):
    """Compile to a function of a column dict (values: torch tensors)."""
    if isinstance(e, ast.Col):
        name = e.name
        return lambda cols: cols[name]
    if isinstance(e, ast.Lit):
        return _literal(e.value)
    if isinstance(e, ast.BinOp):
        lf, rf = compile_expr(e.left), compile_expr(e.right)
        op = e.op
        if op == "+":
            return lambda cols: lf(cols) + rf(cols)
        if op == "-":
            return lambda cols: lf(cols) - rf(cols)
        if op == "*":
            return lambda cols: lf(cols) * rf(cols)
        if op == "/":
            return lambda cols: true_divide(lf(cols), rf(cols))
        raise ValueError(op)
    if isinstance(e, ast.Cmp):
        lf, rf = compile_expr(e.left), compile_expr(e.right)
        op = e.op
        if op == "<":
            return lambda cols: lf(cols) < rf(cols)
        if op == "<=":
            return lambda cols: lf(cols) <= rf(cols)
        if op == ">":
            return lambda cols: lf(cols) > rf(cols)
        if op == ">=":
            return lambda cols: lf(cols) >= rf(cols)
        if op == "=":
            return lambda cols: lf(cols) == rf(cols)
        if op == "<>":
            return lambda cols: lf(cols) != rf(cols)
        raise ValueError(op)
    if isinstance(e, ast.And):
        fns = [compile_expr(t) for t in e.terms]

        def _and(cols):
            out = fns[0](cols)
            for f in fns[1:]:
                out = out & f(cols)
            return out
        return _and
    if isinstance(e, ast.Or):
        fns = [compile_expr(t) for t in e.terms]

        def _or(cols):
            out = fns[0](cols)
            for f in fns[1:]:
                out = out | f(cols)
            return out
        return _or
    if isinstance(e, ast.Not):
        f = compile_expr(e.term)
        return lambda cols: ~f(cols)
    if isinstance(e, ast.Case):
        cf, tf, of = (compile_expr(e.cond), compile_expr(e.then),
                      compile_expr(e.orelse))
        return lambda cols: torch.where(cf(cols), tf(cols), of(cols))
    if isinstance(e, ast.InList):
        tf = compile_expr(e.term)
        vfs = [compile_expr(v) for v in e.values]

        def _in(cols):
            t = tf(cols)
            out = (t == vfs[0](cols))
            for v in vfs[1:]:
                out = out | (t == v(cols))
            return out
        return _in
    raise TypeError(f"cannot compile {e}")


# -- serialization ------------------------------------------------------------

def expr_to_dict(e: ast.Expr) -> dict:
    if isinstance(e, ast.Col):
        return {"t": "col", "name": e.name}
    if isinstance(e, ast.Lit):
        return {"t": "lit", "value": e.value, "kind": e.kind}
    if isinstance(e, ast.BinOp):
        return {"t": "bin", "op": e.op, "l": expr_to_dict(e.left),
                "r": expr_to_dict(e.right)}
    if isinstance(e, ast.Cmp):
        return {"t": "cmp", "op": e.op, "l": expr_to_dict(e.left),
                "r": expr_to_dict(e.right)}
    if isinstance(e, ast.And):
        return {"t": "and", "terms": [expr_to_dict(t) for t in e.terms]}
    if isinstance(e, ast.Or):
        return {"t": "or", "terms": [expr_to_dict(t) for t in e.terms]}
    if isinstance(e, ast.Not):
        return {"t": "not", "term": expr_to_dict(e.term)}
    if isinstance(e, ast.Case):
        return {"t": "case", "cond": expr_to_dict(e.cond),
                "then": expr_to_dict(e.then),
                "else": expr_to_dict(e.orelse)}
    if isinstance(e, ast.InList):
        return {"t": "in", "term": expr_to_dict(e.term),
                "values": [expr_to_dict(v) for v in e.values]}
    raise TypeError(f"cannot serialize {e}")


def expr_from_dict(d: dict) -> ast.Expr:
    t = d["t"]
    if t == "col":
        return ast.Col(d["name"])
    if t == "lit":
        return ast.Lit(d["value"], d["kind"])
    if t == "bin":
        return ast.BinOp(d["op"], expr_from_dict(d["l"]),
                         expr_from_dict(d["r"]))
    if t == "cmp":
        return ast.Cmp(d["op"], expr_from_dict(d["l"]),
                       expr_from_dict(d["r"]))
    if t == "and":
        return ast.And(tuple(expr_from_dict(x) for x in d["terms"]))
    if t == "or":
        return ast.Or(tuple(expr_from_dict(x) for x in d["terms"]))
    if t == "not":
        return ast.Not(expr_from_dict(d["term"]))
    if t == "case":
        return ast.Case(expr_from_dict(d["cond"]),
                        expr_from_dict(d["then"]),
                        expr_from_dict(d["else"]))
    if t == "in":
        return ast.InList(expr_from_dict(d["term"]),
                          tuple(expr_from_dict(v) for v in d["values"]))
    raise TypeError(t)
