"""Expression programs the scan-aggregate kernels execute.

The Pallas kernels of the reference evaluate the predicate, the
aggregate arguments and the group id as jnp closures traced into the
kernel body. A CUDA kernel built once by ``nvcc`` cannot take a Python
closure, so each expression dict compiles to a small postfix program:
int32 (opcode, argument) pairs plus a float64 constant pool. The kernel
interprets the program per row in float64, with booleans as 0/1; one
binary then serves every query shape.

Result types: the reference's jnp arithmetic gives float32 where both
operands of ``/`` are integers narrower than int64 (``int32 / 7``), and
float32 stays float32 under weak-typed literals. The plan does not know
column dtypes, so :meth:`Program.specialise` runs a host-side type pass
at launch, with the columns' dtypes: it follows the promotion of the
generic torch path (``exec.expr``, checked against jnp dtype for dtype)
and inserts an ``F32`` rounding after every operand and result the
reference computes in float32. Float32 add, sub, mul and div of
f32-rounded operands, done in f64 and rounded once, equal the float32
operation, so the kernel stays an f64 interpreter. Division by a
literal becomes multiplication by its reciprocal in the result type, as
XLA compiles the reference's jitted ``x / c`` (and as ``exec.expr``
does). Specialised programs are cached per dtype tuple.

Join programs read some columns on the build side: a column is either a
probe column, read at the probe row, or a build payload column, read at
the row's hit position (``Program.gathered``, fixed at launch from the
blocks the kernel is given).

A program holds the slots of one fused kernel call: slot 0 is the
predicate (empty: every valid row passes), slot 1 the mixed-radix group
id (empty for the ungrouped kernel), then one slot per aggregate
argument (empty for ``count``). A join program may add one slot after
them, the probe predicate (``probe_preds``: the conjunction of the
probe side's own filters, which read probe columns only); the join
kernel runs it before its key search, and slot 0 then holds only the
residual predicates over the joined row. Column values must stay below
2**53 to be exact in float64; TPC-H keys stay below 6.1e9 up to SF 1000.

:func:`eval_slot` is the plain torch evaluation of the same program,
vectorised with a stack of tensors: the kernels' plain versions use it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import divides_by_reciprocal, reciprocal, \
    true_divide

# opcodes (keep in step with csrc/scan_agg.cuh)
COL, CONST, ADD, SUB, MUL, DIV = 0, 1, 2, 3, 4, 5
LT, LE, GT, GE, EQ, NE = 6, 7, 8, 9, 10, 11
AND, OR, NOT, CASE, IN, TRUNC = 12, 13, 14, 15, 16, 17
F32 = 18                # round the top of the stack through float32

_BIN = {"+": ADD, "-": SUB, "*": MUL, "/": DIV}
_CMP = {"<": LT, "<=": LE, ">": GT, ">=": GE, "=": EQ, "<>": NE}
# arity of each opcode: values popped, values pushed is always 1
_POPS = {COL: 0, CONST: 0, ADD: 2, SUB: 2, MUL: 2, DIV: 2, LT: 2, LE: 2,
         GT: 2, GE: 2, EQ: 2, NE: 2, AND: 2, OR: 2, NOT: 1, CASE: 3,
         IN: 1, TRUNC: 1, F32: 1}

# aggregate function codes
AGG_CODES = {"sum": 0, "count": 1, "min": 2, "max": 3}

MAX_STACK = 16          # per-thread evaluation stack in the kernel
MAX_COLS = 16           # column pointers passed by value to the kernel
MAX_AGGS = 32           # per-thread accumulators in the ungrouped kernel

# torch dtype → column type code read by the kernel
DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.int64: 2,
               torch.int32: 3, torch.int16: 4, torch.int8: 5,
               torch.uint8: 6, torch.bool: 6}


class ProgramError(ValueError):
    """An expression the kernel interpreter cannot run (miss reason)."""


@dataclasses.dataclass(frozen=True)
class Program:
    names: tuple[str, ...]       # columns, in kernel pointer order
    code: np.ndarray             # int32 (opcode, arg) pairs
    consts: np.ndarray           # float64 constant pool
    slots: np.ndarray            # int32 pair offsets, len n_slots + 1
    fns: tuple[str, ...]         # aggregate fns, one per agg slot
    n_groups: int                # 0: ungrouped
    depth: int                   # max stack depth the program needs
    const_int: tuple[bool, ...] = ()   # literal was an int (weak int)
    # a join program's probe-predicate slot follows the aggregates
    probe_pred: bool = False
    # set by specialise(): the column dtypes the program is typed for,
    # and which columns the join kernel reads on the build side
    dtypes: tuple | None = None
    gathered: tuple[bool, ...] = ()
    _device: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)
    _variants: dict = dataclasses.field(default_factory=dict,
                                        compare=False, repr=False)

    @property
    def n_aggs(self) -> int:
        return len(self.fns)

    @property
    def has_pred(self) -> bool:
        return self.slots[1] > self.slots[0]

    @property
    def probe_slot(self) -> int | None:
        """The probe-predicate slot, if the program has one."""
        return 2 + self.n_aggs if self.probe_pred else None

    @property
    def has_probe_pred(self) -> bool:
        s = self.probe_slot
        return s is not None and self.n_ops(s) > 0

    def slot_columns(self, s: int) -> set[str]:
        lo, hi = self.slot_range(s)
        return {self.names[arg] for op, arg in self.code[lo:hi].tolist()
                if op == COL}

    def slot_range(self, s: int) -> tuple[int, int]:
        return int(self.slots[s]), int(self.slots[s + 1])

    def n_ops(self, s: int) -> int:
        lo, hi = self.slot_range(s)
        return hi - lo

    def specialise(self, dtypes: tuple, gathered: tuple = ()) -> Program:
        """This program typed for column ``dtypes`` (one per name) and,
        for the join kernel, with the build-side columns ``gathered``:
        ``F32`` roundings inserted where the reference computes in
        float32 (see the module docstring). Cached per argument tuple."""
        key = (tuple(dtypes), tuple(gathered))
        if self.dtypes is not None:     # typed already: the dtypes agree
            if key[0] == self.dtypes:   # (gathered columns, once read,
                return self             # are plain columns)
            raise ValueError(f"program typed for {self.dtypes}, "
                             f"not {key[0]}")
        typed = self._variants.get(key)
        if typed is None:
            if self.has_probe_pred and any(
                    g for n, g in zip(self.names, key[1])
                    if n in self.slot_columns(self.probe_slot)):
                raise ValueError("the probe predicate reads a build-side "
                                 "column")
            code, consts, slots = _type_pass(self, key[0])
            typed = dataclasses.replace(
                self, code=code, consts=consts, slots=slots,
                dtypes=key[0], gathered=key[1], _device={}, _variants={})
            typed = self._variants.setdefault(key, typed)
        return typed

    def device_arrays(self, device: torch.device):
        """(code, consts, slots, fns) on ``device``, uploaded once per
        device and kept with the program (the program cache keeps the
        program, so a fragment's launches copy nothing to the card)."""
        arrs = self._device.get(device)
        if arrs is None:
            fns = np.asarray([AGG_CODES[f] for f in self.fns] or [0],
                             np.int32)
            arrs = tuple(torch.from_numpy(a.copy()).to(device)
                         for a in (self.code.reshape(-1), self.consts,
                                   self.slots, fns))
            self._device[device] = arrs
        return arrs


class _Emitter:
    def __init__(self):
        self.names: list[str] = []
        self.code: list[int] = []
        self.consts: list[float] = []
        self.const_int: list[bool] = []

    def const(self, v) -> int:
        self.consts.append(float(v))
        self.const_int.append(isinstance(v, int))
        return len(self.consts) - 1

    def op(self, opcode: int, arg: int = 0) -> None:
        self.code += [opcode, arg]

    def col(self, name: str) -> None:
        if name not in self.names:
            if len(self.names) >= MAX_COLS:
                raise ProgramError(f"more than {MAX_COLS} columns")
            self.names.append(name)
        self.op(COL, self.names.index(name))

    def expr(self, d: dict) -> None:
        t = d["t"]
        if t == "col":
            self.col(d["name"])
        elif t == "lit":
            v = d["value"]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ProgramError(f"literal {v!r} is not a number")
            self.op(CONST, self.const(v))
        elif t in ("bin", "cmp"):
            table = _BIN if t == "bin" else _CMP
            if d["op"] not in table:
                raise ProgramError(f"operator {d['op']!r} unsupported")
            self.expr(d["l"])
            self.expr(d["r"])
            self.op(table[d["op"]])
        elif t in ("and", "or"):
            self.expr(d["terms"][0])
            for term in d["terms"][1:]:
                self.expr(term)
                self.op(AND if t == "and" else OR)
        elif t == "not":
            self.expr(d["term"])
            self.op(NOT)
        elif t == "case":
            self.expr(d["cond"])
            self.expr(d["then"])
            self.expr(d["else"])
            self.op(CASE)
        elif t == "in":
            values = d["values"]
            if all(v["t"] == "lit" for v in values):
                for v in values:
                    if isinstance(v["value"], bool) or \
                            not isinstance(v["value"], (int, float)):
                        raise ProgramError(
                            f"literal {v['value']!r} is not a number")
                self.expr(d["term"])
                # consts[arg] = count, then the values
                at = self.const(len(values))
                for v in values:
                    self.const(v["value"])
                self.op(IN, at)
            else:   # term IN (exprs) == OR of equalities
                self.expr({"t": "or", "terms": [
                    {"t": "cmp", "op": "=", "l": d["term"], "r": v}
                    for v in values]})
        else:
            raise ProgramError(f"expression {t!r} unsupported")


def _depth(code: list[int]) -> int:
    sp = best = 0
    for i in range(0, len(code), 2):
        sp += 1 - _POPS[code[i]]
        best = max(best, sp)
    return best


def compile_program(preds: list[dict], aggs: list, *,
                    group_cols: list[str] | None = None,
                    strides: list[int] | None = None,
                    n_groups: int = 0,
                    probe_preds: list[dict] | None = None) -> Program:
    """Compile a fused kernel's expressions.

    ``preds``: predicate dicts, conjoined; ``aggs``: ``(fn, arg dict or
    None)`` pairs; ``group_cols``/``strides``: the mixed-radix group id
    sum(trunc(col) * stride), as ``exec.lower`` builds it;
    ``probe_preds`` (a join's probe-side filters, conjoined; None: no
    probe-predicate slot): the slot the join kernel runs before its key
    search. Raises :class:`ProgramError` with a miss reason for what the
    kernel cannot run.
    """
    em = _Emitter()
    bounds = [0]

    def conj(ps):
        if ps:
            em.expr(ps[0] if len(ps) == 1 else
                    {"t": "and", "terms": list(ps)})
        bounds.append(len(em.code) // 2)
    conj(preds)
    for i, (c, s) in enumerate(zip(group_cols or [], strides or [])):
        em.col(c)
        em.op(TRUNC)
        em.op(CONST, em.const(s))
        em.op(MUL)
        if i:
            em.op(ADD)
    bounds.append(len(em.code) // 2)
    if len(aggs) > MAX_AGGS:
        raise ProgramError(f"more than {MAX_AGGS} aggregates")
    for fn, arg in aggs:
        if fn not in AGG_CODES:
            raise ProgramError(f"aggregate {fn!r} unsupported")
        if fn != "count" and arg is not None:
            em.expr(arg)
        elif fn != "count":
            raise ProgramError(f"aggregate {fn!r} has no argument")
        bounds.append(len(em.code) // 2)
    if probe_preds is not None:
        conj(probe_preds)
    # every slot leaves exactly one value on the stack
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        if hi > lo and _depth_net(em.code[2 * lo:2 * hi]) != 1:
            raise ProgramError("malformed expression program")
    # the deepest slot bounds the stack; slots run one at a time
    depth = max([_depth(em.code[2 * bounds[s]:2 * bounds[s + 1]])
                 for s in range(len(bounds) - 1)] + [0])
    if depth > MAX_STACK:
        raise ProgramError(f"expression needs a stack of {depth} "
                           f"(> {MAX_STACK})")
    return Program(tuple(em.names),
                   np.asarray(em.code, np.int32).reshape(-1, 2),
                   np.asarray(em.consts or [0.0], np.float64),
                   np.asarray(bounds, np.int32),
                   tuple(fn for fn, _ in aggs), int(n_groups), depth,
                   tuple(em.const_int) or (False,),
                   probe_pred=probe_preds is not None)


def _depth_net(code: list[int]) -> int:
    return sum(1 - _POPS[code[i]] for i in range(0, len(code), 2))


# -- the type pass -------------------------------------------------------------------

_ARITH = {ADD: torch.add, SUB: torch.sub, MUL: torch.mul}


def _type_pass(prog: Program, dtypes: tuple):
    """Follow each value's dtype through the postfix code on proxy
    tensors (columns 1-D zeros, literals 0-dim int64/float64 holding
    their value, as the generic path builds them; ``/`` through
    ``common.true_divide``, the generic path's own rule) and insert
    ``F32`` after every operand and result of an operation whose type
    is float32. Returns (code, consts, slots) of the typed program."""
    if len(dtypes) != len(prog.names):
        raise ValueError(f"{len(dtypes)} dtypes for {len(prog.names)} "
                         "columns")
    code = prog.code.tolist()
    consts = prog.consts.copy()
    after: set[int] = set()          # instruction indices to round after
    f32 = torch.float32

    def round_(*entries):
        for proxy, at in entries:
            if proxy.dtype != f32:
                after.add(at)

    for s in range(len(prog.slots) - 1):
        lo, hi = prog.slot_range(s)
        stack: list[tuple[torch.Tensor, int]] = []
        for i in range(lo, hi):
            op, arg = code[i]
            if op == COL:
                stack.append((torch.zeros(1, dtype=dtypes[arg]), i))
            elif op == CONST:
                stack.append((torch.tensor(consts[arg], dtype=torch.int64
                                           if prog.const_int[arg]
                                           else torch.float64), i))
            elif op in (NOT, IN):
                t, _ = stack.pop()
                if op == IN and t.dtype == f32:
                    n = int(consts[arg])
                    consts[arg + 1:arg + 1 + n] = consts[
                        arg + 1:arg + 1 + n].astype(np.float32)
                stack.append((torch.zeros(t.shape, dtype=torch.bool), i))
            elif op == TRUNC:
                stack.append((stack.pop()[0], i))
            elif op == CASE:
                e, t, c = stack.pop(), stack.pop(), stack.pop()
                r = torch.where(c[0].to(torch.bool), t[0], e[0])
                if r.dtype == f32:
                    round_(t, e)
                stack.append((r, i))
            else:
                b, a = stack.pop(), stack.pop()
                if op in _ARITH or op == DIV:
                    try:
                        r = (true_divide if op == DIV
                             else _ARITH[op])(a[0], b[0])
                    except RuntimeError:    # bool arithmetic: no f32
                        r = torch.zeros(1, dtype=torch.float64)
                    if op == DIV and code[b[1]][0] == CONST \
                            and divides_by_reciprocal(a[0], b[0]) \
                            and r.is_floating_point():
                        # x / c as common.true_divide runs it
                        inv = float(reciprocal(b[0], r.dtype))
                        consts = np.append(consts, inv)
                        code[b[1]] = [CONST, len(consts) - 1]
                        code[i] = [MUL, 0]
                    if r.dtype == f32:
                        round_(a, b)
                        after.add(i)
                else:               # comparison, AND, OR
                    if op not in (AND, OR) and \
                            torch.result_type(a[0], b[0]) == f32:
                        round_(a, b)
                    r = torch.zeros(torch.broadcast_shapes(
                        a[0].shape, b[0].shape), dtype=torch.bool)
                stack.append((r, i))
    out, new_at = [], []
    for i, pair in enumerate(code):
        new_at.append(len(out))
        out.append(pair)
        if i in after:
            out.append([F32, 0])
    new_at.append(len(out))
    slots = np.asarray([new_at[b] for b in prog.slots.tolist()], np.int32)
    return np.asarray(out, np.int32).reshape(-1, 2), consts, slots


def for_columns(program: Program, columns: dict,
                payload: dict | None = None) -> Program:
    """``program`` specialised for the dtypes of ``columns`` and, for the
    join kernel, of the build ``payload``: a name missing from
    ``columns`` is read on the build side."""
    payload = payload or {}
    gathered = tuple(n not in columns for n in program.names)
    dtypes = tuple((payload[n] if g else columns[n]).dtype
                   for n, g in zip(program.names, gathered))
    return program.specialise(dtypes, gathered if any(gathered) else ())


# -- plain torch evaluation ------------------------------------------------------

def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def eval_slot(prog: Program, s: int, cols: dict) -> torch.Tensor:
    """Evaluate slot ``s`` over the column dict, vectorised: a stack of
    float64 tensors, booleans as 0/1 — the arithmetic the kernel does
    per row. For a join program, ``cols`` holds the build payload
    already gathered at each row's hit position."""
    lo, hi = prog.slot_range(s)
    stack: list[torch.Tensor] = []
    consts = prog.consts
    ref = next(iter(cols.values()), None)
    for op, arg in prog.code[lo:hi].tolist():
        if op == COL:
            stack.append(_f64(cols[prog.names[arg]]))
            continue
        if op == CONST:
            dev = ref.device if ref is not None else "cpu"
            stack.append(torch.tensor(consts[arg], dtype=torch.float64,
                                      device=dev))
            continue
        if op == NOT:
            stack.append(_f64(stack.pop() == 0))
            continue
        if op == TRUNC:
            stack.append(torch.trunc(stack.pop()))
            continue
        if op == F32:
            stack.append(stack.pop().to(torch.float32).to(torch.float64))
            continue
        if op == IN:
            t = stack.pop()
            n = int(consts[arg])
            hit = torch.zeros_like(t, dtype=torch.bool)
            for v in consts[arg + 1:arg + 1 + n].tolist():
                hit = hit | (t == v)
            stack.append(_f64(hit))
            continue
        if op == CASE:
            e, t, c = stack.pop(), stack.pop(), stack.pop()
            stack.append(torch.where(c != 0, t, e))
            continue
        b, a = stack.pop(), stack.pop()
        if op == ADD:
            r = a + b
        elif op == SUB:
            r = a - b
        elif op == MUL:
            r = a * b
        elif op == DIV:
            r = a / b
        elif op == LT:
            r = _f64(a < b)
        elif op == LE:
            r = _f64(a <= b)
        elif op == GT:
            r = _f64(a > b)
        elif op == GE:
            r = _f64(a >= b)
        elif op == EQ:
            r = _f64(a == b)
        elif op == NE:
            r = _f64(a != b)
        elif op == AND:
            r = _f64((a != 0) & (b != 0))
        elif op == OR:
            r = _f64((a != 0) | (b != 0))
        else:
            raise ProgramError(f"bad opcode {op}")
        stack.append(r)
    (out,) = stack
    return out
