"""Compile a scan-aggregate program into its own CUDA kernel.

The reference's Pallas kernels trace each query's jnp closures into the
kernel body, so Q1's kernel is compiled for Q1's expressions. This
module does the same for the port's scan kernels (``fused_filter_agg``,
``fused_groupby``, ``fused_groupby_minmax``): it writes a typed
:class:`~repro_torch.kernels.program.Program` (after
``Program.specialise``, with its ``F32`` roundings and reciprocal
divisions) as straight-line C++, a ``struct Spec`` that
``csrc/scan_spec.cuh``'s skeletons take as a template argument:

- each postfix stack position is a named ``double`` local, so no index
  is dynamic and nothing lives in local memory;
- each column loads once per row in its own type and converts to
  ``double`` as ``scan_agg.cuh``'s ``load_col`` does; the predicate's
  columns load first, the others only for rows that pass;
- constants are written bit-exact, ``__longlong_as_double(0x…)``;
- every opcode does what the interpreter (``scan_agg.cuh:eval_slot``)
  does, in the same order, so under ``-fmad=false`` every row gives the
  interpreter's values bit for bit.

The skeleton follows from the program: ``filter_agg`` when ungrouped,
``group_regs`` (the (K, A+1) tile in registers) when K·(A+1) is at most
:data:`REG_TILE`, else ``group_smem`` (the tile in shared memory).

Kernels compile with NVRTC (``ext.nvrtc_compile``, options
:data:`OPTIONS`) into a cubin at a program's first launch (a fragment's
untimed warm-up call), load through libcuda into the context
torch made current, and are cached in the process (by
:func:`cache_key`: a hash of the source, the headers and the options;
a launch finds its typed program's kernel without hashing again) and
on disk under ``build/torch_ext/spec/`` (with the NVRTC version in the
file name), behind ``ext.build_lock``, so concurrent fragments compile
a program once. A compile or launch that
fails raises: there is no interpreter and no plain version behind it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import time
import weakref
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis.roofline import THREADS
from repro_torch.kernels import ext
from repro_torch.kernels.program import (
    ADD, AGG_CODES, AND, CASE, COL, CONST, DIV, DTYPE_CODES, EQ, F32, GE,
    GT, IN, LE, LT, MAX_COLS, MUL, NE, NOT, OR, SUB, TRUNC, Program,
    for_columns)

REG_TILE = 64            # K·(A+1) doubles a thread keeps in registers
ROWS = 4                 # rows a thread takes an iteration (scan_spec.cuh)
HEADERS = ("scan_spec.cuh", "scan_agg.cuh")
OPTIONS = ("-arch=sm_90a", "--fmad=false", "-std=c++17")
REDUCE = "scan_agg::reduce_partials_kernel"
SPEC_DIR = ext.BUILD_DIR / "spec"

# column type code (program.DTYPE_CODES) → C type, and whether load_col
# reads it through __ldg
_CTYPES = {0: ("double", True), 1: ("float", True), 2: ("long long", True),
           3: ("int", True), 4: ("short", False), 5: ("signed char", False),
           6: ("unsigned char", False)}
_BINARY = {ADD: "{a} + {b}", SUB: "{a} - {b}", MUL: "{a} * {b}",
           DIV: "{a} / {b}",
           LT: "{a} < {b} ? 1.0 : 0.0", LE: "{a} <= {b} ? 1.0 : 0.0",
           GT: "{a} > {b} ? 1.0 : 0.0", GE: "{a} >= {b} ? 1.0 : 0.0",
           EQ: "{a} == {b} ? 1.0 : 0.0", NE: "{a} != {b} ? 1.0 : 0.0",
           AND: "(({a} != 0.0) & ({b} != 0.0)) ? 1.0 : 0.0",
           OR: "(({a} != 0.0) | ({b} != 0.0)) ? 1.0 : 0.0"}


def skeleton(prog: Program) -> str:
    """The ``scan_spec.cuh`` skeleton that runs ``prog``."""
    if not prog.n_groups:
        return "filter_agg"
    if prog.n_groups * (prog.n_aggs + 1) <= REG_TILE:
        return "group_regs"
    return "group_smem"


def _const(v: float) -> str:
    bits = int(np.float64(v).view(np.uint64))
    return f"__longlong_as_double(0x{bits:016x}ULL)"


def _slot_lines(prog: Program, s: int) -> list[str]:
    """Straight-line code of slot ``s``: stack position p is ``t<p>``,
    column j ``x<j>``; the slot's value ends in ``t0``."""
    lo, hi = prog.slot_range(s)
    consts = prog.consts
    lines, sp, depth = [], 0, 0
    for op, arg in prog.code[lo:hi].tolist():
        t = [f"t{i}" for i in range(sp)]
        if op == COL:
            lines.append(f"t{sp} = x{arg};")
            sp += 1
        elif op == CONST:
            lines.append(f"t{sp} = {_const(consts[arg])};")
            sp += 1
        elif op == NOT:
            lines.append(f"{t[sp - 1]} = {t[sp - 1]} == 0.0 ? 1.0 : 0.0;")
        elif op == TRUNC:
            lines.append(f"{t[sp - 1]} = trunc({t[sp - 1]});")
        elif op == F32:
            lines.append(f"{t[sp - 1]} = "
                         f"(double)__double2float_rn({t[sp - 1]});")
        elif op == IN:
            n = int(consts[arg])
            hits = " | ".join(f"({t[sp - 1]} == {_const(v)})"
                              for v in consts[arg + 1:arg + 1 + n].tolist())
            lines.append(f"{t[sp - 1]} = ({hits or 'false'}) ? 1.0 : 0.0;")
        elif op == CASE:
            c, a, b = t[sp - 3], t[sp - 2], t[sp - 1]
            lines.append(f"{c} = {c} != 0.0 ? {a} : {b};")
            sp -= 2
        elif op in _BINARY:
            a, b = t[sp - 2], t[sp - 1]
            lines.append(f"{a} = " + _BINARY[op].format(a=a, b=b) + ";")
            sp -= 1
        else:
            raise ValueError(f"opcode {op} has no compiled form")
        depth = max(depth, sp)
    decl = "double " + ", ".join(f"t{i}" for i in range(depth)) + ";"
    return [decl] + lines


def _columns(prog: Program, slots) -> list[int]:
    cols = set()
    for s in slots:
        lo, hi = prog.slot_range(s)
        cols |= {arg for op, arg in prog.code[lo:hi].tolist() if op == COL}
    return sorted(cols)


def _used_slots(prog: Program) -> list[int]:
    return [s for s in range(2 + prog.n_aggs)
            if prog.n_ops(s) and (s != 1 or prog.n_groups)]


def row_source(prog: Program) -> str:
    """The ``struct Spec`` of a typed program: its row type, loads,
    predicate, group id and aggregate arguments (see ``scan_spec.cuh``)."""
    if prog.dtypes is None:
        raise ValueError("compile a typed program (Program.specialise)")
    if len(prog.names) > MAX_COLS:
        raise ValueError(f"more than {MAX_COLS} columns")
    if not prog.n_aggs and not prog.n_groups:
        raise ValueError("an ungrouped scan kernel needs an aggregate")
    codes = [DTYPE_CODES[d] for d in prog.dtypes]
    used = _used_slots(prog)
    # the first loads: the predicate's columns (every column where there
    # is no predicate); the rest load for the rows that pass
    pred_cols = _columns(prog, [0] if prog.has_pred else used)
    rest_cols = [j for j in _columns(prog, used) if j not in pred_cols]
    A = prog.n_aggs
    fns = [AGG_CODES[f] for f in prog.fns]
    fn_expr = "".join(f"a == {a} ? {f} : " for a, f in enumerate(fns[:-1]))
    out = [
        "struct Spec {",
        f"  static constexpr int kA = {A};",
        f"  static constexpr int kK = {prog.n_groups};",
        f"  static constexpr bool kHasPred = "
        f"{'true' if prog.has_pred else 'false'};",
        "  __host__ __device__ static constexpr int fn(int a) {",
        f"    return {fn_expr}{fns[-1] if fns else 0};",
        "  }",
        "  struct Row {",
    ]
    out += [f"    {_CTYPES[codes[j]][0]} c{j};"
            for j in pred_cols + rest_cols]
    out.append("  };")

    def loads(name, cols):
        body = []
        for j in cols:
            ctype, ldg = _CTYPES[codes[j]]
            ptr = f"static_cast<const {ctype}*>(c.p[{j}])"
            body.append(f"    r.c{j} = __ldg({ptr} + i);" if ldg
                        else f"    r.c{j} = {ptr}[i];")
        return ([f"  __device__ __forceinline__ static void {name}("
                 "const scan_spec::ColPtrs& c, long long i, Row& r) {"]
                + body + ["  }"])

    def function(head, slots, pre, tail):
        """A member function computing each of ``slots`` (target, slot)
        in a block of its own."""
        lines = [f"  __device__ __forceinline__ static {head} {{"]
        lines += [f"    const double x{j} = (double)r.c{j};"
                  for j in _columns(prog, [s for _, s in slots])]
        lines += [f"    {line}" for line in pre]
        for target, s in slots:
            lines += ["    {"] + [f"      {line}"
                                  for line in _slot_lines(prog, s)]
            lines += [f"      {target} = t0;", "    }"]
        return lines + [f"    {line}" for line in tail] + ["  }"]

    out += loads("load_pred", pred_cols)
    out += loads("load_rest", rest_cols)
    for name, s, default in (("pred", 0, "1.0"), ("gid", 1, "0.0")):
        if s in used:
            out += function(f"double {name}(const Row& r)", [("v", s)],
                            ["double v;"], ["return v;"])
        else:
            out += function(f"double {name}(const Row&)", [], [],
                            [f"return {default};"])
    out += function("void args(const Row& r, double* v)",
                    [(f"v[{a}]", 2 + a) for a in range(A)
                     if prog.fns[a] != "count"], [],
                    [f"v[{a}] = 1.0;" for a in range(A)
                     if prog.fns[a] == "count"])
    out.append("};")
    return "\n".join(out) + "\n"


def source(prog: Program) -> str:
    """The CUDA source of ``prog``'s kernel: the Spec and one extern "C"
    kernel named after its skeleton."""
    kind = skeleton(prog)
    return (f"// {kind} kernel of one scan-aggregate program, written by "
            "repro_torch.kernels.specialise\n"
            '#include "scan_spec.cuh"\n\nnamespace {\n'
            + row_source(prog) + "}  // namespace\n\n"
            f'extern "C" __global__ void __launch_bounds__({THREADS})\n'
            f"spec_{kind}(scan_spec::ColPtrs c, "
            "const unsigned char* __restrict__ mask,\n"
            f"    long long n, double* __restrict__ partials) {{\n"
            f"  scan_spec::{kind}<Spec, {THREADS}>(c, mask, n, partials);\n"
            "}\n")


def _headers() -> dict[str, str]:
    return {h: (ext.CSRC / h).read_text() for h in HEADERS}


def cache_key(prog: Program) -> str:
    """Hash of what a compile depends on: the source, the headers and the
    options (the NVRTC version joins the file name on disk)."""
    h = hashlib.sha1(source(prog).encode())
    for name, text in sorted(_headers().items()):
        h.update(name.encode() + text.encode())
    h.update(" ".join(OPTIONS).encode())
    return h.hexdigest()[:16]


class _ColPtrs(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_COLS)]


class Kernel:
    """One program's loaded kernel and its finishing pass, on one card."""

    def __init__(self, key: str, kind: str, module, names: dict,
                 prog: Program, device: torch.device,
                 compile_ms: float | None, origin: str):
        self.key, self.kind = key, kind
        self.fn = ext.module_function(module, f"spec_{kind}")
        self.reduce = ext.module_function(module, names[REDUCE])
        K, A = prog.n_groups, prog.n_aggs
        self.n_aggs = A
        self.fns = prog.device_arrays(device)[3]   # the finishing pass's
        self.width = (K * (A + 1)) if K else A
        self.row_len = A + 1 if K else A
        self.smem = self.width * 8 if kind == "group_smem" else 0
        if self.smem > 48 * 1024:
            ext.set_max_dynamic_smem(self.fn, self.smem)
        self.regs = ext.function_attribute(self.fn, ext.CU_FUNC_NUM_REGS)
        self.local_bytes = ext.function_attribute(
            self.fn, ext.CU_FUNC_LOCAL_SIZE_BYTES)
        self.per_sm = ext.occupancy(self.fn, THREADS, self.smem)
        if self.per_sm < 1:
            raise RuntimeError(f"spec_{kind} ({key}): no CTA of {THREADS} "
                               f"threads and {self.smem} B fits an SM")
        self.sms = ext.sm_count(device)
        self.compile_ms, self.origin = compile_ms, origin
        # the finishing pass: ``lanes`` consecutive outputs a block
        self.lanes = 1
        while self.lanes < 32 and self.lanes < self.width:
            self.lanes <<= 1

    def ctas(self, n: int) -> int:
        """A full card of CTAs at this kernel's occupancy, and no more than
        the rows fill."""
        per_cta = THREADS * ROWS
        return max(1, min(self.per_sm * self.sms, -(-n // per_cta)))

    def __call__(self, cols: list, mask: torch.Tensor) -> torch.Tensor:
        """Launch on ``mask``'s rows of the (checked, contiguous) program
        ``cols``; returns the (A,) or (K, A+1) float64 result."""
        dev = mask.device
        n = int(mask.shape[0])
        ctas = self.ctas(n)
        partials = torch.empty((ctas, self.width), dtype=torch.float64,
                               device=dev)
        out = torch.empty((self.width,), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = _ColPtrs()
        for j, c in enumerate(cols):
            ptrs.p[j] = c.data_ptr()
        ext.launch_kernel(self.fn, ctas, THREADS, self.smem, stream,
                          [ptrs, ctypes.c_void_p(mask.data_ptr()),
                           ctypes.c_int64(n),
                           ctypes.c_void_p(partials.data_ptr())],
                          dev)
        ext.launch_kernel(self.reduce, -(-self.width // self.lanes),
                          ext.REDUCE_THREADS, 0, stream,
                          [ctypes.c_void_p(partials.data_ptr()),
                           ctypes.c_int(ctas), ctypes.c_int64(self.width),
                           ctypes.c_int(self.row_len),
                           ctypes.c_void_p(self.fns.data_ptr()),
                           ctypes.c_int(self.n_aggs),
                           ctypes.c_int(self.lanes),
                           ctypes.c_void_p(out.data_ptr())], dev)
        return out


_kernels: dict = {}
_loaded: list[Kernel] = []
# (id of a typed program, device) → (a weak reference to the program,
# its kernel): a launch's lookup without rebuilding the source to hash
_by_program: dict = {}


def loaded() -> list[Kernel]:
    """Every kernel this process has loaded, in order: its ``origin``
    (``nvrtc``, compiled; ``disk``, a cubin from ``SPEC_DIR``) and
    ``compile_ms``, registers and local bytes."""
    with ext.build_lock():
        return list(_loaded)


def kernel(prog: Program, device: torch.device) -> Kernel:
    """The loaded kernel of typed program ``prog`` on ``device``,
    compiled first if no cache holds it."""
    memo = (id(prog), device)
    hit = _by_program.get(memo)
    if hit is not None and hit[0]() is prog:
        return hit[1]
    key = cache_key(prog)
    with ext.build_lock():
        k = _kernels.get((key, device))
        if k is None:
            k = _kernels[(key, device)] = _load(prog, key, device)
            _loaded.append(k)
    _by_program[memo] = (weakref.ref(
        prog, lambda _, memo=memo: _by_program.pop(memo, None)), k)
    return k


def _load(prog: Program, key: str, device) -> Kernel:
    kind = skeleton(prog)
    major, minor = ext.nvrtc_version()
    stem = SPEC_DIR / f"{key}-nvrtc{major}.{minor}"
    cubin, meta = stem.with_suffix(".cubin"), stem.with_suffix(".json")
    if cubin.exists() and meta.exists():
        names = json.loads(meta.read_text())["names"]
        image, origin, ms = cubin.read_bytes(), "disk", None
    else:
        t0 = time.perf_counter()
        image, names, _ = ext.nvrtc_compile(
            source(prog), f"spec_{key}.cu", _headers(), list(OPTIONS),
            [REDUCE])
        ms, origin = (time.perf_counter() - t0) * 1e3, "nvrtc"
        SPEC_DIR.mkdir(parents=True, exist_ok=True)
        _write(meta, json.dumps({"names": names}).encode())
        _write(cubin, image)
    return Kernel(key, kind, ext.load_module(image, device), names, prog,
                  device, ms, origin)


def _write(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def launch(name: str, columns: dict, mask,
           program: Program) -> torch.Tensor:
    """Run ``program``, typed for ``columns``, through its compiled
    kernel on the rows of ``mask`` and count the launch under ``name``:
    the (A,) float64 accumulator, or the (K, A+1) grouped tile."""
    typed = for_columns(program, columns)
    cols = ext.program_columns(columns, mask, typed)
    out = kernel(typed, mask.device)(cols, mask)
    ext.count_launch(name)
    if typed.n_groups:
        return out.view(typed.n_groups, typed.n_aggs + 1)
    return out
