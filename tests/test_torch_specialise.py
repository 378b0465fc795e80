"""The compiled scan kernels' row functions against the interpreter's
plain twin, on the CPU.

``repro_torch.kernels.specialise`` writes each typed expression program
as straight-line C++ (a ``struct Spec``) that NVRTC compiles into the
program's own CUDA kernel on the card. Here the same struct compiles as
host C++ (``g++ -O2 -ffp-contract=off``, with the few CUDA intrinsics it
uses defined as their host equivalents), runs over seeded numpy columns,
and its predicate, group id and aggregate arguments must equal
``program.eval_slot``'s bit for bit (a NaN equals a NaN). Programs: the
kernel arms of TPC-H Q1, Q6 and the grouped min/max query as
``lower.match_fragment`` builds them, programs that use every opcode and
every column type, the stack depths of the card tests, and seeded
random expressions. Skips where ``g++`` is missing.
"""

import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import specialise
from repro_torch.kernels.program import (DTYPE_CODES, ProgramError,
                                         compile_program, eval_slot)

N_ROWS = 4096
TPCH = ("q1", "q6", "minmax")
MINMAX_SQL = ("select l_returnflag, min(l_quantity) as mq, "
              "max(l_tax) as mt from lineitem group by l_returnflag")
DTYPES = tuple(DTYPE_CODES)

# the CUDA names the Spec uses, as host C++
PRELUDE = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
namespace scan_spec { struct ColPtrs { const void* p[16]; }; }
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline double __longlong_as_double(unsigned long long b) {
  double d;
  memcpy(&d, &b, sizeof d);
  return d;
}
static inline float __double2float_rn(double x) { return (float)x; }

// argv: out file, rows, column files; writes per row pred, gid, args
template <class S>
static int run(int argc, char** argv) {
  const long long n = atoll(argv[3]);
  scan_spec::ColPtrs c{};
  std::vector<std::vector<char>> bufs;
  for (int j = 4; j < argc; ++j) {
    FILE* f = fopen(argv[j], "rb");
    if (!f) return 3;
    fseek(f, 0, SEEK_END);
    bufs.emplace_back(ftell(f) + 1);
    fseek(f, 0, SEEK_SET);
    if (fread(bufs.back().data(), 1, bufs.back().size() - 1, f) !=
        bufs.back().size() - 1) return 4;
    fclose(f);
    c.p[j - 4] = bufs.back().data();
  }
  FILE* out = fopen(argv[2], "wb");
  for (long long i = 0; i < n; ++i) {
    typename S::Row r;
    S::load_pred(c, i, r);
    S::load_rest(c, i, r);
    double rec[2 + S::kA];
    rec[0] = S::pred(r);
    rec[1] = S::gid(r);
    S::args(r, rec + 2);
    fwrite(rec, sizeof(double), 2 + S::kA, out);
  }
  fclose(out);
  return 0;
}
"""


def _col(name):
    return {"t": "col", "name": name}


def _lit(v):
    return {"t": "lit", "value": v}


def _bin(op, a, b):
    return {"t": "bin", "op": op, "l": a, "r": b}


def _cmp(op, a, b):
    return {"t": "cmp", "op": op, "l": a, "r": b}


def _nested(names, op):
    """c0 op (c1 op (...)): a stack as deep as there are columns."""
    e = _col(names[-1])
    for n in reversed(names[:-1]):
        e = _bin(op, _col(n), e)
    return e


def _opcode_program(dtype_a, dtype_b, grouped):
    """Every opcode (COL, CONST, + - * /, the six comparisons, AND, OR,
    NOT, CASE, IN, TRUNC and, through the type pass, F32) over columns
    ``a`` and ``b`` of the given dtypes."""
    a, b = _col("a"), _col("b")
    pred = {"t": "or", "terms": [
        {"t": "and", "terms": [_cmp("<", a, _lit(3)),
                               _cmp(">=", b, _lit(-2.5)),
                               {"t": "not", "term": _cmp("=", a, b)}]},
        _cmp("<>", _bin("-", a, b), _lit(1)),
        {"t": "in", "term": a, "values": [_lit(1), _lit(2.5), _lit(-4)]}]}
    aggs = [("sum", _bin("/", a, b)), ("count", None),
            ("min", {"t": "case", "cond": _cmp("<=", a, _lit(0)),
                     "then": _bin("*", a, _lit(0.1)),
                     "else": _bin("+", b, _lit(7))}),
            ("max", _bin("/", _bin("*", a, b), _lit(3))),
            ("sum", {"t": "in", "term": b, "values": [a, _lit(1)]}),
            ("max", _cmp(">", a, b))]
    prog = compile_program([pred], aggs,
                           group_cols=["g"] if grouped else None,
                           strides=[1] if grouped else None,
                           n_groups=5 if grouped else 0)
    return prog, {"a": dtype_a, "b": dtype_b, "g": torch.int16}


def _depth_program(depth, grouped):
    names = [f"c{i}" for i in range(depth)]
    prog = compile_program(
        [_cmp(">", _nested(names, "+"), _lit(0))],
        [("sum", _nested(names, "*")), ("count", None),
         ("max", _nested(names, "-"))],
        group_cols=["g"] if grouped else None,
        strides=[1] if grouped else None, n_groups=4 if grouped else 0)
    assert prog.depth == depth
    return prog, {**{n: torch.float64 for n in names}, "g": torch.int32}


def _random_expr(rng, names, depth):
    if depth == 0 or rng.random() < 0.2:
        if rng.random() < 0.65:
            return _col(str(rng.choice(names)))
        return _lit(int(rng.integers(-5, 6)) if rng.random() < 0.5
                    else float(np.round(rng.normal() * 3, 2)))
    kind = str(rng.choice(["bin", "cmp", "and", "or", "not", "case", "in"]))
    sub = lambda: _random_expr(rng, names, depth - 1)   # noqa: E731
    if kind == "bin":
        return _bin(str(rng.choice(["+", "-", "*", "/"])), sub(), sub())
    if kind == "cmp":
        return _cmp(str(rng.choice(["<", "<=", ">", ">=", "=", "<>"])),
                    sub(), sub())
    if kind in ("and", "or"):
        return {"t": kind, "terms": [sub() for _ in
                                     range(int(rng.integers(2, 4)))]}
    if kind == "not":
        return {"t": "not", "term": sub()}
    if kind == "case":
        return {"t": "case", "cond": sub(), "then": sub(), "else": sub()}
    values = [_lit(int(rng.integers(-3, 4))) for _ in
              range(int(rng.integers(1, 4)))]
    if rng.random() < 0.3:
        values.append(sub())
    return {"t": "in", "term": sub(), "values": values}


def _random_program(seed):
    """A seeded random program that ``compile_program`` accepts, over
    three columns of random dtypes."""
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c"]
    while True:
        grouped = bool(rng.random() < 0.5)
        fns = [str(rng.choice(["sum", "count", "min", "max"]))
               for _ in range(int(rng.integers(1, 5)))]
        try:
            prog = compile_program(
                [_random_expr(rng, names, 3)],
                [(f, None if f == "count" else _random_expr(rng, names, 3))
                 for f in fns],
                group_cols=["g"] if grouped else None,
                strides=[1] if grouped else None,
                n_groups=int(rng.integers(1, 9)) if grouped else 0)
        except ProgramError:
            continue
        dtypes = {n: DTYPES[int(rng.integers(len(DTYPES)))] for n in names}
        return prog, {**dtypes, "g": torch.int64}


def _tpch_programs():
    from repro_torch.api import connect
    from repro_torch.core.engine import QueryEngine
    from repro_torch.exec import lower
    from repro_torch.sql.queries import QUERIES
    from repro_torch.storage import InputHandler
    s = connect(tier="local", quota=4, device="cpu")
    try:
        catalog = s.ensure_tpch(sf=0.01, n_parts=4)
        ih = InputHandler(s.store)
        part = ih.read_table(catalog.tables["lineitem"].files[0])[0]
        engine = QueryEngine(s.store, s.catalog, platform=s.platform,
                             handler=s.handler)
        out = {}
        for q, sql in (("q1", QUERIES["q1"]), ("q6", QUERIES["q6"]),
                       ("minmax", MINMAX_SQL)):
            plan = engine.plan_sql(sql)
            m = next(lower.match_fragment(p.op)
                     for p in plan.pipelines.values() if p.kernel)
            cols = {c: np.ascontiguousarray(part[c][:N_ROWS])
                    for c in m.program.names}
            out[q] = (m.program, cols, m.kernel)
        return out
    finally:
        s.close()


def _random_column(rng, dtype, n):
    if dtype == torch.bool:
        return rng.random(n) < 0.5
    if dtype.is_floating_point:
        v = np.round(rng.normal(size=n) * 4, 1)
        special = rng.random(n)
        v[special < 0.02] = np.nan
        v[(special >= 0.02) & (special < 0.03)] = np.inf
        v[(special >= 0.03) & (special < 0.04)] = -np.inf
        v[(special >= 0.04) & (special < 0.06)] = -0.0
        v[(special >= 0.06) & (special < 0.10)] = 0.0
        return v.astype(torch.empty((), dtype=dtype).numpy().dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    lo = 0 if dtype == torch.uint8 else -6
    return rng.integers(lo, 7, n).astype(np_dtype)


def _cases():
    cases = {}
    for i, (da, db) in enumerate(zip(DTYPES, DTYPES[1:] + DTYPES[:1])):
        for grouped in (False, True):
            cases[f"opcodes-{str(da)[6:]}-{str(db)[6:]}-"
                  f"{'grouped' if grouped else 'ungrouped'}"] = \
                lambda da=da, db=db, g=grouped: _opcode_program(da, db, g)
    for depth in (3, 6, 11, 15):
        for grouped in (False, True):
            cases[f"depth{depth}-{'grouped' if grouped else 'ungrouped'}"] \
                = lambda d=depth, g=grouped: _depth_program(d, g)
    for seed in range(16):
        cases[f"random{seed}"] = lambda s=seed: _random_program(s)
    return cases


CASES = _cases()
ALL = TPCH + tuple(CASES)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """Every program typed, its columns on disk, and one host binary of
    all their Specs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the row check compiles host C++")
    tmp = tmp_path_factory.mktemp("spec")
    programs = {}
    for q, (prog, cols, _) in _tpch_programs().items():
        tensors = {c: torch.from_numpy(v) for c, v in cols.items()}
        programs[q] = (prog.specialise(tuple(tensors[n].dtype
                                             for n in prog.names)), tensors)
    for i, (name, make) in enumerate(CASES.items()):
        prog, dtypes = make()
        rng = np.random.default_rng(100 + i)
        tensors = {n: torch.from_numpy(_random_column(rng, dtypes[n],
                                                      N_ROWS))
                   for n in prog.names}
        programs[name] = (prog.specialise(tuple(dtypes[n]
                                                for n in prog.names)),
                          tensors)
    src = [PRELUDE]
    for i, name in enumerate(ALL):
        src.append(f"namespace p{i} {{\n"
                   + specialise.row_source(programs[name][0]) + "}\n")
    src.append("int main(int argc, char** argv) {\n"
               "  switch (atoi(argv[1])) {\n"
               + "".join(f"    case {i}: return run<p{i}::Spec>(argc, argv);\n"
                         for i in range(len(ALL)))
               + "  }\n  return 2;\n}\n")
    cpp = tmp / "rows.cpp"
    cpp.write_text("".join(src))
    exe = tmp / "rows"
    res = subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17",
                          "-o", str(exe), str(cpp)], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return tmp, exe, programs


def _same_bits(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.broadcast_to(np.asarray(want, np.float64), got.shape)
    both_nan = np.isnan(got) & np.isnan(want)
    same = (got.view(np.uint64) == want.view(np.uint64)) | both_nan
    bad = np.flatnonzero(~same)
    assert bad.size == 0, (f"{what}: {bad.size} rows differ, first at "
                           f"{bad[0]}: {got[bad[0]]!r} != {want[bad[0]]!r}")


@pytest.mark.parametrize("name", ALL)
def test_row_function_equals_the_interpreter_bit_for_bit(harness, name):
    tmp, exe, programs = harness
    prog, cols = programs[name]
    files = []
    for j, n in enumerate(prog.names):
        f = tmp / f"{name}-{j}.bin"
        cols[n].numpy().tofile(f)
        files.append(str(f))
    out = tmp / f"{name}.out"
    res = subprocess.run([str(exe), str(ALL.index(name)), str(out),
                          str(N_ROWS), *files], capture_output=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    rec = np.fromfile(out, np.float64).reshape(N_ROWS, 2 + prog.n_aggs)
    if prog.has_pred:
        _same_bits(rec[:, 0], eval_slot(prog, 0, cols).numpy(), "predicate")
    if prog.n_groups:
        _same_bits(rec[:, 1], eval_slot(prog, 1, cols).numpy(), "group id")
    for a, fn in enumerate(prog.fns):
        want = 1.0 if fn == "count" else eval_slot(prog, 2 + a, cols).numpy()
        _same_bits(rec[:, 2 + a], want, f"aggregate {a} ({fn})")


def test_the_programs_cover_every_opcode_and_column_type(harness):
    _, _, programs = harness
    ops = set()
    dtypes = set()
    for prog, _ in programs.values():
        ops |= set(prog.code[:, 0].tolist())
        dtypes |= set(prog.dtypes)
    assert ops == set(range(19))
    assert dtypes == set(DTYPE_CODES)


def test_tpch_programs_take_the_planned_skeletons(harness):
    _, _, programs = harness
    assert specialise.skeleton(programs["q6"][0]) == "filter_agg"
    assert specialise.skeleton(programs["q1"][0]) == "group_regs"
    assert specialise.skeleton(programs["minmax"][0]) == "group_regs"


@pytest.mark.parametrize("K,A,kind", [(16, 3, "group_regs"),
                                      (13, 4, "group_smem"),
                                      (4096, 4, "group_smem")])
def test_register_tile_limit(K, A, kind):
    """K·(A+1) at REG_TILE keeps the tile in registers, one past it in
    shared memory."""
    prog = compile_program([], [("sum", _col("x"))] * A, group_cols=["g"],
                           strides=[1], n_groups=K)
    assert (K * (A + 1) <= specialise.REG_TILE) == (kind == "group_regs")
    typed = prog.specialise((torch.float64, torch.int32))
    assert specialise.skeleton(typed) == kind
    assert f"spec_{kind}(" in specialise.source(typed)


def test_source_is_deterministic():
    a, dtypes = _opcode_program(torch.float32, torch.int32, True)
    b, _ = _opcode_program(torch.float32, torch.int32, True)
    key = tuple(dtypes[n] for n in a.names)
    assert specialise.source(a.specialise(key)) == \
        specialise.source(b.specialise(key))
    assert specialise.cache_key(a.specialise(key)) == \
        specialise.cache_key(b.specialise(key))


@pytest.mark.parametrize("change", ["dtype", "groups", "fns"])
def test_cache_key_follows_what_the_kernel_depends_on(change):
    def make(fn="sum", K=4):
        return compile_program([_cmp(">", _col("x"), _lit(1))],
                               [(fn, _col("x")), ("count", None)],
                               group_cols=["g"], strides=[1], n_groups=K)
    base = make().specialise((torch.float64, torch.int32))
    other = {"dtype": lambda: make().specialise((torch.float32, torch.int32)),
             "groups": lambda: make(K=5).specialise((torch.float64,
                                                     torch.int32)),
             "fns": lambda: make(fn="max").specialise((torch.float64,
                                                       torch.int32))}[change]()
    assert specialise.cache_key(base) != specialise.cache_key(other)
    assert specialise.cache_key(base) == specialise.cache_key(
        make().specialise((torch.float64, torch.int32)))


def test_constants_are_written_bit_exact():
    prog = compile_program([_cmp("<", _col("x"), _lit(0.1))],
                           [("sum", _bin("*", _col("x"), _lit(1 / 3)))])
    src = specialise.row_source(prog.specialise((torch.float64,)))
    for v in (0.1, 1 / 3):
        bits = int(np.float64(v).view(np.uint64))
        assert f"__longlong_as_double(0x{bits:016x}ULL)" in src
    assert "0.1" not in src.replace("0x", "")


def test_generator_refuses_what_it_cannot_compile():
    prog = compile_program([_cmp("<", _col("x"), _lit(1))],
                           [("sum", _col("x"))])
    with pytest.raises(ValueError, match="typed"):
        specialise.row_source(prog)
    typed = prog.specialise((torch.float64,))
    bad = dataclasses.replace(typed, code=np.asarray(
        [[0, 0], [99, 0]], np.int32), slots=np.asarray([0, 2, 2, 2],
                                                       np.int32))
    with pytest.raises(ValueError, match="opcode 99"):
        specialise.row_source(bad)
    empty = compile_program([], []).specialise(())
    with pytest.raises(ValueError, match="aggregate"):
        specialise.row_source(empty)
