"""The port's dry run (``repro_torch.launch.dryrun``, ``launch/mesh.py``)
against the reference, on the CPU.

(a) every TPC-H query plans to the reference's plan text with zero
invocations; (b) each reduced config's step traced on ``meta`` gives the
outputs (shapes, dtypes) of the reference's ``jax.eval_shape``, and
raises exactly where the reference raises; (c) the traced FLOPs at
batch 2 × 64 tokens equal the dot products of the reference's lowered
StableHLO (``scan_layers=False``), each private function weighed by its
calls and each ``while`` body by its trip count; (d) per-device argument
bytes equal XLA's ``memory_analysis`` on a (pod 2, data 2, model 4)
mesh of 16 host devices; (e) the collective schedule of that cell equals
a hand count; (f) full-width cells trace, and the CLI runs.

The reference's dry-run module sets ``XLA_FLAGS`` to 512 host devices
when it is imported, which would leak into this worker's JAX and its
subprocesses, so it is never imported here: its query planning is
reached through ``repro.api`` and its cells through
``repro.launch.specs``, and the 16-device lowering runs in a
subprocess.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from _explain import JOIN_SORT_AGG, without_join_sort_agg
from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import config as jmc
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.launch import dryrun, mesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import config as tmc
from repro_torch.parallel import sharding as tsh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = jconfigs.ARCHS


def _shapes(arch):
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if tconfigs.get_reduced(arch).sub_quadratic:
        names.append("long_500k")
    return names


CELLS = [(a, s) for a in ARCHS for s in _shapes(a)]


def _jax_leaves(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), leaf) for path, leaf in flat]


def _small_shapes(monkeypatch, batch=2, seq=64):
    """Every shape cut to ``batch`` × ``seq`` in both packages."""
    for name, old in tmc.SHAPES.items():
        monkeypatch.setitem(tmc.SHAPES, name, tmc.ShapeConfig(
            name, old.kind, seq, batch))
        monkeypatch.setitem(jmc.SHAPES, name, jmc.ShapeConfig(
            name, old.kind, seq, batch))


# -- (a) query plans ----------------------------------------------------------

def _strip_tiling(text):
    # the port's scan arms compile per program and show no tiling (as in
    # tests/test_torch_cli.py)
    text = re.sub(r"( kernel=(filter_agg|groupby_onehot|segmented_minmax))"
                  r" block=\d+ resident=\d+ \(\w+-bound\)", r"\1", text)
    return re.sub(r" block=\d+ resident=\d+", "", text)


def test_query_plans_equal_the_references(tmp_path, capsys):
    from repro.api import connect
    from repro.exec import lower as ref_lower
    from repro.sql.queries import QUERIES

    out = tmp_path / "plans.jsonl"
    assert dryrun.dryrun_queries(sf=0.01, out=str(out)) == 0
    got = [json.loads(line) for line in out.read_text().splitlines()]
    ref = connect(tier="local")
    ref.ensure_tpch(sf=0.01, n_parts=4)
    # the reference's kernel arms matched as on a compiled backend: the
    # port has no interpret-cost gate
    with ref_lower.interpret_gate_disabled():
        want = {q: _strip_tiling(ref.explain(sql))
                for q, sql in QUERIES.items()}
    assert ref.platform.invocations == 0
    assert [r["query"] for r in got] == list(want)
    for r in got:
        assert r["status"] == "ok", r
        # the port's own sort_agg arm over joins, which the reference misses
        plan, n = without_join_sort_agg(_strip_tiling(r["plan"]))
        assert n == JOIN_SORT_AGG.get(r["query"], 0), r["query"]
        assert plan == want[r["query"]], r["query"]
    assert capsys.readouterr().out.count("[ok]") == len(want)


def test_query_plans_through_a_session_that_ran_queries():
    from repro_torch.api import connect
    from repro_torch.sql.queries import QUERIES

    s = connect(tier="local", device="cpu")
    s.ensure_tpch(sf=0.01, n_parts=4)
    s.sql(QUERIES["q6"])
    ran = s.platform.invocations
    assert ran > 0
    assert dryrun.dryrun_queries(session=s) == 0
    assert s.platform.invocations == ran
    s.close()


# -- (b) output shapes --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_meta_outputs_equal_eval_shape(arch):
    raised = []
    for shape in _shapes(arch):
        ctx = (arch, shape)
        jcell = jspecs.build_cell(jconfigs.get_reduced(arch), arch, shape)
        tcell = tspecs.build_cell(tconfigs.get_reduced(arch), arch, shape)
        try:
            want = jax.eval_shape(jcell.step_fn, *jcell.arg_specs)
        except Exception:  # noqa: BLE001 - the port must raise here too
            with pytest.raises(Exception):
                tcell.step_fn(*tcell.arg_specs)
            raised.append(shape)
            continue
        got = tcell.step_fn(*tcell.arg_specs)
        gl, wl = tree.flatten_with_names(got), _jax_leaves(want)
        assert [n for n, _ in gl] == [n for n, _ in wl], ctx
        for (name, a), (_, b) in zip(gl, wl):
            assert a.device.type == "meta", (ctx, name)
            assert tuple(a.shape) == tuple(b.shape), (ctx, name)
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), \
                (ctx, name)
    # the reduced whisper's 256 decoder positions are fewer than the
    # train and prefill sequences, in both packages
    want_raised = ["train_4k", "prefill_32k"] \
        if arch == "whisper-large-v3" else []
    assert raised == want_raised


# -- (c) FLOPs ----------------------------------------------------------------

_FUNC = re.compile(r"^  func\.func (?:public |private )?@([\w.$-]+)\(")
_CALL = re.compile(r"(?:^|\s)(?:func\.)?call @([\w.$-]+)\(")
_TENSOR = re.compile(r"tensor<([^>]*)>")
_CONTRACT = re.compile(r"contracting_dims = \[([\d, ]*)\] x")
_CONST = re.compile(r"(%\S+) = stablehlo\.constant dense<(-?\d+)> : "
                    r"tensor<i\d+>")
_LT = re.compile(r"stablehlo\.compare\s+LT, (%\S+), (%\S+),")


def _dims(t: str) -> list[int]:
    return [int(p) for p in t.split("x")[:-1]]


def _dot_flops(line: str) -> int:
    """2 · |output| · |contracted dims| of one ``stablehlo.dot_general``;
    0 for one that contracts nothing (an outer or broadcast product,
    which the port computes as an elementwise multiply)."""
    m = _CONTRACT.search(line)
    if m is None or not m.group(1).strip():
        return 0
    ins, out = line[line.rindex(" : (") + 4:].split(") -> ")
    lhs = _dims(_TENSOR.findall(ins)[0])
    k = math.prod(lhs[int(i)] for i in m.group(1).split(","))
    return 2 * math.prod(_dims(_TENSOR.search(out).group(1))) * k


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip())


def _trip_count(cond: list[str]) -> int:
    """A scan's loop: ``while i < N`` from 0, N a constant of the cond."""
    consts = dict(m.groups() for m in map(_CONST.search, cond) if m)
    for line in cond:
        m = _LT.search(line)
        if m:
            return int(consts[m.group(2)])
    raise ValueError(f"no trip count in {cond}")


def _body_flops(lines, funcs, memo) -> int:
    total, i = 0, 0
    while i < len(lines):
        line = lines[i]
        assert "stablehlo.case" not in line and "stablehlo.if" not in line
        if "stablehlo.while(" in line:
            ind = _indent(line)
            do = next(j for j in range(i + 1, len(lines))
                      if lines[j].strip() == "} do {"
                      and _indent(lines[j]) == ind)
            end = next(j for j in range(do + 1, len(lines))
                       if lines[j].strip() == "}" and _indent(lines[j]) == ind)
            total += _trip_count(lines[i + 2:do]) * _body_flops(
                lines[do + 1:end], funcs, memo)
            i = end + 1
            continue
        if "stablehlo.dot_general" in line:
            total += _dot_flops(line)
        m = _CALL.search(line)
        if m:
            total += _func_flops(m.group(1), funcs, memo)
        i += 1
    return total


def _func_flops(name, funcs, memo) -> int:
    if name not in memo:
        memo[name] = _body_flops(funcs[name], funcs, memo)
    return memo[name]


def hlo_dot_flops(text: str) -> int:
    """The dot-product FLOPs one call of ``main`` executes."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif line == "  }":
            cur = None
        elif cur is not None:
            cur.append(line)
    return _func_flops("main", funcs, {})


def test_hlo_count_weighs_calls_and_loops():
    text = """module @m {
  func.func public @main(%arg0: tensor<2x3xf32>) -> (tensor<2x5xf32>) {
    %0 = stablehlo.dot_general %arg0, %arg1, contracting_dims = [1] x [0] : (tensor<2x3xf32>, tensor<3x5xf32>) -> tensor<2x5xf32>
    %1:2 = stablehlo.while(%iterArg = %arg0, %iterArg_1 = %c) : tensor<2x3xf32>, tensor<i32>
    cond {
      %c_2 = stablehlo.constant dense<4> : tensor<i32>
      %2 = stablehlo.compare  LT, %iterArg_1, %c_2,  SIGNED : (tensor<i32>, tensor<i32>) -> tensor<i1>
      stablehlo.return %2 : tensor<i1>
    } do {
      %3 = func.call @body(%iterArg) : (tensor<2x3xf32>) -> tensor<2x5xf32>
      stablehlo.return %iterArg, %iterArg_1 : tensor<2x3xf32>, tensor<i32>
    }
    %4 = call @body(%arg0) : (tensor<2x3xf32>) -> tensor<2x5xf32>
    %5 = stablehlo.dot_general %a, %b, batching_dims = [0] x [0], contracting_dims = [] x [] : (tensor<2x3xf32>, tensor<2x5xf32>) -> tensor<2x3x5xf32>
    return %0 : tensor<2x5xf32>
  }
  func.func private @body(%arg0: tensor<2x3xf32>) -> tensor<2x5xf32> {
    %0 = stablehlo.dot_general %arg0, %arg1, contracting_dims = [1] x [0] : (tensor<2x3xf32>, tensor<3x5xf32>) -> tensor<2x5xf32>
    return %0 : tensor<2x5xf32>
  }
}"""
    one = 2 * 2 * 5 * 3
    assert hlo_dot_flops(text) == one + 4 * one + one


@pytest.mark.parametrize("arch,shape", CELLS)
def test_traced_flops_equal_the_references_dot_products(arch, shape,
                                                        monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    _small_shapes(monkeypatch)
    jcell = jspecs.build_cell(jconfigs.get_reduced(arch), arch, shape,
                              scan_layers=False)
    want = hlo_dot_flops(
        jax.jit(jcell.step_fn).lower(*jcell.arg_specs).as_text())
    tcell = tspecs.build_cell(tconfigs.get_reduced(arch), arch, shape)
    with FlopCounterMode(display=False) as counter:
        tcell.step_fn(*tcell.arg_specs)
    assert counter.get_total_flops() == want > 0
    assert dryrun.trace_cell(tcell).flops == want


# -- (d), (e) the 16-device mesh ------------------------------------------------

NARROW = dict(d_model=128, d_ff=256, n_heads=8, n_kv_heads=4, vocab=256)
MESH_2x2x4 = {"pod": 2, "data": 2, "model": 4}

SUB = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import dataclasses, json
import jax
from repro.analysis.roofline import parse_collectives
from repro.configs import get_reduced
from repro.launch import specs
from repro.launch.mesh import auto_axis_kwargs
from repro.models import config as mc
from repro.parallel import sharding as sh

for name in ("train_4k", "decode_32k"):
    old = mc.SHAPES[name]
    mc.SHAPES[name] = mc.ShapeConfig(name, old.kind, 64, 8)
mesh = jax.make_mesh((2, 2, 4), ("pod", "data", "model"),
                     **auto_axis_kwargs(3))
plan = sh.make_plan(mesh)
cfg = dataclasses.replace(get_reduced("granite-3-2b"), **NARROW)
out = {}
for shape in ("train_4k", "decode_32k"):
    cell = specs.build_cell(cfg, "granite-3-2b", shape, mesh=mesh)
    p = cell.arg_specs[0]
    if cell.kind == "train":
        in_sh = (sh.param_shardings(plan, p),
                 sh.opt_state_shardings(plan, p, cell.arg_specs[1]),
                 sh.batch_shardings(plan, cell.arg_specs[2]))
        out_sh = (in_sh[0], in_sh[1], None)
    else:
        cache = sh.cache_shardings(plan, cell.arg_specs[1])
        in_sh = (sh.param_shardings(plan, p), cache,
                 sh.batch_shardings(plan, cell.arg_specs[2]))
        out_sh = (None, None, cache)
    with mesh:
        compiled = jax.jit(cell.step_fn, in_shardings=in_sh,
                           out_shardings=out_sh).lower(
                               *cell.arg_specs).compile()
    ma = compiled.memory_analysis()
    coll = parse_collectives(compiled.as_text())
    out[shape] = {"argument_bytes": int(ma.argument_size_in_bytes),
                  "collectives": coll.count_by_kind,
                  "collective_bytes": coll.bytes_by_kind}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def xla_2x2x4():
    code = f"NARROW = {NARROW!r}\n" + SUB
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _narrow_cell(monkeypatch, shape):
    for name in ("train_4k", "decode_32k"):
        old = tmc.SHAPES[name]
        monkeypatch.setitem(tmc.SHAPES, name,
                            tmc.ShapeConfig(name, old.kind, 64, 8))
    cfg = dataclasses.replace(tconfigs.get_reduced("granite-3-2b"),
                              **NARROW)
    plan = tsh.make_plan(tsh.AxisMesh(MESH_2x2x4))
    return cfg, tspecs.build_cell(cfg, "granite-3-2b", shape), plan


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_argument_bytes_equal_xla_memory_analysis(shape, xla_2x2x4,
                                                  monkeypatch):
    _, cell, plan = _narrow_cell(monkeypatch, shape)
    got = dryrun.layout_bytes(cell.arg_specs,
                              dryrun.argument_layouts(cell, plan), plan)
    assert got == xla_2x2x4[shape]["argument_bytes"]


def test_collective_schedule_equals_a_hand_count(xla_2x2x4, monkeypatch):
    cfg, cell, plan = _narrow_cell(monkeypatch, "train_4k")
    counts, ops = dryrun.collective_schedule(
        cfg, cell, plan, dryrun.trace_cell(cell).read)
    # granite narrowed: 2 layers, d 128, 8 heads of 16 (4 kv), d_ff 256,
    # tied vocab 256; float32 parameters, batch 8 × 64 tokens.
    # FSDP-sharded (data axis): embed and the 7 stacked weights; the
    # norms (final, and 2 a layer) are replicated.
    L, tokens = 2, 8 * 64 // 4                  # DP 4 = pod 2 × data 2
    stacked = 7
    want = {
        # embed once; each stacked weight a layer, and again in remat
        "all-gather": 1 + stacked * L * 2,
        # each FSDP gradient over data
        "reduce-scatter": 1 + stacked * L,
        # each FSDP gradient over pod, each replicated one over DP
        # (1 final norm + 2 norms × L), and wo / w2 each layer forward,
        # in the recompute and backward
        "all-reduce": (1 + stacked * L) + (1 + 2 * L) + 2 * L * 3,
        "all-to-all": 0, "collective-permute": 0,
    }
    assert counts == want
    f32, bf16 = 4, 2
    # per layer, gathered over data and still split over model (4)
    per_layer = {"wq": 128 * 128, "wk": 128 * 64, "wv": 128 * 64,
                 "wo": 128 * 128, "w1": 128 * 256, "w3": 128 * 256,
                 "w2": 256 * 128}
    gathered = 256 * 128 // 4 + 2 * L * sum(per_layer.values()) // 4
    shards = 256 * 128 // 8 + L * sum(per_layer.values()) // 8
    replicated = 128 + 2 * L * 128
    by_kind = {k: 0 for k in want}
    for kind, _, nbytes in ops:
        by_kind[kind] += nbytes
    assert by_kind["all-gather"] == gathered * f32
    assert by_kind["reduce-scatter"] == shards * f32
    assert by_kind["all-reduce"] == (shards + replicated) * f32 \
        + 2 * L * 3 * tokens * 128 * bf16
    # the reference's schedule for the same cell, beside it (pytest -rP)
    ref = xla_2x2x4["train_4k"]
    print(f"2x2x4 granite train: port {counts} {by_kind} | reference HLO "
          f"{ref['collectives']} {ref['collective_bytes']}")


def test_meshes_and_link_rates():
    assert mesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert mesh.make_debug_mesh().shape == {"data": 2, "model": 2}
    assert mesh.card_mesh().shape == {"data": 1, "model": 1}
    h = mesh.H100_SXM
    m = tsh.AxisMesh(MESH_2x2x4)
    # 4 and 2 × 4 consecutive GPUs lie in one node; pods do not
    assert dryrun.link_bandwidth(m, ("model",)) == h["nvlink_bandwidth"]
    assert dryrun.link_bandwidth(m, ("data",)) == h["nvlink_bandwidth"]
    assert dryrun.link_bandwidth(m, ("pod",)) == h["internode_bandwidth"]
    prod = mesh.make_production_mesh()
    assert dryrun.link_bandwidth(prod, ("model",)) == \
        h["internode_bandwidth"]


# -- (f) full width --------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-large-v3"])
def test_full_width_decode_traces_on_meta(arch):
    rec, trace = dryrun.lower_cell(arch, "decode_32k", mesh="card")
    assert rec["status"] == "ok", rec
    cell = tspecs.build_cell(tconfigs.get_config(arch), arch, "decode_32k")
    args = sum(t.numel() * t.element_size()
               for t in tree.leaves(cell.arg_specs))
    ma = rec["memory_analysis"]
    assert ma["argument_bytes"] == args
    assert ma["temp_bytes"] == trace.step_peak_bytes > 0
    assert rec["peak_bytes"] == args + trace.step_peak_bytes
    assert rec["collective_schedule"] == dict.fromkeys(
        dryrun.COLLECTIVES, 0)
    # the same trace over the production mesh: no temp, collectives
    multi, _ = dryrun.lower_cell(arch, "decode_32k", mesh="2x16x16",
                                 trace=trace)
    assert multi["memory_analysis"]["temp_bytes"] is None
    assert "fits_card" not in multi
    assert multi["roofline"]["flops_per_device"] * 512 == trace.flops
    assert multi["collective_schedule"]["all-gather"] > 0


def test_cli_card_mesh_mamba2(tmp_path):
    out = tmp_path / "cells.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "card", "--arch", "mamba2-130m", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    recs = {r["shape"]: r for r in map(json.loads,
                                        out.read_text().splitlines())}
    assert sorted(recs) == sorted(tmc.SHAPES)
    for shape, rec in recs.items():
        assert rec["status"] == "ok", rec
        assert rec["mesh"] == "card" and rec["n_devices"] == 1
        ma = rec["memory_analysis"]
        assert rec["peak_bytes"] == ma["argument_bytes"] + ma["temp_bytes"]
        assert rec["fits_card"] == (rec["peak_bytes"] < 80e9)
        assert rec["roofline"]["collective_s"] == 0
    train = recs["train_4k"]
    assert train["kind"] == "train" and not train["fits_card"]
    assert 0 < train["useful_flops_ratio"] <= 1
    assert recs["long_500k"]["fits_card"]


def test_a_cell_whose_trace_raises_is_an_error_on_every_mesh(monkeypatch):
    calls = []

    def boom(cell):
        calls.append(cell.arch)
        raise RuntimeError("no meta kernel")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    lines = []
    recs = dryrun.run(["granite-3-2b"], ["decode_32k", "long_500k"],
                      ["card", "16x16"], emit=lines.append)
    assert calls == ["granite-3-2b"]            # traced once, not per mesh
    assert [(r["shape"], r["mesh"], r["status"]) for r in recs] == [
        ("decode_32k", "card", "error"), ("decode_32k", "16x16", "error"),
        ("long_500k", "card", "skip"), ("long_500k", "16x16", "skip")]
    assert "no meta kernel" in recs[0]["error"]
    assert lines[0].startswith("[FAIL] granite-3-2b × decode_32k × card")
