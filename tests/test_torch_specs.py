"""The port's host tables against the reference's, for every
architecture × ``SHAPES`` cell, on the CPU: ``launch/specs.build_cell``
(kinds, skip reasons, and each argument tree's leaf names, shapes and
dtypes, as meta tensors, against ``jax.eval_shape``'s), the analytic
memory model (``analysis/memtraffic.analyze_memory``, bytes equal, and
``fits_hbm`` against the capacity it is given), ``roofline.model_flops``
and the sharding rule tables (``parallel/sharding.py``: ``_spec`` and
each tensor's spec from ``param_shardings``, ``opt_state_shardings``,
``batch_shardings`` and ``cache_shardings`` on fake (16, 16) and
(2, 16, 16) meshes, the reference's ``_named`` and ``NamedSharding``
monkeypatched to return the bare spec). Also the reference's own rule,
memory and FLOP tests (``tests/test_sharding.py``,
``tests/test_components.py``) on the port.
"""

import itertools

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import memtraffic as jmem
from repro.analysis.roofline import model_flops as jflops
from repro.launch import specs as jspecs
from repro.models.config import SHAPES as JSHAPES
from repro.parallel import sharding as jsh
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.analysis import memtraffic as tmem
from repro_torch.analysis.roofline import H100_SXM
from repro_torch.analysis.roofline import model_flops as tflops
from repro_torch.launch import specs as tspecs
from repro_torch.models.config import SHAPES
from repro_torch.parallel import sharding as tsh

ARCHS = jconfigs.ARCHS
CELLS = list(itertools.product(ARCHS, sorted(SHAPES)))
TPU_HBM = 16 * 2**30


def _jax_leaves(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), leaf) for path, leaf in flat]


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_matches_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in sorted(SHAPES):
        want = jspecs.build_cell(jcfg, arch, shape)
        got = tspecs.build_cell(tcfg, arch, shape)
        ctx = (arch, shape)
        assert (got.kind, got.skip_reason, got.donate_argnums) == \
            (want.kind, want.skip_reason, want.donate_argnums), ctx
        assert (got.step_fn is None) == (want.step_fn is None), ctx
        assert len(got.arg_specs) == len(want.arg_specs), ctx
        for g, w in zip(got.arg_specs, want.arg_specs):
            gl, wl = tree.flatten_with_names(g), _jax_leaves(w)
            assert [n for n, _ in gl] == [n for n, _ in wl], ctx
            for (name, a), (_, b) in zip(gl, wl):
                assert a.device.type == "meta", (ctx, name)
                assert tuple(a.shape) == tuple(b.shape), (ctx, name)
                assert _dtype(a.dtype) == str(b.dtype), (ctx, name)


def test_specs_allocate_nothing():
    cfg = tconfigs.get_config("llama3-405b")
    cell = tspecs.build_cell(cfg, "llama3-405b", "train_4k")
    params, opt, batch = cell.arg_specs
    n = sum(t.numel() for t in tree.leaves(params))
    assert n > 4e11
    assert all(t.device.type == "meta" for t in tree.leaves(cell.arg_specs))
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0
    with pytest.raises(ValueError, match="meta"):
        from repro_torch.models.model import init_params
        init_params(cfg, None, device="cpu")


MESHES = [(256, 16, 16), (1, 1, 1), (512, 32, 16), (16, 4, 4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_model_matches_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape, (n, dp, tp), accum in itertools.product(
            sorted(SHAPES), MESHES, (1, 4)):
        kind = SHAPES[shape].kind
        kw = dict(n_devices=n, dp=dp, tp=tp, kind=kind, accum_steps=accum)
        want = jmem.analyze_memory(jcfg, JSHAPES[shape], **kw)
        got = tmem.analyze_memory(tcfg, SHAPES[shape], **kw)
        ctx = (arch, shape, n, accum)
        assert got.traffic_bytes == want.traffic_bytes, ctx
        assert got.residency_bytes == want.residency_bytes, ctx
        assert got.detail == want.detail, ctx
        assert got.hbm_bytes == H100_SXM["hbm_bytes"] == 80e9
        assert got.fits_hbm == (got.residency_bytes < 80e9), ctx
        tpu = tmem.analyze_memory(tcfg, SHAPES[shape], hbm_bytes=TPU_HBM,
                                  **kw)
        assert tpu.fits_hbm == want.fits_hbm, ctx


def test_memtraffic_residency():
    """The reference's own assertions, at the TPU v5e's 16 GiB; the same
    cell on one H100 fails too."""
    cfg = tconfigs.get_config("llama3-405b")
    m = tmem.analyze_memory(cfg, SHAPES["decode_32k"], n_devices=256,
                            dp=16, tp=16, kind="decode", hbm_bytes=TPU_HBM)
    assert m.fits_hbm, m.residency_bytes / 2**30
    m1 = tmem.analyze_memory(cfg, SHAPES["decode_32k"], n_devices=1, dp=1,
                             tp=1, kind="decode", hbm_bytes=TPU_HBM)
    assert not m1.fits_hbm
    h100 = tmem.analyze_memory(cfg, SHAPES["decode_32k"], n_devices=1,
                               dp=1, tp=1, kind="decode")
    assert not h100.fits_hbm


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_matches_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for train in (True, False):
        assert tflops(tcfg, SHAPES[shape], train=train) == \
            jflops(jcfg, JSHAPES[shape], train=train)


def test_model_flops_estimates():
    cfg = tconfigs.get_config("llama3-405b")
    mf = tflops(cfg, SHAPES["train_4k"], train=True)
    # 6 · 405e9 · (256·4096) ≈ 2.5e18
    assert 2.0e18 < mf < 3.2e18, mf
    mf_dec = tflops(cfg, SHAPES["decode_32k"], train=False)
    assert mf_dec < mf / 1e4


# -- sharding rule tables -----------------------------------------------------

class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


FAKE = {"16x16": {"data": 16, "model": 16},
        "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture
def bare_ref(monkeypatch):
    """The reference's rules returning the bare spec, not a
    ``NamedSharding`` over a device mesh."""
    monkeypatch.setattr(jsh, "_named",
                        lambda plan, shape, axes: jsh._spec(plan, shape,
                                                            axes))
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)


def _plans(mesh_name, **kw):
    return (jsh.make_plan(FakeMesh(FAKE[mesh_name]), **kw),
            tsh.make_plan(tsh.AxisMesh(FAKE[mesh_name]), **kw))


class _Spec:
    """A reference spec as an opaque leaf of a JAX tree."""

    def __init__(self, spec):
        self.entries = tuple(spec)


def _same_specs(got_tree, want_tree, ctx):
    got = tree.flatten_with_names(got_tree)
    want = _jax_leaves(jax.tree.map(
        _Spec, want_tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert [n for n, _ in got] == [n for n, _ in want], ctx
    for (name, g), (_, w) in zip(got, want):
        assert isinstance(g, tsh.PartitionSpec), (ctx, name)
        assert tuple(g) == w.entries, (ctx, name, g, w.entries)


@pytest.mark.parametrize("mesh_name", sorted(FAKE))
def test_spec_matches_reference(mesh_name):
    jplan, tplan = _plans(mesh_name)
    assert jplan.dp_axes == tplan.dp_axes
    assert jplan.dp_size == tplan.dp_size
    dims = [1, 2, 8, 16, 20, 32, 48, 256, 49155, 2048]
    axes = [None, "data", "model", "pod", ("data", "model"),
            ("pod", "data")]
    for shape in itertools.product(dims, repeat=2):
        for ax in itertools.product(axes, repeat=2):
            if "pod" in str(ax) and "pod" not in FAKE[mesh_name]:
                continue
            for strict in (True, False):
                want = jsh._spec(jplan, shape, ax, strict=strict)
                got = tsh._spec(tplan, shape, ax, strict=strict)
                assert tuple(got) == tuple(want), (shape, ax, strict)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", sorted(FAKE))
def test_shardings_match_reference(arch, mesh_name, bare_ref):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape_name in ("train_4k", "decode_32k", "long_500k"):
        jplan, tplan = _plans(mesh_name,
                              shard_sequence=shape_name == "long_500k")
        shape = SHAPES[shape_name]
        jp = jspecs.params_specs(jcfg)
        tp = tspecs.params_specs(tcfg)
        ctx = (arch, mesh_name, shape_name)
        _same_specs(tsh.param_shardings(tplan, tp),
                    jsh.param_shardings(jplan, jp), ctx)
        _same_specs(tsh.opt_state_shardings(tplan, tp, None),
                    jsh.opt_state_shardings(jplan, jp, None), ctx)
        _same_specs(tsh.batch_shardings(tplan,
                                        tspecs.batch_specs(tcfg, shape)),
                    jsh.batch_shardings(jplan,
                                        jspecs.batch_specs(jcfg, shape)),
                    ctx)
        if shape.kind == "decode":
            _same_specs(tsh.cache_shardings(tplan,
                                            tspecs.cache_specs(tcfg, shape)),
                        jsh.cache_shardings(jplan,
                                            jspecs.cache_specs(jcfg, shape)),
                        ctx)


def test_sharding_rules_divisibility_guards():
    plan = tsh.MeshPlan(FakeMesh({"data": 16, "model": 16}), ("data",))
    # strict: 49155 not divisible by 16 → dropped
    assert tsh._spec(plan, (49155, 2048), ("model", "data"))[0] is None
    # relaxed: kept (padded)
    assert tsh._spec(plan, (49155, 2048), ("model", "data"),
                     strict=False)[0] == "model"
    # dim smaller than axis: always dropped
    assert tsh._spec(plan, (8, 64), ("model", None),
                     strict=False)[0] is None
    assert tsh._spec(plan, (2048, 512), (None, "model"))[1] == "model"


def test_constraints_are_the_identity_without_a_mesh():
    x = torch.ones(2, 3)
    assert tsh.constrain(None, x, ("data", None)) is x
    assert tsh.head_constraint(None, x) is x
    assert tsh.logits_constraint(None, x) is x
    mesh = tsh.AxisMesh({"data": 2, "model": 2})
    assert tsh.dp_axes_of(mesh) == ("data",)
    # an AxisMesh names axes and has no devices to lay a tensor over
    with pytest.raises(TypeError, match="needs a DeviceMesh"):
        tsh.constrain(mesh, x, ("data", None))
