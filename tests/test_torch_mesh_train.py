"""The port's train step over a 2×2 (data, model) device mesh — four gloo
ranks on the CPU, DTensors laid out by the rule tables — against the
reference's train step jitted over ``make_debug_mesh(2, 2)`` with the
same tables' in- and out-shardings, and against the port's own step
without a mesh (``tests/_mesh_parity.py``).

Bars: loss and ``grad_norm`` within 1e-5 relative, each updated
parameter leaf within 1e-4 of its largest value. Where the reference's
own sharded step differs from its unsharded one by more than a bar for
a config, that config is held to twice the reference's gap instead;
each case prints the bars it used (``pytest -s``).

One class of element is held apart. AdamW's first step moves an element
by ``lr · ĝ / (|ĝ| + eps)`` (``ĝ`` its clipped gradient), whose
derivative in ``ĝ`` is ``lr · eps / (|ĝ| + eps)²``: where ``|ĝ|`` is
within ``ILL * eps`` of zero (and not zero), the last bits of the gradient, which any
other summation order changes, move the update by up to ``2 · lr``. At
nemotron-4-15b's reduced widths an element with a gradient of 1.0e-7
(clipped: 1.1e-8, about eps) moves 2.2e-4 of its leaf's largest value
between the two orders. Those elements are held to ``2 · lr`` (the
widest an update can differ), every other element to the bar; ROADMAP
§3 gives the count.
"""

import dataclasses

import pytest
import torch

import _mesh_ranks as ranks
from _mesh_parity import (ARCHS, ILL, LEAF_REL, LOSS_REL, MeshRun,
                          leaf_errors, max_rel, reference_params, rel,
                          result, train_batch)
from repro_torch import tree
from repro_torch.launch import dryrun, specs as tspecs
from repro_torch.models import config as tmc
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.steps import make_grad_fn, make_train_step
from repro_torch.parallel import sharding as tsh

REF_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "mamba2-130m",
             "hymba-1.5b"]
ACCUM_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m"]
# the residual stream sequence-sharded over the model axis; mamba2's
# mixer then runs on a sequence-sharded input
SEQPAR_ARCHS = ["granite-3-2b", "mamba2-130m"]
NARROW = dict(d_model=128, d_ff=256, n_heads=8, n_kv_heads=4, vocab=256)
F32 = torch.float32
LR1 = 3e-4            # the trainer's rate at step 1 (3e-3 · 1/10 warm-up)


def _cases() -> list[dict]:
    cases = []
    for arch in ARCHS:
        params = reference_params(arch)
        batch = train_batch(arch, 0)
        # every config's reference runs, for its own sharded-versus-
        # unsharded gap; the port is held against it for REF_ARCHS
        cases.append(dict(name=f"train-{arch}", arch=arch, task="train",
                          params=params, batch=batch, ref=True))
        if arch in ACCUM_ARCHS:
            cases.append(dict(name=f"accum-{arch}", arch=arch, task="train",
                              params=params, batch=batch, accum=2,
                              ref=arch == "granite-3-2b"))
    for arch in SEQPAR_ARCHS:
        cases.append(dict(name=f"seqpar-{arch}", arch=arch, task="forward",
                          overrides=dict(seq_parallel=True),
                          params=reference_params(arch),
                          batch=train_batch(arch, 1),
                          ref=arch == "granite-3-2b"))
    narrow = reference_params("granite-3-2b", **NARROW)
    batch = train_batch("granite-3-2b", 2)
    batch["tokens"] %= NARROW["vocab"]
    batch["labels"] %= NARROW["vocab"]
    cases.append(dict(name="collectives", arch="granite-3-2b",
                      task="collectives", overrides=NARROW, params=narrow,
                      batch=batch))
    return cases


def _port_unsharded(case) -> dict:
    cfg = ranks.config(case)
    params = params_from_numpy(case["params"])
    batch = ranks.tensors(case["batch"])
    if case["task"] == "forward":
        return {"logits": tmodel.forward(cfg, params, batch["tokens"],
                                         compute_dtype=F32).numpy()}
    opt = ranks.trainer_optimizer()
    accum = case.get("accum", 1)
    _, grads = make_grad_fn(cfg, compute_dtype=F32, accum_steps=accum)(
        params, batch)
    step = make_train_step(cfg, opt, compute_dtype=F32, accum_steps=accum)
    p, _, m = step(params, opt.init(params), batch)
    # the elements whose first update is ill-conditioned in the gradient
    # (an exact zero is not: both sides move it by the decay alone)
    scale = min(1.0, opt.clip_norm / (float(m["grad_norm"]) + 1e-9))
    ill = [((g.abs() * scale < ILL * opt.eps) & (g != 0)).numpy()
           for g in grads]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": ranks.numpy_tree(p), "ill": ill}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    run = MeshRun(cases, tmp_path_factory.mktemp("mesh_train"))
    plain = {c["name"]: _port_unsharded(c) for c in cases
             if c["task"] in ("train", "forward")}
    port, ref = run.wait()
    return {"cases": {c["name"]: c for c in cases}, "port": port,
            "ref": ref, "plain": plain}


def _bar(bar: float, gap: float) -> float:
    return 2 * gap if gap > bar else bar


def _bars(ref_case, ill) -> tuple[float, float]:
    """(loss bar, leaf bar) of a config: the stated bars, or twice the
    reference's own sharded-versus-unsharded gap where that exceeds
    them (the gap over the well-conditioned elements, ``ill`` the
    others)."""
    mesh, plain = ref_case["mesh"], ref_case["plain"]
    gap_loss = max(rel(mesh["loss"], plain["loss"]),
                   rel(mesh["grad_norm"], plain["grad_norm"]))
    gap_leaf = max(leaf_errors(mesh["params"], plain["params"], ill)[0])
    return _bar(LOSS_REL, gap_loss), _bar(LEAF_REL, gap_leaf)


def _check_step(got, want, plain, bars, ctx):
    loss_bar, leaf_bar = bars
    ill = plain["ill"]
    n_ill = sum(int(m.sum()) for m in ill)
    print(f"{ctx}: bars loss/grad_norm {loss_bar:.3g}, leaves {leaf_bar:.3g}"
          f" ({n_ill} ill-conditioned elements, held to 2·lr)")
    assert rel(got["loss"], want["loss"]) <= loss_bar, \
        (ctx, got["loss"], want["loss"])
    assert rel(got["grad_norm"], want["grad_norm"]) <= loss_bar, \
        (ctx, got["grad_norm"], want["grad_norm"])
    well, rest = leaf_errors(got["params"], want["params"], ill)
    names = [n for n, _ in tree.flatten_with_names(want["params"])]
    bad = {n: e for n, e in zip(names, well) if e > leaf_bar}
    assert not bad, f"{ctx}: leaves past {leaf_bar:.3g}: {bad}"
    assert max(rest) <= 2 * LR1, (ctx, max(rest))


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_train_step_equals_the_references_sharded_step(runs, arch):
    name = f"train-{arch}"
    ref, plain = runs["ref"][name], runs["plain"][name]
    _check_step(result(runs["port"], name), ref["mesh"], plain,
                _bars(ref, plain["ill"]),
                f"{arch} against the reference's 2x2 step")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_ports_unsharded_step(runs, arch):
    name = f"train-{arch}"
    plain = runs["plain"][name]
    _check_step(result(runs["port"], name), plain, plain,
                _bars(runs["ref"][name], plain["ill"]),
                f"{arch} against the port without a mesh")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_keeps_the_rule_tables_placements(runs, arch):
    got = result(runs["port"], f"train-{arch}")
    assert got["faults"] == []
    assert got["step"] == 1


@pytest.mark.parametrize("arch", ACCUM_ARCHS)
def test_accumulated_step_over_the_mesh(runs, arch):
    name = f"accum-{arch}"
    got, plain = result(runs["port"], name), runs["plain"][name]
    bars = _bars(runs["ref"][f"train-{arch}"], runs["plain"][f"train-{arch}"]["ill"])
    _check_step(got, plain, plain, bars,
                f"{arch} accum 2 against the port without a mesh")
    if arch == "granite-3-2b":
        _check_step(got, runs["ref"][name]["mesh"], plain, bars,
                    f"{arch} accum 2 against the reference's 2x2 step")
    assert got["faults"] == []


@pytest.mark.parametrize("arch", SEQPAR_ARCHS)
def test_sequence_parallel_forward(runs, arch):
    name = f"seqpar-{arch}"
    got = result(runs["port"], name)["logits"]
    assert max_rel(got, runs["plain"][name]["logits"]) <= LEAF_REL
    if name in runs["ref"]:
        ref = runs["ref"][name]
        assert max_rel(ref["mesh"]["logits"], ref["plain"]["logits"]) \
            <= LEAF_REL
        assert max_rel(got, ref["mesh"]["logits"]) <= LEAF_REL


def test_device_mesh_refuses_a_mesh_of_another_size(runs):
    assert "4 ranks" in runs["port"]["_refusal"]


# -- the executed schedule against the dry run's model -----------------------

# What the 2×2 step issued on four gloo ranks (torch 2.13, CPU), each
# collective's output bytes on a rank, by kind: the weights' gathers at
# use (``use_weight`` and the embedding, tagged ``weight``) and every
# other collective, on rank 0 (mesh coordinate (0, 0)); and the
# point-to-point exchanges that put a column-parallel weight's chunks
# in order before its gather, on ranks 1 and 2 (the diagonal ranks
# 0 and 3 keep theirs). ROADMAP §3 (e) explains each difference from
# the model (``dryrun.collective_schedule``).
EXECUTED_WEIGHT = {"all-gather": (29, 1_245_184)}
EXECUTED_OTHER = {"all-gather": (52, 2_767_360),
                  "all-reduce": (31, 759_048),
                  "reduce-scatter": (46, 1_345_536)}
EXECUTED_PERMUTE = (30, 589_824)


def _by_kind(ops) -> dict:
    out: dict = {}
    for kind, _, nbytes in ops:
        n, b = out.get(kind, (0, 0))
        out[kind] = (n + 1, b + nbytes)
    return out


def test_collectives_against_the_dry_runs_schedule(runs, monkeypatch):
    """The narrowed granite cell (2 layers, d 128, 8 heads of 16, 4 kv,
    d_ff 256, tied vocab 256; float32; batch 4 × 32) on the 2×2 mesh:
    the executed train step's collectives, counted by ``CommDebugMode``
    (``tests/_mesh_ranks.CommBytes``), beside ``collective_schedule``'s
    for the same cell and mesh."""
    ranks_ops = result(runs["port"], "collectives")["ops"]
    permutes = [_by_kind(op for op in r if op[0] == "collective-permute")
                for r in ranks_ops]
    ops = [op for op in ranks_ops[0] if op[0] != "collective-permute"]
    weight = _by_kind(op for op in ops if op[1] == "weight")
    other = _by_kind(op for op in ops if op[1] != "weight")
    monkeypatch.setitem(tmc.SHAPES, "train_4k",
                        tmc.ShapeConfig("train_4k", "train", 32, 4))
    cfg = dataclasses.replace(ranks.config({"arch": "granite-3-2b"}),
                              **NARROW)
    cell = tspecs.build_cell(cfg, "granite-3-2b", "train_4k")
    plan = tsh.make_plan(tsh.AxisMesh({"data": 2, "model": 2}))
    counts, ops = dryrun.collective_schedule(
        cfg, cell, plan, dryrun.trace_cell(cell).read)
    model = _by_kind(ops)
    print(f"2x2 granite narrowed train step: executed weight gathers "
          f"{weight}, other {other}, point-to-point by rank {permutes} | "
          f"dryrun.collective_schedule {model}")
    # the one figure where XLA and the model agreed: the weights
    # gathered at use, over data, still split over model — on every rank
    for r in ranks_ops:
        assert _by_kind(op for op in r if op[1] == "weight"
                        and op[0] != "collective-permute") \
            == {"all-gather": model["all-gather"]}
    assert weight == EXECUTED_WEIGHT
    assert other == EXECUTED_OTHER
    assert permutes[0] == permutes[3] == {}
    assert permutes[1] == permutes[2] == {
        "collective-permute": EXECUTED_PERMUTE}
    assert counts["all-to-all"] == counts["collective-permute"] == 0
