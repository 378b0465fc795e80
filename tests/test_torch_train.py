"""The port's train step (``models/steps.make_train_step``, AdamW,
remat, gradient accumulation) against the reference's, for the attention
architectures without a mixer or experts (dense, GQA, the VLM with query
and key norms, the enc-dec), each at its reduced config on the CPU in
float32, through ``tests/_model_parity.py``: the loss and every
gradient leaf on one batch, a five-step trajectory of
``synthetic_batch`` batches, remat on against off, and
``accum_steps=2`` against the reference's. Also the port of the
reference's train-step smoke and loss-decrease tests
(``tests/test_models.py``) for every architecture, and a check that
serving never takes the remat wrapper.
"""

import jax
import numpy as np
import pytest
import torch

from _model_parity import (build_train_case, check_accum, check_grads,
                           check_remat_equal, check_train_trajectory)
from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.steps import make_train_step
from repro_torch.optim import AdamW

ARCHS = ["granite-3-2b", "chatglm3-6b", "llama3-405b", "nemotron-4-15b",
         "chameleon-34b", "whisper-large-v3"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return build_train_case(request.param)


def test_loss_and_gradients_match_reference(case):
    check_grads(case)


def test_five_step_trajectory_matches_reference(case):
    check_train_trajectory(case)


def test_remat_on_equals_off(case):
    check_remat_equal(case)


def test_accum_steps_two_matches_reference(case):
    check_accum(case)


# -- the reference's own smoke tests, on the port -----------------------------

def _params(arch, seed):
    cfg = jconfigs.get_reduced(arch)
    return params_from_numpy(jax.tree.map(
        np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(seed))))


def _batch(cfg, seed, B=2, S=48):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_smoke_train_step(arch):
    cfg = tconfigs.get_reduced(arch)
    params = _params(arch, 0)
    before = [t.clone() for t in tree.leaves(params)]
    batch = _batch(cfg, 0)
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt, compute_dtype=torch.float32)
    params2, state, metrics = step(params, opt.init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(state["step"]) == 1
    # parameters actually moved
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree.leaves(params2)))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_train_loss_decreases(arch):
    cfg = tconfigs.get_reduced(arch)
    params = _params(arch, 2)
    batch = _batch(cfg, 2, B=4, S=32)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    step = make_train_step(cfg, opt, compute_dtype=torch.float32)
    state = opt.init(params)
    losses = []
    for _ in range(5):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_serving_never_takes_the_remat_wrapper(monkeypatch):
    """Serving's parameters require no grad, so the layer loop runs
    plainly under the default ``remat=True``: ``run_serving``'s tokens
    and logits are those of a run with the wrapper removed, and the
    wrapper is never called. Training takes it once a layer."""
    calls = []
    real = tmodel.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tmodel, "checkpoint", counting)
    trace = {}
    out, _ = tserve.run_serving(arch="granite-3-2b", batch=2,
                                prompt_len=16, new_tokens=4, verbose=False,
                                device="cpu", trace=trace)
    assert calls == []
    assert not any(t.requires_grad for t in tree.leaves(trace["params"]))
    cfg = trace["cfg"]
    logits = tmodel.forward(cfg, trace["params"], trace["prompts"],
                            compute_dtype=torch.float32)
    assert calls == [] and not logits.requires_grad
    # with grad on the parameters the forward takes the wrapper per layer
    for t in tree.leaves(trace["params"]):
        t.requires_grad_(True)
    again = tmodel.forward(cfg, trace["params"], trace["prompts"],
                           compute_dtype=torch.float32)
    assert len(calls) == cfg.n_layers
    assert torch.equal(again.detach(), logits)
    monkeypatch.setattr(tmodel, "checkpoint", real)
    out2, _ = tserve.run_serving(arch="granite-3-2b", batch=2,
                                 prompt_len=16, new_tokens=4, verbose=False,
                                 device="cpu")
    assert torch.equal(out, out2)
