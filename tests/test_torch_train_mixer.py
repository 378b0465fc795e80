"""The port's train step against the reference's for the architectures
with a Mamba2 mixer or experts (SSM, the hybrid, the two MoEs, whose
dispatch scatters with ``index_put_(accumulate=True)``), as
``tests/test_torch_train.py`` holds the others (through
``tests/_model_parity.py``). Also the one place the engines differ: at
mamba2-130m's published widths a chunk of 128 tokens overflows the
reference's intra-chunk decay, whose gradient is then NaN; the port's
stays finite and equals the reference's wherever that is finite."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.train import synthetic_batch as jbatch
from repro.models import model as jmodel
from repro.models import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.launch.train import synthetic_batch as tbatch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.steps import make_grad_fn

from _model_parity import (build_train_case, check_accum, check_grads,
                           check_remat_equal, check_train_trajectory)

ARCHS = ["mamba2-130m", "hymba-1.5b", "qwen3-moe-235b-a22b",
         "granite-moe-1b-a400m"]


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


@pytest.mark.parametrize("S", [64, 128])
def test_ssd_gradient_stays_finite_past_the_float32_exp_range(S):
    """One mamba2-130m layer at its published widths, batch 1: at 64
    tokens both packages' gradients are finite and agree; at 128 the
    reference's are not (``exp`` of the masked decay overflows, and
    ``where``'s backward makes 0 · inf), the port's are, and they agree
    with the reference's on every leaf the reference keeps finite. At
    128 every leaf of the port's (at its own chunk) is also held against
    the reference's at a chunk of 64 tokens, whose ``exp`` does not
    overflow: chunked SSD is the same function at any chunk. The losses
    agree at both lengths."""
    cfg_j = dataclasses.replace(jconfigs.get_config("mamba2-130m"),
                                n_layers=1)
    cfg_t = dataclasses.replace(tconfigs.get_config("mamba2-130m"),
                                n_layers=1)
    params = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    loss_j, grads_j = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(
        cfg_j, compute_dtype=jnp.float32)))(params, jbatch(cfg_j, 0, 1, S))
    loss_t, grads_t = make_grad_fn(cfg_t, compute_dtype=torch.float32)(
        params_from_numpy(jax.tree.map(np.asarray, params)),
        tbatch(cfg_t, 0, 1, S, "cpu"))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    names = [n for n, _ in tree.flatten_with_names(
        params_from_numpy(jax.tree.map(np.asarray, params)))]
    ref_finite = 0
    for name, g, w in zip(names, grads_t, jax.tree.leaves(grads_j)):
        w = np.asarray(w)
        assert torch.isfinite(g).all(), name
        if not np.isfinite(w).all():
            continue
        ref_finite += 1
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, name
    assert ref_finite == (len(names) if S == 64 else 5), ref_finite
    if S == 64:
        return
    cfg_64 = dataclasses.replace(cfg_j, ssm_chunk=64)
    loss_64, grads_64 = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(
        cfg_64, compute_dtype=jnp.float32)))(params, jbatch(cfg_64, 0, 1, S))
    assert abs(float(loss_t) - float(loss_64)) <= 1e-5 * abs(float(loss_64))
    for name, g, w in zip(names, grads_t, jax.tree.leaves(grads_64)):
        w = np.asarray(w)
        assert np.isfinite(w).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, name
