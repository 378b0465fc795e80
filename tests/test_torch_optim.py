"""The port's AdamW and cosine schedule (``optim/adamw.py``) against the
reference's, on the CPU.

``update`` runs on random trees (nested dicts and a list, a bf16
parameter among float32 ones, leaves of very different scales) given the
same gradients and state, with float32 and with bf16 moments, over
three steps; every output — parameters, ``m``, ``v``, the step and the
pre-clip gradient norm — must lie within 1e-6 of its largest reference
value. The leaf order of the norm's sum is the reference's (dict keys
sorted), whatever the port's dict order. Also the reference's own three
optimizer tests (``tests/test_components.py``) on the port, and the
in-place contract: the parameters and moments are written in place, the
gradients passed to ``update`` are left as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro_torch import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW, cosine_schedule

REL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if x.dtype == jnp.bfloat16 else x)


def _close(got, want, ctx):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, ctx
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{ctx}: {err:.3e} against {scale:.3e}"


def _tree(rng, scale=1.0):
    # keys out of sorted order, so insertion and JAX order differ
    return {"w": rng.normal(0, scale, (16, 8)).astype(np.float32),
            "b": {"z": rng.normal(0, 3 * scale, (8,)).astype(np.float32),
                  "a": rng.normal(0, 1e-3 * scale, (4, 4)).astype(
                      np.float32)},
            "layers": [rng.normal(0, scale, (3, 5)).astype(np.float32),
                       rng.normal(0, scale, (7,)).astype(np.float32)]}


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_update_matches_reference(state_dtype, clip):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    params["half"] = rng.normal(0, 1, (6,)).astype(jnp.bfloat16)
    jopt = JAdamW(lr=jcosine(3e-3, warmup=2, total=5), weight_decay=0.01,
                  clip_norm=clip, state_dtype=getattr(jnp, state_dtype))
    topt = AdamW(lr=cosine_schedule(3e-3, warmup=2, total=5),
                 weight_decay=0.01, clip_norm=clip,
                 state_dtype=getattr(torch, state_dtype))
    jp = _to_jax(params)
    js = jopt.init(jp)
    tp = params_from_numpy(params)
    ts = topt.init(tp)
    for step in range(3):
        grads = _tree(rng, scale=10.0 ** step)
        grads["half"] = rng.normal(0, 1, (6,)).astype(jnp.bfloat16)
        tg = params_from_numpy(grads)
        kept = [g.clone() for g in tree.leaves(tg)]
        jp, js, jn = jopt.update(_to_jax(grads), js, jp)
        tp_before = tree.leaves(tp)
        tp, ts, tn = topt.update(tg, ts, tp)
        ctx = f"{state_dtype} clip {clip} step {step}"
        _close(tn, jn, f"{ctx} grad_norm")
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for name, got, want in zip(
                [n for n, _ in tree.flatten_with_names(tp)],
                tree.leaves(tp), jax.tree.leaves(jp)):
            assert str(got.dtype).endswith(str(want.dtype)), name
            _close(got, want, f"{ctx} param {name}")
        for part in ("m", "v"):
            for got, want in zip(tree.leaves(ts[part]),
                                 jax.tree.leaves(js[part])):
                assert got.dtype == getattr(torch, state_dtype)
                _close(got, want, f"{ctx} {part}")
        # written in place; the gradients left as they were
        assert all(a is b for a, b in zip(tp_before, tree.leaves(tp)))
        assert all(torch.equal(a, b) for a, b in zip(kept,
                                                     tree.leaves(tg)))


def test_cosine_schedule_matches_reference():
    for warmup, total in ((10, 110), (0, 7), (5, 5), (3, 2)):
        jl, tl = jcosine(2e-3, warmup, total), cosine_schedule(2e-3, warmup,
                                                              total)
        for step in range(0, total + 4):
            want = float(jl(step))
            got = tl(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= 1e-6 * 2e-3, (warmup, total,
                                                          step)
            assert float(tl(step)) == float(got)


# -- the reference's three optimizer tests, on the port -----------------------

def test_adamw_converges_on_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(100):
        g = {"w": 2 * params["w"]}
        params, state, _ = opt.update(g, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_grad_clipping_bounds_update():
    opt = AdamW(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    huge = {"w": torch.full((3,), 1e9)}
    _, _, gnorm = opt.update(huge, state, params)
    assert float(gnorm) > 1e8  # reported pre-clip norm


def test_cosine_schedule():
    lr = cosine_schedule(1.0, warmup=10, total=110)
    assert float(lr(5)) == pytest.approx(0.5)
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(110)) == pytest.approx(0.0, abs=1e-6)


def test_update_flat_frees_each_gradient():
    opt = AdamW(lr=1e-2)
    params = {"b": torch.ones(3), "a": torch.ones(2)}
    state = opt.init(params)
    grads = [torch.full((2,), 0.5), torch.full((3,), 2.0)]  # a, then b
    _, state, gnorm = opt.update_flat(grads, state, params)
    assert grads == [None, None]
    assert float(gnorm) == pytest.approx(float(np.sqrt(2 * 0.25 + 3 * 4)))
    assert torch.all(params["a"] < 1) and torch.all(params["b"] < 1)
