"""Shared cases of ``tests/test_torch_models*.py``: the port's model
stack (``models/{model,decode}``) against the reference's at a reduced
config, on the CPU in float32. Not a test module itself.

``build_case`` builds the reference's parameters (converted to tensors
through ``models/convert.py``, never drawn twice), its forward logits,
its prefill logits and cache, and two decode steps, once an
architecture. Each port tensor must lie within 1e-4 × max |reference|
of the reference's. The port is also held against its own full forward,
as the reference's ``tests/test_models.py::test_prefill_decode_consistency``
holds the reference (2e-3 of the largest logit).

``build_train_case`` does the same for the train step
(``tests/test_torch_train*.py``): the reference's loss and gradients on
one batch, its jitted train step over a five-step trajectory of
``launch/train.synthetic_batch`` batches, and one step with
``accum_steps=2``, all in float32 under ``run_training``'s optimizer.
Loss and ``grad_norm`` must agree within 1e-5 relative, each gradient
leaf within 1e-4 of its largest reference value, and the trajectory's
losses within 1e-4 relative. The parameters after a step are not
compared element by element: AdamW's first step moves each element by
about ``lr · sign(g)``, so an element whose gradient is tiny beside its
leaf's largest flips its update on a 1e-7 difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.launch.train import synthetic_batch as jbatch
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.models import steps as jsteps
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine

from repro_torch import configs as tconfigs
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch import tree
from repro_torch.launch.train import make_trainer
from repro_torch.launch.train import synthetic_batch as tbatch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.steps import make_grad_fn

REL = 1e-4            # max |port − reference| over max |reference|
CONSISTENT = 2e-3     # prefill / decode against the full forward
B = 2
CACHE_KEYS = ("k", "v", "ssm_state", "conv_state", "cross_k", "cross_v")


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x)
                      else x, np.float32)


def close(got, want, ctx, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (ctx, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(scale, 1e-30), \
        f"{ctx}: max err {err:.3e} against max |want| {scale:.3e}"


def case_id(case) -> str:
    return f"{case[0]}-S{case[1]}"


def build_case(arch: str, S: int) -> dict:
    cfg_j = jconfigs.get_reduced(arch)
    cfg_t = tconfigs.get_reduced(arch)
    params_j = jmodel.init_params(cfg_j, jax.random.PRNGKey(1))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg_j.vocab, (B, S + 2)).astype(np.int32)
    frames = (rng.normal(0, 1, (B, cfg_j.enc_frames, cfg_j.d_model))
              .astype(np.float32) if cfg_j.enc_dec else None)
    f32 = dict(compute_dtype=jnp.float32)
    fj = None if frames is None else jnp.asarray(frames)
    ref = {"full": jmodel.forward(cfg_j, params_j, jnp.asarray(tokens),
                                  frames=fj, **f32)}
    ref["last"], cache = jdecode.prefill(
        cfg_j, params_j, jnp.asarray(tokens[:, :S]), frames=fj,
        max_len=S + 2, **f32)
    ref["cache0"] = cache
    for i in (1, 2):
        ref[f"dec{i}"], cache = jdecode.decode_step(
            cfg_j, params_j, cache, jnp.asarray(tokens[:, S + i - 1]), **f32)
        ref[f"cache{i}"] = cache
    ref = jax.tree.map(np.asarray, ref)
    ft = None if frames is None else torch.from_numpy(frames)
    return dict(arch=arch, S=S, cfg=cfg_t, params=params_t,
                tokens=torch.from_numpy(tokens), frames=ft, ref=ref)


def port_serve(c):
    """The port's prefill over S tokens, then two decode steps."""
    cfg, p, tok, S = c["cfg"], c["params"], c["tokens"], c["S"]
    f32 = dict(compute_dtype=torch.float32)
    out = {}
    out["last"], cache = tdecode.prefill(cfg, p, tok[:, :S],
                                         frames=c["frames"], max_len=S + 2,
                                         **f32)
    out["cache0"] = cache
    for i in (1, 2):
        out[f"dec{i}"], cache = tdecode.decode_step(
            cfg, p, cache, tok[:, S + i - 1], **f32)
        out[f"cache{i}"] = cache
    return out


def check_forward(case):
    got = tmodel.forward(case["cfg"], case["params"], case["tokens"],
                         frames=case["frames"], compute_dtype=torch.float32)
    close(got, case["ref"]["full"], f"{case['arch']} forward")


def check_serving(case):
    got, ref = port_serve(case), case["ref"]
    ctx = f"{case['arch']} S{case['S']}"
    for name in ("last", "dec1", "dec2"):
        close(got[name], ref[name], f"{ctx} {name} logits")
    for step in ("cache0", "cache1", "cache2"):
        g, r = got[step], ref[step]
        assert sorted(g) == sorted(r), (ctx, step, sorted(g), sorted(r))
        for key in CACHE_KEYS:
            if key in r:
                assert g[key].dtype == torch.float32, (ctx, step, key)
                close(g[key], r[key], f"{ctx} {step} {key}")
        assert g["pos"].dtype == torch.int32 and g["pos"].dim() == 0
        assert int(g["pos"]) == int(r["pos"]), (ctx, step)


def check_consistency(case):
    """The reference's own check, on the port: the last prefill logits
    and each decode step's equal the full forward at that position."""
    cfg, S = case["cfg"], case["S"]
    full = tmodel.forward(cfg, case["params"], case["tokens"],
                          frames=case["frames"], compute_dtype=torch.float32)
    got = port_serve(case)
    scale = float(full[:, S - 1].abs().max()) + 1e-9
    for name, at in (("last", S - 1), ("dec1", S), ("dec2", S + 1)):
        err = float((got[name] - full[:, at]).abs().max())
        assert err / scale < CONSISTENT, (case["arch"], name, err / scale)
    assert int(got["cache2"]["pos"]) == S + 2


# -- the train step -----------------------------------------------------------

LOSS_REL = 1e-5       # loss and grad_norm, relative
GRAD_REL = 1e-4       # each gradient leaf, of its max |reference|
TRAJ_REL = 1e-4       # the five-step loss trajectory, relative
TRAIN_STEPS, TRAIN_B, TRAIN_S = 5, 4, 32


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def build_train_case(arch: str) -> dict:
    """The reference's side of the train-step comparison, once an
    architecture; the port's converted parameters and batches beside
    it."""
    cfg_j = jconfigs.get_reduced(arch)
    cfg_t = tconfigs.get_reduced(arch)
    params_j = jmodel.init_params(cfg_j, jax.random.PRNGKey(1))
    batches = [jbatch(cfg_j, s, TRAIN_B, TRAIN_S)
               for s in range(TRAIN_STEPS)]
    f32 = dict(compute_dtype=jnp.float32)
    vg = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(cfg_j, **f32)))
    loss0, grads0 = vg(params_j, batches[0])
    opt = JAdamW(lr=jcosine(3e-3, warmup=10, total=TRAIN_STEPS),
                 weight_decay=0.01)
    step = jax.jit(jsteps.make_train_step(cfg_j, opt, **f32))
    p, state = params_j, opt.init(params_j)
    losses, norms = [], []
    for b in batches:
        p, state, m = step(p, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    acc = jax.jit(jsteps.make_train_step(cfg_j, opt, accum_steps=2, **f32))
    _, _, m2 = acc(params_j, opt.init(params_j), batches[0])
    params_np = jax.tree.map(np.asarray, params_j)
    return dict(arch=arch, cfg=cfg_t, params_np=params_np,
                loss0=float(loss0),
                grads0=[np.asarray(g) for g in jax.tree.leaves(grads0)],
                losses=losses, norms=norms,
                accum=(float(m2["loss"]), float(m2["grad_norm"])))


def port_params(case):
    """A fresh copy of the converted parameters (the update is in
    place)."""
    return params_from_numpy(case["params_np"])


def port_batch(case, step: int):
    return tbatch(case["cfg"], step, TRAIN_B, TRAIN_S)


def port_grads(case, **kw):
    grad_fn = make_grad_fn(case["cfg"], compute_dtype=torch.float32, **kw)
    return grad_fn(port_params(case), port_batch(case, 0))


def check_grads(case):
    loss, grads = port_grads(case)
    assert rel(loss, case["loss0"]) <= LOSS_REL, (case["arch"], float(loss),
                                                  case["loss0"])
    names = [n for n, _ in tree.flatten_with_names(port_params(case))]
    assert len(grads) == len(case["grads0"]) == len(names)
    for name, g, want in zip(names, grads, case["grads0"]):
        assert g.dtype == torch.float32
        close(g, want, f"{case['arch']} grad {name}", rel=GRAD_REL)


def check_train_trajectory(case):
    opt, step = make_trainer(case["cfg"], steps=TRAIN_STEPS)
    p = port_params(case)
    state = opt.init(p)
    for i, (want, want_norm) in enumerate(zip(case["losses"],
                                              case["norms"])):
        p, state, m = step(p, state, port_batch(case, i))
        bar = LOSS_REL if i == 0 else TRAJ_REL
        assert rel(m["loss"], want) <= bar, (case["arch"], i,
                                             float(m["loss"]), want)
        if i == 0:
            assert rel(m["grad_norm"], want_norm) <= LOSS_REL, \
                (case["arch"], float(m["grad_norm"]), want_norm)
    assert int(state["step"]) == TRAIN_STEPS
    assert state["step"].dtype == torch.int32
    assert all(t.is_leaf and not t.requires_grad for t in tree.leaves(p))


def check_remat_equal(case):
    l_on, g_on = port_grads(case, remat=True)
    l_off, g_off = port_grads(case, remat=False)
    assert float(l_on) == float(l_off)
    for a, b in zip(g_on, g_off):
        close(a, b, f"{case['arch']} remat", rel=LOSS_REL)


def check_accum(case):
    opt, step = make_trainer(case["cfg"], steps=TRAIN_STEPS, accum_steps=2)
    p = port_params(case)
    _, _, m = step(p, opt.init(p), port_batch(case, 0))
    loss, norm = case["accum"]
    assert rel(m["loss"], loss) <= LOSS_REL, (case["arch"],
                                              float(m["loss"]), loss)
    assert rel(m["grad_norm"], norm) <= LOSS_REL, (case["arch"],
                                                   float(m["grad_norm"]),
                                                   norm)
    # and the accumulated gradients equal the whole batch's
    _, g1 = port_grads(case)
    _, g2 = port_grads(case, accum_steps=2)
    for a, b in zip(g2, g1):
        close(a, b, f"{case['arch']} accum", rel=LOSS_REL)
