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
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import decode as jdecode
from repro.models import model as jmodel

from repro_torch import configs as tconfigs
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_numpy

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
