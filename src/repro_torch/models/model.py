"""Unified LM assembly for the assigned architecture pool — the port of
``repro.models.model``.

One parameter layout + three entry points per architecture:

  * ``forward``       — full-sequence logits (training / evaluation)
  * ``prefill``       — full-sequence forward that also builds the decode
                        cache and returns last-token logits
                        (``models/decode.py``)
  * ``decode_step``   — one new token against the cache (serving)

Layers are stacked along a leading L axis; a Python loop over the stack
takes the reference's ``lax.scan`` (``scan_layers`` is accepted and
changes nothing). ``remat`` takes the reference's ``jax.checkpoint`` of
each block: every layer of the forward, the encoder and the decoder runs
under ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
layer's input for the backward pass and recomputes the rest — but only
when grad is enabled and some parameter of the stack requires grad, so
serving (whose parameters require none) runs the plain loop. The
reference shards along a device mesh; the port has none, so every
``mesh`` argument must be None.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_index(v, i) for v in tree)
    return tree[i]


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def tree_unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each a tree of views. Under
    autograd one ``unbind`` a tensor stacks the layers' gradients once in
    the backward pass; indexing layer by layer (``tree_index``) would
    materialise a zero-filled gradient of the whole stacked tensor for
    every layer and add them up, 40 passes over 10 GB a step at
    granite-3-2b."""
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [tree_unbind(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layer_loop(layer_fn, x, stacked, n_layers: int, remat: bool = False):
    """``x`` through the ``n_layers`` layers of ``stacked``; with
    ``remat`` (and a backward pass to save for) each layer runs under
    ``torch.utils.checkpoint``."""
    remat = remat and torch.is_grad_enabled() and _needs_grad(stacked)
    for p in tree_unbind(stacked, n_layers):
        if remat:
            x = checkpoint(lambda x, p: layer_fn(x, p)[0], x, p,
                           use_reentrant=False)
        else:
            x, _ = layer_fn(x, p)
    return x


# -- initialization -----------------------------------------------------------

def _normal(gen: torch.Generator | None, shape, scale: float, dtype,
            device):
    if gen is None:                 # a shape walk: no values to draw
        return torch.empty(shape, dtype=dtype, device="meta")
    # scaled in place: a second float32 copy of the largest stacked
    # weight would add 2.7 GB to granite-3-2b's peak
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return t.mul_(scale).to(dtype=dtype, device=device)


def _device_of(gen: torch.Generator | None, device):
    if gen is None:
        if device is not None and torch.device(device).type != "meta":
            raise ValueError("parameters without a generator are shapes "
                             "only: device must be 'meta'")
        return torch.device("meta")
    return gen.device if device is None else device


def init_block_params(cfg: ModelConfig, gen: torch.Generator,
                      dtype=torch.float32, device=None) -> dict:
    """Stacked per-layer parameters (leading axis = n_layers), drawn from
    ``gen`` with the reference's shapes, dtypes and scales (``gen`` None:
    on the ``meta`` device, shapes and dtypes only)."""
    d, hd = cfg.d_model, cfg.head_dim_
    nl = cfg.n_layers
    device = _device_of(gen, device)

    def w(shape, scale=None):
        s = scale if scale is not None else (shape[-2] ** -0.5)
        return _normal(gen, (nl,) + shape, s, dtype, device)

    def ones(*shape):
        return torch.ones((nl,) + shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros((nl,) + shape, dtype=dtype, device=device)

    p: dict = {"attn_norm": ones(d), "mlp_norm": ones(d)}
    if cfg.family != "ssm":
        p["wq"] = w((d, cfg.n_heads * hd))
        p["wk"] = w((d, cfg.n_kv_heads * hd))
        p["wv"] = w((d, cfg.n_kv_heads * hd))
        p["wo"] = w((cfg.n_heads * hd, d))
        if cfg.qk_norm:
            p["q_norm"] = ones(hd)
            p["k_norm"] = ones(hd)
    if cfg.family in ("ssm", "hybrid"):
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        conv_dim = di + 2 * N
        p["ssm_in"] = w((d, 2 * di + 2 * N + H))
        p["conv_w"] = _normal(gen, (nl, cfg.conv_width, conv_dim), 0.2,
                              dtype, device)
        p["dt_bias"] = zeros(H)
        p["A_log"] = zeros(H)
        p["ssm_norm"] = ones(di)
        p["ssm_out"] = w((di, d))
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.d_ff
        p["router"] = w((d, e), scale=0.02)
        p["w1"] = w((e, d, f))
        p["w2"] = w((e, f, d), scale=f ** -0.5)
        if cfg.activation == "swiglu":
            p["w3"] = w((e, d, f))
    elif cfg.d_ff:
        p["w1"] = w((d, cfg.d_ff))
        p["w2"] = w((cfg.d_ff, d), scale=cfg.d_ff ** -0.5)
        if cfg.activation == "swiglu":
            p["w3"] = w((d, cfg.d_ff))
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random parameters in the reference's layout. ``gen`` draws them on
    its own device; they are placed on ``device`` (default: the
    generator's). The draws are not the reference's (JAX and torch draw
    differently): a test that compares the two packages converts the
    reference's parameters (``models/convert.py``) instead. With ``gen``
    None the tree is drawn on the ``meta`` device: the shapes and dtypes
    of the parameters with no storage (``launch/specs.params_specs``)."""
    d = cfg.d_model
    device = _device_of(gen, device)
    params = {
        "embed": _normal(gen, (cfg.padded_vocab, d), 0.02, dtype, device),
        "blocks": init_block_params(cfg, gen, dtype, device),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, cfg.padded_vocab), d ** -0.5,
                                    dtype, device)
    if cfg.enc_dec:
        enc_cfg = dataclasses.replace(
            cfg, family="dense", n_layers=cfg.enc_layers, enc_dec=False,
            n_kv_heads=cfg.n_heads)
        params["enc_blocks"] = init_block_params(enc_cfg, gen, dtype,
                                                 device)
        params["enc_norm"] = torch.ones((d,), dtype=dtype, device=device)
        params["enc_pos"] = _normal(gen, (cfg.enc_frames, d), 0.02, dtype,
                                    device)
        nl, hd = cfg.n_layers, cfg.head_dim_

        def wx(shape):
            return _normal(gen, (nl,) + shape, shape[-2] ** -0.5, dtype,
                           device)
        params["cross"] = {
            "norm": torch.ones((nl, d), dtype=dtype, device=device),
            "wq": wx((d, cfg.n_heads * hd)),
            "wk": wx((d, cfg.n_heads * hd)),
            "wv": wx((d, cfg.n_heads * hd)),
            "wo": wx((cfg.n_heads * hd, d)),
        }
        params["dec_pos"] = _normal(gen, (cfg.dec_positions, d), 0.02,
                                    dtype, device)
    return params


# -- attention sublayer -------------------------------------------------------

def _heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)       # (B,n,S,hd)


def _unheads(x):
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def attention_sublayer(cfg: ModelConfig, p, x, *, causal: bool,
                       positions, mesh=None):
    """Returns (out, (k, v)) — k/v in (B, Hkv, S, hd) post-RoPE layout."""
    L._no_mesh(mesh)
    hd = cfg.head_dim_
    cd = x.dtype

    def proj(w, n):
        return _heads(torch.matmul(x, w.to(cd)), n, hd)

    q = proj(p["wq"], cfg.n_heads)
    k = proj(p["wk"], cfg.n_kv_heads)
    v = proj(p["wv"], cfg.n_kv_heads)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"].to(cd), cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"].to(cd), cfg.norm_eps)
    if cfg.rope_fraction > 0:
        q = L.apply_rope(q, positions, fraction=cfg.rope_fraction,
                         theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, fraction=cfg.rope_fraction,
                         theta=cfg.rope_theta)
    if cfg.sliding_window and causal:
        o = L.sliding_window_attention(q, k, v, window=cfg.sliding_window)
    else:
        o = L.blockwise_attention(q, k, v, causal=causal)
    out = torch.matmul(_unheads(o), p["wo"].to(cd))
    return out, (k, v)


def _split_zxbcdt(cfg: ModelConfig, zxbcdt):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return torch.split(zxbcdt, [di, di, N, N, H], dim=-1)


def ssm_sublayer(cfg: ModelConfig, p, x, conv_state=None, ssm_state=None,
                 *, decode: bool = False, mesh=None):
    """Mamba2 mixer. x: (B, S, D) (S=1 when decoding)."""
    L._no_mesh(mesh)
    cd = x.dtype
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, p["ssm_in"].to(cd))
    z, xin, Bc, Cc, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    if decode:
        new_conv = torch.cat([conv_state[:, 1:], xbc.float()], dim=1)
        xbc_tap = torch.cat([conv_state.to(cd), xbc], dim=1)
        y = torch.zeros_like(xbc)
        for i in range(cfg.conv_width):
            y = y + xbc_tap[:, i:i + 1] * p["conv_w"][i].to(cd)
        xbc = F.silu(y)
        xin, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
        dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
        xh = xin[:, 0].reshape(-1, H, P)
        yh, new_state = ssm_lib.ssd_decode_step(
            ssm_state, xh, dtv, p["A_log"], Bc[:, 0], Cc[:, 0])
        y = yh.reshape(xh.shape[0], 1, di).to(cd)
        y = L.rms_norm(y * F.silu(z), p["ssm_norm"].to(cd), cfg.norm_eps)
        return torch.matmul(y, p["ssm_out"].to(cd)), new_conv, new_state
    xbc, _ = ssm_lib.causal_conv(xbc, p["conv_w"].to(cd))
    xbc = F.silu(xbc)
    xin, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    b, s = x.shape[:2]
    yh = ssm_lib.ssd_chunked(xin.reshape(b, s, H, P), dtv, p["A_log"],
                             Bc, Cc, chunk=cfg.ssm_chunk)
    y = yh.reshape(b, s, di)
    y = L.rms_norm(y * F.silu(z), p["ssm_norm"].to(cd), cfg.norm_eps)
    return torch.matmul(y, p["ssm_out"].to(cd)), None, None


def ffn_sublayer(cfg: ModelConfig, p, x, mesh=None):
    if cfg.n_experts:
        b, s, d = x.shape
        y, _ = moe_lib.moe_ffn(
            x.reshape(b * s, d),
            {k: p[k] for k in ("router", "w1", "w2", "w3") if k in p},
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            activation=cfg.activation, mesh=mesh)
        return y.reshape(b, s, d)
    L._no_mesh(mesh)
    return L.mlp(x, {k: p[k].to(x.dtype) for k in ("w1", "w2", "w3")
                     if k in p}, cfg.activation)


# -- full-sequence block ------------------------------------------------------

def make_block_fn(cfg: ModelConfig, *, causal: bool, mesh=None):
    """One block (layer) over a full sequence: ``block(x, p) -> (x,
    None)``, the layer loop's step."""
    L._no_mesh(mesh)

    def block(x, p):
        positions = torch.arange(x.shape[1], device=x.device)
        if cfg.family == "ssm":
            h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
            y, _, _ = ssm_sublayer(cfg, p, h)
            x = x + y
        elif cfg.hybrid_parallel:
            h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
            a, _ = attention_sublayer(cfg, p, h, causal=causal,
                                      positions=positions)
            s, _, _ = ssm_sublayer(cfg, p, h)
            x = x + 0.5 * (a + s)
            h = L.rms_norm(x, p["mlp_norm"].to(x.dtype), cfg.norm_eps)
            x = x + ffn_sublayer(cfg, p, h)
        else:
            h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
            a, _ = attention_sublayer(cfg, p, h, causal=causal,
                                      positions=positions)
            x = x + a
            h = L.rms_norm(x, p["mlp_norm"].to(x.dtype), cfg.norm_eps)
            x = x + ffn_sublayer(cfg, p, h)
        return x, None
    return block


def forward(cfg: ModelConfig, params, tokens, *, mesh=None,
            compute_dtype=torch.bfloat16, remat: bool = True,
            frames=None, scan_layers: bool = True):
    """Token ids (B, S) → logits (B, S, V). For enc-dec models ``frames``
    (B, enc_frames, D) are the stubbed modality-frontend embeddings."""
    L._no_mesh(mesh)
    if cfg.enc_dec:
        return _whisper_forward(cfg, params, tokens, frames, compute_dtype,
                                remat)
    x = params["embed"].to(compute_dtype)[tokens]
    x = _layer_loop(make_block_fn(cfg, causal=True), x, params["blocks"],
                    cfg.n_layers, remat)
    x = L.rms_norm(x, params["final_norm"].to(compute_dtype), cfg.norm_eps)
    return lm_logits(cfg, params, x, compute_dtype)


def lm_logits(cfg, params, x, compute_dtype, mesh=None):
    """Final projection (tied embedding or ``lm_head``); the padded vocab
    rows are masked to -1e30."""
    L._no_mesh(mesh)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(compute_dtype)
    logits = torch.matmul(x, head)
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=logits.device),
                             logits)
    return logits


# -- whisper (enc-dec) --------------------------------------------------------

def encode(cfg: ModelConfig, params, frames, compute_dtype,
           remat: bool = False):
    """The encoder stack over the stubbed frame embeddings."""
    enc = frames.to(compute_dtype) \
        + params["enc_pos"].to(compute_dtype)[None]
    enc_block = make_block_fn(
        dataclasses.replace(cfg, family="dense", enc_dec=False,
                            n_kv_heads=cfg.n_heads), causal=False)
    enc = _layer_loop(enc_block, enc, params["enc_blocks"], cfg.enc_layers,
                      remat)
    return L.rms_norm(enc, params["enc_norm"].to(compute_dtype),
                      cfg.norm_eps)


def _whisper_forward(cfg, params, tokens, frames, compute_dtype, remat):
    enc = encode(cfg, params, frames, compute_dtype, remat)
    S = tokens.shape[1]
    x = params["embed"].to(compute_dtype)[tokens] \
        + params["dec_pos"].to(compute_dtype)[None, :S]
    dec_cfg = dataclasses.replace(cfg, enc_dec=False,
                                  n_kv_heads=cfg.n_heads)
    hd = cfg.head_dim_

    def dec_block(x, ps):
        p, pc = ps
        positions = torch.arange(x.shape[1], device=x.device)
        h = L.rms_norm(x, p["attn_norm"].to(x.dtype), cfg.norm_eps)
        a, _ = attention_sublayer(dec_cfg, p, h, causal=True,
                                  positions=positions)
        x = x + a
        h = L.rms_norm(x, pc["norm"].to(x.dtype), cfg.norm_eps)
        cd = x.dtype
        q = _heads(torch.matmul(h, pc["wq"].to(cd)), cfg.n_heads, hd)
        k = _heads(torch.matmul(enc, pc["wk"].to(cd)), cfg.n_heads, hd)
        v = _heads(torch.matmul(enc, pc["wv"].to(cd)), cfg.n_heads, hd)
        o = L.blockwise_attention(q, k, v, causal=False)
        x = x + torch.matmul(_unheads(o), pc["wo"].to(cd))
        h = L.rms_norm(x, p["mlp_norm"].to(x.dtype), cfg.norm_eps)
        x = x + ffn_sublayer(dec_cfg, p, h)
        return x, None
    x = _layer_loop(dec_block, x, (params["blocks"], params["cross"]),
                    cfg.n_layers, remat)
    x = L.rms_norm(x, params["final_norm"].to(compute_dtype), cfg.norm_eps)
    return lm_logits(cfg, params, x, compute_dtype)
